"""Expert parallelism: the Switch / GShard mixture-of-experts FFN.

The counterpart of ``sparkdl_tpu/parallel/moe.py``: top-1 (Switch)
routing with capacity (tokens past ``capacity_factor · tokens / experts``
at an expert are dropped and pass through the residual as zeros), the
dispatch and combine written as the GShard one-hot einsums, experts held
as stacked parameters with a leading ``(num_experts, ...)`` axis
(``experts.wi`` / ``experts.wo``, flax's ``[in, out]`` kernel layout per
expert), and the Switch load-balancing loss. The products run as
``torch.einsum`` (cuBLAS on the card), as XLA lowers the reference's.

The aux loss: the reference sows it into the ``intermediates``
collection. Here the caller passes a dict, ``moe(x, intermediates=d)``,
and the module appends the loss to ``d["moe_aux_loss"]`` (a list, one
entry a call: what flax's ``sow`` keeps as a tuple);
:func:`moe_aux_loss` sums every entry of such a dict (nested dicts and
lists walked), the reference's reader.

On a mesh with an ``ep`` axis (``SwitchMoE(..., mesh=)``, placed by
:func:`moe_rules`) each rank holds and computes only its block of the
experts: the router, the routing and the aux loss are computed on every
rank alike, each rank dispatches the tokens of its own experts, and the
partial combines are summed over ``ep`` (``fsdp.reduce_out``). The token
and gate inputs of the dispatch enter through ``fsdp.copy_in``, so their
gradients are summed over ``ep`` and every rank's router gradient comes
out whole.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .fsdp import copy_in, reduce_out
from .sharding import P, path_str


class _Stacked(nn.Module):
    """One stacked Dense of the experts: ``kernel`` ``(E, in, out)``,
    ``bias`` ``(E, out)``."""

    def __init__(self, e: int, n_in: int, n_out: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(e, n_in, n_out,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(e, n_out, device=device))

    def forward(self, x, dtype):
        return torch.einsum("ecd,edf->ecf", x, self.kernel.to(dtype)) + \
            self.bias.to(dtype)[:, None, :]


class _Experts(nn.Module):
    def __init__(self, e: int, d_model: int, d_ff: int, device=None):
        super().__init__()
        self.wi = _Stacked(e, d_model, d_ff, device)
        self.wo = _Stacked(e, d_ff, d_model, device)


class SwitchMoE(nn.Module):
    """Top-1 routed MoE FFN: ``(B, T, D) → (B, T, D)``.

    ``d_model`` is the tokens' width (flax reads it from the input).
    Parameters are f32, the router runs in f32 and the experts compute in
    ``dtype`` (flax's ``param_dtype`` / ``dtype``): ``router`` an
    ``nn.Linear(d_model, num_experts)`` (``weight [E, D]``, bias),
    ``experts.wi.kernel (E, D, F)`` / ``bias (E, F)``, ``experts.wo.kernel
    (E, F, D)`` / ``bias (E, D)``. The expert activation is flax's
    ``nn.gelu`` (the tanh approximation). Weights are drawn from
    ``generator`` (default seed 0) as flax initialises them: kernels
    LeCun normal, N(0, 1/fan_in), biases zero.

    ``mesh``: a mesh with an ``ep_axis`` axis over which the experts
    split evenly; the module then holds this rank's block of them (fill
    it with :func:`load_flax_params` or ``parallel.fsdp.
    load_full_state_dict``-style slicing, or :func:`shard_moe`)."""

    def __init__(self, d_model: int, num_experts: int, d_ff: int,
                 capacity_factor: float = 1.25, dtype=torch.float32,
                 device=None, generator=None, mesh=None,
                 ep_axis: str = "ep"):
        super().__init__()
        from ..utils.platform import resolve_device
        device = resolve_device(device)
        self.num_experts, self.d_ff = num_experts, d_ff
        self.capacity_factor, self.dtype = capacity_factor, dtype
        self.group, self.ep, self.ep_rank = None, 1, 0
        if mesh is not None:
            names = list(mesh.mesh_dim_names)
            if ep_axis not in names:
                raise ValueError(f"axis {ep_axis!r} is not an axis of the "
                                 f"mesh {tuple(names)}")
            self.ep = mesh.size(names.index(ep_axis))
            if num_experts % self.ep:
                raise ValueError(f"{num_experts} experts do not split "
                                 f"evenly over {ep_axis}={self.ep}")
            self.group = mesh.get_group(ep_axis)
            self.ep_rank = mesh.get_local_rank(ep_axis)
        self.router = nn.Linear(d_model, num_experts, device=device)
        self.experts = _Experts(num_experts // self.ep, d_model, d_ff,
                                device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        dev = self.router.weight.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                fan_in = p.shape[-1] if name == "router.weight" \
                    else p.shape[-2]
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=dev) / math.sqrt(fan_in))

    def capacity(self, n_tokens: int) -> int:
        return max(1, int(self.capacity_factor * n_tokens
                          / self.num_experts))

    def forward(self, x, intermediates: dict | None = None):
        b, t, d = x.shape
        e, n = self.num_experts, b * t
        cap = self.capacity(n)
        xf = x.reshape(n, d)
        logits = F.linear(xf.float(), self.router.weight.float(),
                          self.router.bias.float())              # (N, E)
        probs = torch.softmax(logits, dim=-1)
        expert_idx = torch.argmax(probs, dim=-1)                 # (N,)
        gate = probs.max(dim=-1).values                          # (N,)
        onehot = F.one_hot(expert_idx, e).float()                # (N, E)
        # each token's place in its expert's queue (0-based; -1 where the
        # token is not the expert's, which selects no slot)
        pos = (torch.cumsum(onehot, dim=0) * onehot - 1.0).long()
        dispatch = torch.where((pos >= 0) & (pos < cap), onehot,
                               torch.zeros_like(onehot))
        slot = (pos[..., None] == torch.arange(
            cap, device=x.device)).float()                       # (N, E, C)
        dispatch3 = dispatch[..., None] * slot
        el = e // self.ep
        if self.group is not None:
            # this rank's experts; token and gate enter the ep region
            lo = self.ep_rank * el
            dispatch3 = dispatch3[:, lo:lo + el]
            xin = copy_in(xf.float(), self.group)
            g = copy_in(gate, self.group)
        else:
            xin, g = xf.float(), gate
        expert_in = torch.einsum("nec,nd->ecd", dispatch3,
                                 xin).to(self.dtype)             # (E, C, D)
        h = F.gelu(self.experts.wi(expert_in, self.dtype),
                   approximate="tanh")
        expert_out = self.experts.wo(h, self.dtype)              # (E, C, D)
        combine3 = dispatch3 * g[:, None, None]
        out = torch.einsum("nec,ecd->nd", combine3, expert_out.float())
        if self.group is not None:
            out = reduce_out(out, self.group)
        if intermediates is not None:
            # Switch load balancing: E · Σ_e (token share_e · mean prob_e)
            aux = e * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))
            intermediates.setdefault("moe_aux_loss", []).append(aux)
        return out.reshape(b, t, d).to(x.dtype)


def moe_rules(base_rules: Callable | None = None,
              ep_axis: str = "ep") -> Callable:
    """Sharding rules: the expert-stacked parameters (a path with an
    ``experts`` segment, matched exactly, not as a substring: a layer
    named ``experts_gate`` is not expert-sharded) get ``P(ep_axis)`` on
    their leading axis; everything else falls through to ``base_rules``
    (or replicated)."""
    def rules(path, leaf) -> P:
        if "experts" in path_str(path).split("/"):
            return P(ep_axis, *([None] * (leaf.ndim - 1)))
        if base_rules is not None:
            return base_rules(path, leaf)
        return P()

    return rules


def moe_aux_loss(intermediates) -> torch.Tensor:
    """Sum every ``moe_aux_loss`` entry of an intermediates dict (nested
    dicts and lists walked; a key or path segment ``moe_aux_loss``)."""
    total = torch.zeros(())

    def walk(node, hit: bool):
        nonlocal total
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, hit or "moe_aux_loss" in str(k).split("/"))
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, hit)
        elif hit and torch.is_tensor(node):
            total = total.to(node.device) + node.sum()

    walk(intermediates, False)
    return total


@torch.no_grad()
def load_flax_params(moe: SwitchMoE, params) -> SwitchMoE:
    """Fill ``moe`` from the reference's parameter tree (``router/kernel
    (D, E)``, ``router/bias``, ``experts/wi/kernel (E, D, F)``, ...;
    numpy or tensors); a module on an ``ep`` mesh takes its block of the
    experts. Returns it."""
    import numpy as np

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32))

    moe.router.weight.copy_(t(params["router"]["kernel"]).T)
    moe.router.bias.copy_(t(params["router"]["bias"]))
    el = moe.num_experts // moe.ep
    lo = moe.ep_rank * el
    for w in ("wi", "wo"):
        st = getattr(moe.experts, w)
        st.kernel.copy_(t(params["experts"][w]["kernel"])[lo:lo + el])
        st.bias.copy_(t(params["experts"][w]["bias"])[lo:lo + el])
    return moe


@torch.no_grad()
def shard_moe(moe: SwitchMoE, mesh, ep_axis: str = "ep") -> SwitchMoE:
    """This rank's expert-parallel module of the global ``moe`` on ``mesh``
    (every rank calls it with the same module): the global tensors placed
    by ``shard_params`` under :func:`moe_rules`, each rank's local shards
    loaded into a module built with ``mesh=``."""
    from .sharding import shard_params

    local = SwitchMoE(moe.router.in_features, moe.num_experts, moe.d_ff,
                      moe.capacity_factor, moe.dtype,
                      device=moe.router.weight.device, mesh=mesh,
                      ep_axis=ep_axis)
    placed = shard_params(dict(moe.state_dict()), mesh,
                          moe_rules(ep_axis=ep_axis))
    local.load_state_dict({k: v.to_local() for k, v in placed.items()})
    return local
