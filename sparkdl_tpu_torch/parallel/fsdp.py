"""Sharded parameters (ZeRO-3 / FSDP over a mesh) and the autograd-correct
collectives of the sharded train step.

The reference gets both from GSPMD: parameters placed under
``transformer_tp_rules(data_axis=...)`` keep only their shard on each
device, and XLA inserts the all-gather before a use and the
reduce-scatter of the gradient after it. The port writes them out, one
process a device, over a named ``DeviceMesh`` (``core.runtime.
make_mesh``):

- :func:`shard_module` places a module's parameters by the rules: each
  rank keeps the local shard ``DTensor`` placement gives it
  (``sharding.shard_params``), as a plain ``nn.Parameter``. A parameter
  sharded on an axis of ``gather_axes`` gets a parametrization
  (``torch.nn.utils.parametrize``) that all-gathers the shard over that
  axis at every read of the attribute, whose backward reduce-scatters
  (sums) the gradient back to the shard. Axes left out of
  ``gather_axes`` stay split: the module itself computes with its local
  part there (Llama's Megatron split on ``model``,
  ``models.llama.shard_model``).
- :func:`linear` is the product of such a gathered weight that keeps
  only the shard for its backward and gathers the weight again there
  (FSDP's reshard after forward). A module whose products of sharded
  weights go through it (``models.llama``'s projections and
  ``lm_head``) holds each gathered weight only while its product runs,
  forward or backward: between uses, a rank holds its shards alone. A
  plain ``F.linear`` of the gathered weight would keep it for the
  backward, so every layer's whole weights would stay resident from the
  forward until the backward.
- :func:`copy_in` / :func:`reduce_out` / :func:`gather_block` /
  :func:`gather_dim` are Megatron's conjugate pairs as autograd
  Functions: the copy into a column-parallel region is the identity
  forward and an all-reduce backward; the row-parallel sum is an
  all-reduce forward and the identity backward (``torch.distributed.nn.
  functional.all_reduce`` all-reduces both ways, which scales gradients
  by the group's size); :func:`gather_block` is the gather whose loss
  follows on every rank alike, its backward keeping the rank's block;
  :func:`gather_dim`'s backward reduce-scatters. :func:`all_gather` is
  the one all-gather under all of them (and under ``parallel.
  ring_attention`` and ``core.runtime.BatchRunner``'s outputs).
- :func:`full_state_dict` gathers a placed module back to its global
  tensors under their global names, and :func:`load_full_state_dict`
  lays global tensors out again at the module's placement (the
  checkpoint's resharding); their optimizer-state twins do the same for
  state tensors shaped like their parameter's shard.

Every collective these functions make adds one to :data:`COLLECTIVES`
under its kind, the count the sharded step's records read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .sharding import P, placements

#: collectives this module made, by kind
COLLECTIVES: dict = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0,
                     "send_recv": 0}


def count(kind: str) -> None:
    COLLECTIVES[kind] += 1


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


# ---------------------------------------------------------------------------
# Autograd-correct collectives
# ---------------------------------------------------------------------------

def all_gather(x, dim: int, group, n: int):
    """The ``n`` ranks' blocks of ``x`` joined along ``dim`` in rank order,
    contiguous (no autograd): gathered into ``[n, *x.shape]`` (no copy of
    ``x`` in its own layout), then the rank axis folded into ``dim`` (one
    copy of whole blocks, none when ``dim`` is 0)."""
    x = x.contiguous()
    dim %= x.dim()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    count("all_gather")
    if dim == 0:
        return out
    shape = list(x.shape)
    shape[dim] *= n
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


def _reduce_scatter(g, dim: int, group, n: int):
    """Sum ``g`` over the group and keep the rank's block of ``dim``."""
    shape = list(g.shape)
    shape[dim] //= n
    blocks = g.reshape(shape[:dim] + [n] + shape[dim:]).movedim(dim, 0)
    out = torch.empty(shape, dtype=g.dtype, device=g.device)
    blocks = blocks.contiguous()
    dist.reduce_scatter_tensor(out, blocks.view((-1,) + tuple(shape[1:])),
                               group=group)
    count("reduce_scatter")
    return out


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.n), None, None, None


def gather_dim(x, dim: int, group, n: int):
    """All-gather ``x`` along ``dim`` over ``group`` (``n`` ranks); the
    backward reduce-scatters (sums) the gradient to the rank's block."""
    return _GatherDim.apply(x, dim, group, n)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        count("all_reduce")
        return g, None


def copy_in(x, group):
    """Enter a column-parallel region: ``x`` itself forward, its gradient
    summed over ``group`` backward (Megatron's f). ``x`` as it is without
    a group or with gradients off."""
    if group is None or not torch.is_grad_enabled():
        return x
    return _CopyIn.apply(x, group)


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        count("all_reduce")
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_out(x, group):
    """Leave a row-parallel region: the partial sums of ``x`` summed over
    ``group`` forward, the gradient as it is backward (Megatron's g)."""
    return _ReduceOut.apply(x, group)


class _GatherBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim = dim % x.dim()
        ctx.rank, ctx.w = dist.get_rank(group), x.shape[ctx.dim]
        return all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.w, ctx.w).contiguous(),
                None, None, None)


def gather_block(x, dim: int, group, n: int):
    """The ``n`` ranks' blocks of ``x`` joined along ``dim`` in rank order.
    What follows is the same on every rank, so the gradient of the block
    is the rank's block of the (replicated) gradient: the backward keeps
    it and makes no collective."""
    return _GatherBlock.apply(x, dim, group, n)


def _gathered(shard, gathers):
    """A sharded parameter's whole weight, no autograd: ``shard``
    all-gathered over each ``(dim, group, n)`` in turn."""
    w = shard.detach()
    for dim, group, n in gathers:
        w = all_gather(w, dim, group, n)
    return w


class _RegatheredLinear(torch.autograd.Function):
    """``F.linear(x, w.to(dtype))`` of a gathered weight ``w`` that keeps
    the shard for its backward, not ``w``, and gathers ``w`` again there.
    The backward's products are autograd's own for ``F.linear`` (the
    input's gradient ``g @ w``, the weight's ``g^T @ x``, on the same
    layouts), so the gradients are bitwise those of the plain product."""

    @staticmethod
    def forward(ctx, x, w, dtype):
        ctx.shard, ctx.gathers = w.sparkdl_shard
        ctx.dtype, ctx.w_dtype = dtype, w.dtype
        ctx.save_for_backward(x)
        return F.linear(x, w.to(dtype))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        w = _gathered(ctx.shard, ctx.gathers).to(ctx.dtype)
        g2 = g.reshape(-1, g.shape[-1])
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = g2.mm(w).view(x.shape)
        if ctx.needs_input_grad[1]:
            gw = g2.t().mm(x.reshape(-1, x.shape[-1])).to(ctx.w_dtype)
        return gx, gw, None


def linear(x, w, dtype=None):
    """``F.linear(x, w.to(dtype))`` (``dtype`` default ``w``'s). When ``w``
    is a sharded parameter's gathered weight (the read of a parameter
    :func:`shard_module` placed) and a gradient is taken, the product
    keeps only the shard for its backward and gathers the weight again
    there, so the gathered weight is freed once the forward's product is
    done."""
    dtype = w.dtype if dtype is None else dtype
    if getattr(w, "sparkdl_shard", None) is None or \
            not torch.is_grad_enabled():
        return F.linear(x, w.to(dtype))
    return _RegatheredLinear.apply(x, w, dtype)


# ---------------------------------------------------------------------------
# Placed modules
# ---------------------------------------------------------------------------

def _axis_dims(spec: P) -> list:
    """``(dim, axis)`` of every mesh axis ``spec`` names."""
    out = []
    for dim, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                out.append((dim, a))
    return out


class _Gather(nn.Module):
    """The parametrization of a sharded parameter: its shard all-gathered
    over each ``(dim, group, n)`` at every read. The result carries the
    shard and the gathers (``sparkdl_shard``), which :func:`linear`
    gathers again from in the backward."""

    def __init__(self, gathers: list):
        super().__init__()
        self.gathers = gathers

    def forward(self, shard):
        x = shard
        for dim, group, n in self.gathers:
            x = gather_dim(x, dim, group, n)
        x.sparkdl_shard = (shard, self.gathers)
        return x


@dataclasses.dataclass
class Placement:
    """Where a placed module's parameters live: the mesh, each global
    name's spec and global shape, and the parameter that holds the rank's
    shard (``locals``)."""
    mesh: Any
    specs: dict
    shapes: dict
    locals: dict
    gather_axes: tuple

    def mesh_shape(self) -> dict:
        return {str(n): int(self.mesh.size(i))
                for i, n in enumerate(self.mesh.mesh_dim_names)}

    def name_of(self) -> dict:
        """``id(parameter)`` → global name."""
        return {id(p): n for n, p in self.locals.items()}


def placement(module: nn.Module) -> Placement | None:
    """The :class:`Placement` of a module :func:`shard_module` placed, or
    None."""
    return getattr(module, "sparkdl_placement", None)


def _owner(module: nn.Module, name: str) -> tuple:
    *path, attr = name.split(".")
    m = module
    for p in path:
        m = getattr(m, p)
    return m, attr


def local_slice(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The rank's block of the global tensor ``t`` under ``spec`` on
    ``mesh`` (the block ``distribute_tensor`` gives it; no collective)."""
    names = list(mesh.mesh_dim_names)
    for dim, ax in _axis_dims(spec):
        n = mesh.size(names.index(ax))
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"evenly over {ax!r} ({n})")
        w = t.shape[dim] // n
        t = t.narrow(dim, mesh.get_local_rank(ax) * w, w)
    return t


@torch.no_grad()
def shard_module(module: nn.Module, mesh, rules: Callable,
                 state: dict | None = None,
                 gather_axes=None) -> nn.Module:
    """Place ``module``'s parameters on ``mesh`` by ``rules``, IN PLACE, and
    return it: each parameter becomes the rank's shard of the global
    tensor ``state[name]`` (default: the module's own ``state_dict()``),
    the shard ``sharding.shard_params`` gives it (rank 0's copy). A
    parameter sharded on an axis of ``gather_axes`` (default: every axis
    of its spec) is all-gathered over it at every read and its gradient
    reduce-scattered back (the module's ``named_parameters`` then list it
    as ``<name>.parametrizations.<attr>.original``); the module's products
    of it go through :func:`linear`, which keeps only the shard for the
    backward, or the gathered weight lives until then. On the other axes the
    module must hold its local part already (its parameter's shape is the
    shard's with the gathered dims whole). Buffers stay as they are. Every
    rank calls it with the same ``state``. Build the optimizer after it."""
    from torch.nn.utils import parametrize

    from .sharding import shard_params

    params = dict(module.named_parameters())
    state = dict(module.state_dict()) if state is None else dict(state)
    state = {k: v for k, v in state.items() if k in params}
    if set(state) != set(params):
        raise ValueError(f"the state does not name the module's parameters: "
                         f"missing {sorted(set(params) - set(state))[:4]}")
    names = list(mesh.mesh_dim_names)
    gather_axes = tuple(names if gather_axes is None else gather_axes)
    placed = shard_params(state, mesh, rules)
    specs, shapes, locals_ = {}, {}, {}
    for name, dt in placed.items():
        glob = state[name]
        spec = rules((name,), glob)
        local = dt.to_local()
        owner, attr = _owner(module, name)
        p = params[name]
        gathers, want = [], list(local.shape)
        for dim, ax in _axis_dims(spec):
            if ax in gather_axes:
                n = mesh.size(names.index(ax))
                gathers.append((dim, mesh.get_group(ax), n))
                want[dim] *= n
        if tuple(want) != tuple(p.shape):
            raise ValueError(f"{name}: the module holds {tuple(p.shape)}, "
                             f"the rules' shard gathered over "
                             f"{gather_axes} is {tuple(want)}")
        if gathers:
            shard = nn.Parameter(local.detach().clone().to(p.dtype),
                                 requires_grad=p.requires_grad)
            owner._parameters[attr] = shard
            parametrize.register_parametrization(owner, attr,
                                                 _Gather(gathers),
                                                 unsafe=True)
        else:
            p.copy_(local)
            shard = p
        specs[name], shapes[name] = spec, tuple(glob.shape)
        locals_[name] = shard
    del placed
    module.sparkdl_placement = Placement(mesh, specs, shapes, locals_,
                                         gather_axes)
    return module


def _full(local: torch.Tensor, spec: P, mesh, shape) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if not _axis_dims(spec):
        return local.detach()
    for _ in _axis_dims(spec):
        count("all_gather")
    return DTensor.from_local(local.detach(), mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride()).full_tensor()


def _sunk(out: dict, key, t, sink) -> None:
    """``out[key] = sink(t)`` (``t`` itself without a sink); a None from
    the sink leaves the key out."""
    t = t if sink is None else sink(t)
    if t is not None:
        out[key] = t


@torch.no_grad()
def full_state_dict(module: nn.Module, sink: Callable | None = None) -> dict:
    """The module's ``state_dict`` under its global names with every
    sharded parameter gathered to its global tensor (a collective: every
    rank of the mesh calls it); the plain ``state_dict`` of a module
    :func:`shard_module` did not place.

    ``sink`` takes each tensor as soon as it is gathered, before the next
    one is, and its result goes into the dict (None: left out). So a
    sink that copies to the host (or drops the tensor) keeps one gathered
    leaf at a time on the device: the checkpoint's rank 0 passes a host
    copy, the other ranks take part in the collectives and drop each
    result."""
    pl = placement(module)
    out = {}
    if pl is None:
        for name, t in module.state_dict().items():
            _sunk(out, name, t, sink)
        return out
    for name, local in pl.locals.items():
        _sunk(out, name, _full(local, pl.specs[name], pl.mesh,
                               pl.shapes[name]), sink)
    for name, b in module.named_buffers():
        _sunk(out, name, b.detach(), sink)
    return out


def global_specs(module: nn.Module) -> dict:
    """Global name → ``(shape, dtype)`` of the module's state, sharded
    parameters at their global shape."""
    pl = placement(module)
    if pl is None:
        return {k: (tuple(v.shape), v.dtype)
                for k, v in module.state_dict().items()}
    out = {n: (pl.shapes[n], p.dtype) for n, p in pl.locals.items()}
    out.update({n: (tuple(b.shape), b.dtype)
                for n, b in module.named_buffers()})
    return out


@torch.no_grad()
def load_full_state_dict(module: nn.Module, state: dict,
                         rules: Callable | None = None) -> nn.Module:
    """Copy global tensors into the module: each sharded parameter gets the
    rank's block of ``state[name]`` at the module's placement (no
    collective). ``rules``, when given, must give the placement's specs
    (``divisible_rules`` at the placement's mesh is applied to them):
    ``ValueError`` naming the first leaf where they differ. A module
    :func:`shard_module` did not place gets the tensors as they are."""
    pl = placement(module)
    if pl is None:
        module.load_state_dict(state, strict=False)
        return module
    if rules is not None:
        from .sharding import divisible_rules
        rules = divisible_rules(rules, pl.mesh)
        for name, spec in pl.specs.items():
            want = rules((name,), torch.empty(pl.shapes[name],
                                              device="meta"))
            if tuple(want) != tuple(spec):
                raise ValueError(
                    f"{name}: the rules give {want} at the mesh "
                    f"{pl.mesh_shape()}, the module is placed {spec}: "
                    f"place the template with the rules it restores under")
    for name, local in pl.locals.items():
        local.copy_(local_slice(state[name], pl.specs[name], pl.mesh))
    bufs = dict(module.named_buffers())
    for name, b in bufs.items():
        if name in state:
            b.copy_(state[name])
    return module


def _param_names(optimizer, module) -> list:
    """The global name of each optimizer parameter, in the state_dict's
    index order (None for one the placement does not hold)."""
    pl = placement(module)
    names = pl.name_of() if pl is not None else {}
    return [names.get(id(p)) for g in optimizer.param_groups
            for p in g["params"]]


@torch.no_grad()
def full_optimizer_state(optimizer, module,
                         sink: Callable | None = None) -> dict:
    """``optimizer.state_dict()`` with every state tensor shaped like its
    parameter's shard gathered to the global shape (a collective);
    ``sink`` as :func:`full_state_dict`'s, over every state tensor."""
    sd = optimizer.state_dict()
    pl = placement(module)
    names = _param_names(optimizer, module) if pl is not None else None
    state = {}
    for i, st in sd["state"].items():
        name = names[i] if names is not None else None
        out = {}
        for k, v in st.items():
            if not torch.is_tensor(v):
                out[k] = v
                continue
            if name is not None and v.dim() > 0 and \
                    tuple(v.shape) == tuple(pl.locals[name].shape):
                v = _full(v, pl.specs[name], pl.mesh, pl.shapes[name])
            _sunk(out, k, v, sink)
        state[i] = out
    return {"state": state, "param_groups": sd["param_groups"]}


def local_optimizer_state(sd: dict, optimizer, module) -> dict:
    """The inverse of :func:`full_optimizer_state` at the module's current
    placement: global-shaped state tensors cut to the rank's blocks."""
    pl = placement(module)
    if pl is None:
        return sd
    names = _param_names(optimizer, module)
    state = {}
    for i, st in sd["state"].items():
        name = names[int(i)]
        out = dict(st)
        if name is not None:
            for k, v in st.items():
                if torch.is_tensor(v) and v.dim() > 0 and \
                        tuple(v.shape) == tuple(pl.shapes[name]):
                    out[k] = local_slice(v, pl.specs[name],
                                         pl.mesh).contiguous()
        state[i] = out
    return {"state": state, "param_groups": sd["param_groups"]}
