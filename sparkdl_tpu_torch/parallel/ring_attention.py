"""Sequence parallelism of the port: ring attention and Ulysses over a
named ``DeviceMesh``, and the single-device reference attention.

The counterpart of ``sparkdl_tpu/parallel/ring_attention.py``. There the
bodies run under ``shard_map`` and XLA differentiates through
``ppermute`` / ``all_to_all``; here each process of a
``torch.distributed`` gang runs its own block, the exchanges are
``torch.distributed`` calls on the mesh axis's subgroup, and the
gradients are written out (``torch.autograd.Function``):

- **Ring attention** (:func:`ring_attention`): the sequence is split over
  the ``axis`` ranks; K/V blocks hop one rank a step (one
  ``batch_isend_irecv`` pair a hop, the send and the receive posted
  together and overlapped with the hop's products) while each rank keeps
  an f32 streaming softmax of its queries over every block, with causal
  masking from global positions. The backward recomputes each hop and
  carries the dK/dV accumulators around the ring with their K/V block;
  one more hop lands each on the rank that owns it.
- **Ulysses** (:func:`ulysses_attention`): ``all_to_all_single`` swaps
  the sequence split for a head split, ``local_attn`` runs over the full
  sequence of the local heads, and the inverse exchange swaps back; each
  exchange's gradient is the other exchange.

Inputs are ``[B, H, S, D]``. A ``DTensor`` on ``mesh`` runs on its local
block laid out ``Shard(0)`` / ``Shard(1)`` / ``Shard(2)`` on
``batch_axis`` / ``head_axis`` / ``axis`` (redistributed there first if
it is laid out otherwise) and comes back as a ``DTensor`` of that layout.
A plain tensor is the global tensor, the same on every rank: each rank
takes its block and the output is gathered back, so every rank holds the
global output (and, under autograd, the global gradients). That is what
lets a model call ``attn_fn(q, k, v, causal=True)`` unchanged.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from . import fsdp

NEG_INF = -1e30  # large-but-finite: -inf breaks the streaming-softmax max


def dense_attention(q, k, v, causal: bool = False, kv_mask=None):
    """Reference single-device attention. ``[B, H, S, D]`` layout.

    ``kv_mask`` (``[B, S]`` 0/1) follows the flash kernel's contract
    exactly, including the edge the streaming kernel gets for free: a row
    whose mask is ALL zero outputs zeros, not the uniform mean(v) that
    finite NEG_INF scores would give softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        S = q.shape[2]
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = s.masked_fill(~mask, NEG_INF)
    if kv_mask is not None:
        valid = kv_mask.to(torch.bool)
        s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s.float(), dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    if kv_mask is not None:
        o = o * valid.any(-1).to(o.dtype)[:, None, None, None]
    return o


# ---------------------------------------------------------------------------
# Mesh axes
# ---------------------------------------------------------------------------

class _Axis:
    """One named axis of a ``DeviceMesh`` as this rank sees it: its
    subgroup, extent, this rank's index along it, and the global ranks of
    the next and previous ranks around it."""

    def __init__(self, mesh, name: str):
        names = mesh.mesh_dim_names or ()
        if name not in names:
            raise ValueError(f"mesh has no axis {name!r} (axes {names})")
        dim = names.index(name)
        self.name = name
        self.size = int(mesh.size(dim))
        self.index = int(mesh.get_local_rank(dim))
        self.group = mesh.get_group(dim)
        self.next = dist.get_global_rank(self.group,
                                         (self.index + 1) % self.size)
        self.prev = dist.get_global_rank(self.group,
                                         (self.index - 1) % self.size)

    def post_shift(self, *tensors) -> tuple:
        """Send each tensor to the next rank and receive its counterpart
        from the previous one, all posted together (one
        ``batch_isend_irecv``); returns ``(requests, received)``."""
        recv = [torch.empty_like(t) for t in tensors]
        ops = []
        for tag, (t, r) in enumerate(zip(tensors, recv)):
            ops.append(dist.P2POp(dist.isend, t, self.next, self.group,
                                  tag))
            ops.append(dist.P2POp(dist.irecv, r, self.prev, self.group,
                                  tag))
        return dist.batch_isend_irecv(ops), recv

    def shift(self, *tensors) -> list:
        reqs, recv = self.post_shift(*tensors)
        for r in reqs:
            r.wait()
        return recv

    def all_gather(self, x, dim: int):
        """The blocks of every rank of the axis, concatenated along
        ``dim`` in the axis's order."""
        return fsdp.all_gather(x, dim, self.group, self.size)

    def block(self, x, dim: int):
        """This rank's block of ``x`` along ``dim``."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)


def _layout(mesh, axis, batch_axis, head_axis) -> list:
    """``[(tensor dim, _Axis)]`` for the named axes: batch on dim 0, heads
    on dim 1, the sequence on dim 2 (always last)."""
    named = [(d, n) for d, n in ((0, batch_axis), (1, head_axis), (2, axis))
             if n is not None]
    names = [n for _, n in named]
    if len(set(names)) != len(names):
        raise ValueError(f"one mesh axis named twice: {names}")
    return [(d, _Axis(mesh, n)) for d, n in named]


def _check_divisible(shape, layout) -> None:
    for d, ax in layout:
        if shape[d] % ax.size:
            raise ValueError(
                f"dim {d} of size {shape[d]} is not divisible by "
                f"{ax.name}={ax.size}")


def _placements(mesh, layout) -> list:
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, ax in layout:
        out[mesh.mesh_dim_names.index(ax.name)] = Shard(d)
    return out


class _Scatter(torch.autograd.Function):
    """Global tensors, the same on every rank → this rank's blocks. The
    gradient of a block is gathered back, so every rank holds the global
    gradient."""

    @staticmethod
    def forward(ctx, layout, *xs):
        ctx.layout = layout
        out = []
        for x in xs:
            for d, ax in layout:
                x = ax.block(x, d)
            out.append(x.contiguous())
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g in grads:
            for d, ax in reversed(ctx.layout):
                g = ax.all_gather(g, d)
            out.append(g)
        return (None, *out)


def _run(body, q, k, v, mesh, layout):
    """Run ``body(q, k, v)`` on this rank's blocks (module docstring's
    input and output contract)."""
    from torch.distributed.tensor import DTensor

    _check_divisible(q.shape, layout)
    if isinstance(q, DTensor):
        placements = _placements(mesh, layout)
        local = [x.redistribute(mesh, placements).to_local()
                 for x in (q, k, v)]
        o = body(*local)
        return DTensor.from_local(o, mesh, placements, shape=q.shape,
                                  stride=q.stride())
    if any(ax.size > 1 for _, ax in layout):
        q, k, v = _Scatter.apply(layout, q, k, v)
        # the global output on every rank: the loss that follows is the
        # same on every rank, so a block's gradient is the block of the
        # (replicated) global gradient
        o = body(q, k, v)
        for d, ax in reversed(layout):
            o = fsdp.gather_block(o, d, ax.group, ax.size)
        return o
    return body(q, k, v)


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------

def _ring_forward(q, k, v, ax: _Axis, causal: bool):
    """The reference's ``_ring_shard``: the local block first, then
    ``W − 1`` hops, each block's products overlapped with the next hop.
    Returns the f32 output and the row log-sum-exp."""
    B, H, T, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    o = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    diag = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    kv = torch.stack([k, v])
    for i in range(ax.size):
        # the block held at hop i came from rank (index − i) mod W
        src = (ax.index - i) % ax.size
        pending = ax.post_shift(kv) if i < ax.size - 1 else None
        if not (causal and src > ax.index):  # a later block: all masked
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kv[0].float()) * scale
            if causal and src == ax.index:
                s = s.masked_fill(~diag, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, kv[1].float())
            m = m_new
        if pending is not None:
            reqs, (kv,) = pending
            for r in reqs:
                r.wait()
    return o / l[..., None], m + torch.log(l)


def _ring_backward(q, k, v, o, lse, do, ax: _Axis, causal: bool):
    """Each hop's probabilities again from the saved log-sum-exp; dK/dV of
    a block accumulate as the block travels and return to its owner on
    one more hop (the block held after the last hop is the next rank's)."""
    T, D = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(D)
    qf, dof = q.float(), do.float()
    delta = (dof * o).sum(-1)
    dq = torch.zeros_like(qf)
    diag = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    kv = torch.stack([k, v])
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    for i in range(ax.size):
        src = (ax.index - i) % ax.size
        if not (causal and src > ax.index):
            kb, vb = kv[0].float(), kv[1].float()
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
            if causal and src == ax.index:
                s = s.masked_fill(~diag, NEG_INF)
            p = torch.exp(s - lse[..., None])
            dkv[1] += torch.einsum("bhqk,bhqd->bhkd", p, dof)
            ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vb)
                      - delta[..., None])
            dq += torch.einsum("bhqk,bhkd->bhqd", ds, kb) * scale
            dkv[0] += torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
        if i < ax.size - 1:
            kv, dkv = ax.shift(kv, dkv)
    if ax.size > 1:
        (dkv,) = ax.shift(dkv)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, ax, causal):
        o, lse = _ring_forward(q, k, v, ax, causal)
        ctx.ax, ctx.causal = ax, causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, o, lse, do, ctx.ax,
                                    ctx.causal)
        return dq, dk, dv, None, None


def _ring_shard(q, k, v, *, ax: _Axis, causal: bool):
    return _RingAttention.apply(q, k, v, ax, causal)


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = False,
                   batch_axis: str | None = None,
                   head_axis: str | None = None):
    """Sequence-parallel attention over mesh axis ``axis``.

    ``q``, ``k``, ``v`` ``[B, H, S, D]``: ``DTensor``s on ``mesh`` or the
    global tensors (module docstring); the output has the same form.
    ``batch_axis`` / ``head_axis`` name mesh axes the batch / head dims
    are split over — the DP×TP×SP composition on one 3-D mesh. The ring
    body is independent across B and H, so these are layout only. Each
    named axis must divide its dim (``ValueError``)."""
    layout = _layout(mesh, axis, batch_axis, head_axis)
    body = functools.partial(_ring_shard, ax=layout[-1][1], causal=causal)
    return _run(body, q, k, v, mesh, layout)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

def _seq_to_heads(x, ax: _Axis):
    """``[B, H, S/n, D]`` → ``[B, H/n, S, D]``: head group j goes to rank
    j, and the sequence blocks come back in rank order."""
    B, H, T, D = x.shape
    n = ax.size
    send = x.reshape(B, n, H // n, T, D).permute(1, 0, 2, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ax.group)
    return recv.permute(1, 2, 0, 3, 4).reshape(B, H // n, n * T, D)


def _heads_to_seq(y, ax: _Axis):
    """The inverse: ``[B, H/n, S, D]`` → ``[B, H, S/n, D]``."""
    B, h, S, D = y.shape
    n = ax.size
    send = y.reshape(B, h, n, S // n, D).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ax.group)
    return recv.permute(1, 0, 2, 3, 4).reshape(B, n * h, S // n, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _seq_to_heads(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g.contiguous(), ctx.ax), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, ax):
        ctx.ax = ax
        return _heads_to_seq(y, ax)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.ax), None


def _ulysses_shard(q, k, v, *, ax: _Axis, causal: bool, local_attn):
    qh, kh, vh = (_SeqToHeads.apply(x, ax) for x in (q, k, v))
    o = local_attn(qh, kh, vh, causal=causal)
    return _HeadsToSeq.apply(o.contiguous(), ax)


def ulysses_attention(q, k, v, mesh, axis: str = "sp",
                      causal: bool = False, local_attn=None,
                      batch_axis: str | None = None,
                      head_axis: str | None = None):
    """Ulysses-style sequence parallelism: an all-to-all scatters heads
    and gathers the sequence, ``local_attn`` runs over ``[B, H/n, S, D]``,
    the inverse all-to-all swaps back. Requires num_heads % axis size ==
    0 (per-TP-shard heads when ``head_axis`` is set).

    ``local_attn``: None → :func:`dense_attention`; ``"auto"`` →
    ``ops.flash_attention.resolve_attn_fn("auto")`` (the flash kernel
    policy on the card, dense elsewhere); or any ``(q, k, v, causal=)``
    callable, e.g. ``ops.flash_attention.flash_attention``.
    ``batch_axis`` / ``head_axis`` and the input forms are
    :func:`ring_attention`'s."""
    layout = _layout(mesh, axis, batch_axis, head_axis)
    ax = layout[-1][1]
    n = ax.size
    tp = {d: a.size for d, a in layout}.get(1, 1)
    if q.shape[1] % tp:
        raise ValueError(
            f"num_heads={q.shape[1]} not divisible by {head_axis}={tp}")
    local_h = q.shape[1] // tp
    if local_h % n:
        raise ValueError(
            f"per-shard num_heads={local_h} not divisible by {axis}={n}")
    if isinstance(local_attn, str) and local_attn == "auto":
        from ..ops.flash_attention import resolve_attn_fn
        local_attn = resolve_attn_fn("auto")
    body = functools.partial(_ulysses_shard, ax=ax, causal=causal,
                             local_attn=local_attn or dense_attention)
    return _run(body, q, k, v, mesh, layout)
