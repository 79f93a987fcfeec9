"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis.

The counterpart of ``sparkdl_tpu/parallel/pipeline.py``. Each rank of the
``pp`` axis owns one stage (its slice of the stacked stage parameters)
and activations hop stage to stage:

- ``P`` stages, ``M`` microbatches, ``M + P − 1`` uniform ticks: at tick
  ``t`` stage 0 injects microbatch ``min(t, M − 1)``, every stage runs
  its stage function once, the last stage emits microbatch ``t − (P −
  1)`` (from tick ``P − 1`` on), and every stage hands its activation to
  the next (a ring hop; stage 0's is replaced at the next injection).
- The output is summed over ``pp`` at the end (only the last stage wrote
  it), so every rank holds the whole ``(M, mb, ...)`` output; the sum's
  backward is the identity (each rank's loss of the replicated output is
  the same, the reference's ``psum`` under ``shard_map``).
- The hop is an autograd Function whose backward sends the gradient one
  stage back (the transpose of ``ppermute``), so the backward runs the
  reverse schedule; the activations a hop received and no stage used
  (stage 0's, the last tick's) are tied to the output with a zero
  gradient, so every rank runs every hop's backward, in the same order.
- ``remat=True`` runs each stage call under ``torch.utils.checkpoint``
  (``use_reentrant=False``): the backward recomputes it.

Stages must map a hidden state to one of the same shape (a decoder
block); embedding and head stay outside the pipeline.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from . import fsdp
from .sharding import P, shard_params


def stack_stage_params(per_stage_params: list) -> dict:
    """``[stage0_tree, stage1_tree, ...]`` → one tree (dicts / lists of
    tensors or arrays) with a leading stage axis (put it on the pipeline
    axis with :func:`stage_sharding`)."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params([p[i] for p in
                                               per_stage_params])
                           for i in range(len(first)))
    return torch.stack([torch.as_tensor(p) for p in per_stage_params])


def stage_sharding(mesh, params_stacked, axis: str = "pp"):
    """The stacked tree as ``DTensor``s sharded ``Shard(0)`` on ``axis``
    (every rank holds its stage's slice; rank 0's copy is placed)."""
    def rules(path, leaf):
        return P(axis, *([None] * (leaf.ndim - 1)))
    return shard_params(params_stacked, mesh, rules)


def _peer(group, r: int) -> int:
    return dist.get_global_rank(group, r)


def _ring(x, group, rank: int, n: int, step: int):
    """Send ``x`` to stage ``rank + step`` and receive from ``rank −
    step`` (mod n)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, _peer(group, (rank + step) % n),
                      group),
           dist.P2POp(dist.irecv, out, _peer(group, (rank - step) % n),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    fsdp.count("send_recv")
    return out


class _Hop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, group, rank, n):
        ctx.group, ctx.rank, ctx.n = group, rank, n
        return _ring(h, group, rank, n, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring(g, ctx.group, ctx.rank, ctx.n, -1), None, None, None


class _Tie(torch.autograd.Function):
    """``out`` itself; a zero gradient to every other input (so the hops
    that produced them run their backward)."""

    @staticmethod
    def forward(ctx, out, *loose):
        ctx.loose = [(t.shape, t.dtype, t.device) for t in loose]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dv)
                     for s, d, dv in ctx.loose))


def _local_stage(tree, rank: int):
    """This rank's stage of the stacked tree: a ``DTensor`` leaf's local
    slice, a plain leaf's row ``rank``."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _local_stage(v, rank) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_local_stage(v, rank) for v in tree)
    if isinstance(tree, DTensor):
        return tree.to_local()[0]
    return tree[rank]


def gpipe(stage_fn: Callable, mesh, axis: str = "pp",
          remat: bool = True) -> Callable:
    """The pipelined apply: ``fn(params_stacked, x) -> y``.

    ``stage_fn(stage_params, h) -> h`` runs ONE stage on one microbatch.
    ``params_stacked``: a tree with a leading stage axis of
    ``mesh[axis]`` rows, ``DTensor``s from :func:`stage_sharding` (their
    gradients land on them, ``Shard(0)``) or the same plain global tree
    on every rank (each rank reads its row; its gradient then holds that
    row alone). ``x``: ``(M, mb, ...)`` microbatches, the same on every
    rank. Returns the ``(M, mb, ...)`` outputs on every rank."""
    names = list(mesh.mesh_dim_names)
    if axis not in names:
        raise ValueError(f"axis {axis!r} is not an axis of the mesh "
                         f"{tuple(names)}")
    n = mesh.size(names.index(axis))
    group, rank = mesh.get_group(axis), mesh.get_local_rank(axis)

    def run(params, h):
        if remat:
            return torch.utils.checkpoint.checkpoint(
                stage_fn, params, h, use_reentrant=False)
        return stage_fn(params, h)

    def apply(params_stacked, x):
        params = _local_stage(params_stacked, rank)
        m = x.shape[0]
        h = torch.zeros_like(x[0])
        outs, loose = [], []
        for t in range(m + n - 1):
            if rank == 0:
                if t > 0:
                    loose.append(h)  # the last stage's hop, unused here
                h = x[min(t, m - 1)]
            h = run(params, h)
            if rank == n - 1 and t >= n - 1:
                outs.append(h)
            h = _Hop.apply(h, group, rank, n) if n > 1 else h
        if n > 1:
            loose.append(h)  # every stage's last hop
        out = torch.stack(outs) if outs else torch.zeros_like(x)
        if n > 1:
            out = fsdp.reduce_out(out, group)
            if torch.is_grad_enabled() and any(t.requires_grad
                                               for t in loose):
                out = _Tie.apply(out, *loose)
        return out

    return apply


def microbatch(x, num_microbatches: int):
    """``(N, ...)`` → ``(M, N/M, ...)``, the :func:`gpipe` input."""
    n = x.shape[0]
    if n % num_microbatches:
        raise ValueError(
            f"Batch {n} not divisible into {num_microbatches} microbatches")
    return x.reshape(num_microbatches, n // num_microbatches, *x.shape[1:])
