"""Reference single-device attention — the port's masking source of truth.

The counterpart of ``sparkdl_tpu/parallel/ring_attention.py:36-56``
(``dense_attention``). Ring attention and Ulysses are not ported yet;
they come with the multi-GPU slice (ROADMAP.md).
"""

from __future__ import annotations

import math

import torch

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
