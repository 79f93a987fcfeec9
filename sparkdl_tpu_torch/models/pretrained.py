"""Serving-weights cast — the one piece of ``sparkdl_tpu/models/
pretrained.py`` ported so far (the checkpoint importers wait for ROADMAP.md
Queue A 9).

:func:`cast_float_leaves` is the counterpart of the reference's function
of the same name: float weights with two or more dimensions (Dense
kernels and embedding tables, virtually all the bytes) go to the serving
dtype; 1-D ones (norm scales, biases) stay as they are, because the norms
compute in f32 from them. The port's models cast every weight to their
compute dtype at use (``models.bert``; ``models.llama``'s projections and
its f32 ``lm_head``), so pre-casting the matrices to that dtype changes
nothing they compute, and a module that computes in f32 from a matrix (a
logits head) sees bf16-rounded weights — the standard bf16-serving
trade-off. Use the original weights where bit-exact f32 parity matters
(training, equivalence tests).
"""

from __future__ import annotations

import copy

import torch
from torch import nn


def cast_float_leaves(model: nn.Module, dtype="bfloat16") -> nn.Module:
    """A deep copy of ``model`` with its float parameters and buffers of
    two or more dimensions cast to ``dtype`` (a name such as
    ``"bfloat16"`` or a ``torch.dtype``); ``model`` itself is untouched,
    as the reference's pytree map leaves its input. Integer and 1-D
    tensors pass through; casting twice is casting once."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    out = copy.deepcopy(model)
    with torch.no_grad():
        for t in list(out.parameters()) + list(out.buffers()):
            if t.is_floating_point() and t.dim() >= 2:
                t.data = t.data.to(dt)
    return out
