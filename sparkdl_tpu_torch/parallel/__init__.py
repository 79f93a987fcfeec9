"""Parallelism toolkit of the port. Only the single-device reference
attention (``dense_attention``) so far; ring and Ulysses come with the
multi-GPU slice."""

from .ring_attention import NEG_INF, dense_attention

__all__ = ["NEG_INF", "dense_attention"]
