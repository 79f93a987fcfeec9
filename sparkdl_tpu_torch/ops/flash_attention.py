"""Flash attention forward: a hand-written CUDA kernel and its policy.

The counterpart of ``sparkdl_tpu/ops/flash_attention.py``. Layout
``[B, H, S, D]``; the same ``(q, k, v, causal=..., kv_mask=...)``
signature as :func:`parallel.ring_attention.dense_attention`, so it drops
into ``LlamaModel(attn_fn=...)``.

- :func:`flash_attention_fwd` returns ``(O, lse)``; :func:`flash_attention`
  returns O. A CPU tensor takes :func:`attention_plain`, the plain
  PyTorch version of the same arithmetic. A CUDA tensor launches a
  kernel or raises — nothing falls back. The kernel is picked by dtype
  (:func:`kernel_variant`, the one place that choice is made; the C entry
  point launches the variant it is handed): bf16 runs ``"tc_mma_bf16"``
  (``csrc/flash_attention_tc.cu``, both products on the tensor cores),
  f32 runs ``"fma_f32"`` (``csrc/flash_attention.cu``, f32 FMAs on the
  CUDA cores: the tensor cores have no full-precision f32 product).
- The tensor-core variant rounds P to bf16 once before ``P·V`` (the JAX
  kernel and :func:`attention_plain` keep p in f32). Checks hold it to
  :func:`tc_bf16_tolerance`.
- Masking is the JAX kernel's exactly (``_fwd_kernel``,
  ``sparkdl_tpu/ops/flash_attention.py:78-98``): a score is live when
  ``col < S``, ``kv_mask[col] > 0`` and, causal, ``col <= row``; a
  fully-masked row gives O = 0 and lse = ``NEG_INF`` (finite).
- Forward only. The JAX package's backward (``_flash_bwd``) is plain JAX
  under a ``custom_vjp``; its port, a ``torch.autograd.Function`` whose
  backward is a kernel too, belongs to the training slice (ROADMAP.md).
  Until then the kernel refuses inputs that need a gradient
  (:func:`gradient_reason`): its O, written through a raw pointer, would
  carry no ``grad_fn`` and q, k and v would silently get none. The plain
  version on CPU tensors is differentiable.

The TPU's tuning does not carry over: no 128-lane padding, no pre-blocked
lse/mask layouts, no block-size cost model. ``SPARKDL_FLASH_MIN_SEQ``
(the shortest sequence :func:`adaptive_attention` sends to the kernel)
defaults to 0 here, so the kernel runs at every prefill length; its
H100 crossover with dense attention is in PERF.md.
"""

from __future__ import annotations

import math
import os

import torch

from ..parallel.ring_attention import NEG_INF, dense_attention
from ..utils.platform import is_cuda_backend

#: what the CUDA kernel takes (its plain version takes anything)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_VARIANT_IDS = {"fma_f32": 0, "tc_mma_bf16": 1}  # the C entry's `variant`
# The tensor-core variant's rule: atol, ·|O_plain|, ·(P|V|)_plain
TC_BF16_RULE = (1e-5, 2.0 ** -7, 2.0 ** -8)


def kernel_variant(dtype) -> str:
    """Which CUDA kernel :func:`flash_attention_fwd` launches for ``dtype``:
    ``"tc_mma_bf16"`` (tensor cores) for bf16, ``"fma_f32"`` (CUDA cores)
    for f32. Other dtypes have no kernel (see :func:`support_reason`)."""
    if dtype == torch.bfloat16:
        return "tc_mma_bf16"
    if dtype == torch.float32:
        return "fma_f32"
    raise ValueError(f"flash_attention has no kernel for {dtype}")


def _plain_probs(q, k, causal, kv_mask):
    """Unnormalized f32 probabilities ``p``, row max ``m`` and ``safe_l``
    of :func:`attention_plain`, with the kernel's mask semantics."""
    _, _, s, d = q.shape
    scores = (q.float() * (1.0 / math.sqrt(d))) @ k.float().transpose(-1, -2)
    live = torch.ones((1, 1, 1, s), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        live = (kv_mask.float() > 0)[:, None, None, :]
    if causal:
        live = live & torch.ones((s, s), dtype=torch.bool,
                                 device=q.device).tril()
    scores = torch.where(live, scores, NEG_INF)
    m = scores.amax(-1)
    p = torch.exp(scores - m[..., None])
    p = torch.where(m[..., None] <= NEG_INF, 0.0, p)  # fully-masked rows
    l = p.sum(-1)
    return p, m, torch.where(l > 0, l, 1.0)


def attention_plain(q, k, v, causal: bool = False, kv_mask=None):
    """Plain PyTorch version of the kernel: ``(O, lse)`` from the whole
    score matrix at once, in f32, with the kernel's mask semantics. O in
    q's dtype, lse ``[B, H, S]`` f32."""
    p, m, safe_l = _plain_probs(q, k, causal, kv_mask)
    o = (p @ v.float()) / safe_l[..., None]
    return o.to(q.dtype), m + torch.log(safe_l)


def attention_abs_pv_plain(q, k, v, causal: bool = False, kv_mask=None):
    """``(P|V|)/l`` in f32, ``[B, H, S, D]``: :func:`attention_plain`'s O
    with |v| in place of v. Rounding each p_j to bf16 moves O by at most
    2**-9 of it; checks of the tensor-core variant scale their tolerance
    by it. Used only by checks."""
    p, _, safe_l = _plain_probs(q, k, causal, kv_mask)
    return (p @ v.float().abs()) / safe_l[..., None]


def tc_bf16_tolerance(o_plain, pv):
    """Elementwise bound on ``|O_kernel - O_plain|`` for the tensor-core
    variant: ``1e-5 + 2**-7·|O_plain| + 2**-8·pv``, ``pv`` from
    :func:`attention_abs_pv_plain` (:data:`TC_BF16_RULE`). 2**-7·|O| is
    one bf16 output step; rounding each p_j to bf16 moves O by at most
    2**-9·(P|V|), and l, summed from the unrounded p, disagrees with the
    rounded P by about as much again. Used only by checks."""
    atol, rtol, pv_rtol = TC_BF16_RULE
    return atol + rtol * o_plain.float().abs() + pv_rtol * pv


def gradient_reason(grad_enabled: bool, inputs) -> str | None:
    """The kernel's gradient rule, on plain values so that a CPU test can
    hold it: ``inputs`` is one ``(device type, requires_grad)`` pair for
    each of q, k and v. With grad mode on, an input that would reach the
    kernel (any device but the CPU) and requires grad is refused: the
    kernel has no backward yet, and its output would carry no
    ``grad_fn``. None when the rule lets the inputs through."""
    if grad_enabled and any(dev != "cpu" and rg for dev, rg in inputs):
        return ("q, k or v requires grad, and the kernel has no backward "
                "yet (its output would carry no gradient); run under "
                "torch.no_grad() or give the model attn_fn=None for "
                "gradients")
    return None


def support_reason(q, k, v) -> str | None:
    """None when :func:`flash_attention` takes these inputs, else why not.
    CPU tensors take the plain version, which covers every shape and is
    differentiable; other tensors need what the kernel needs: head dim 64
    or 128, f32 or bf16, one dtype for q, k and v, and no gradient
    (:func:`gradient_reason`)."""
    if q.device.type == "cpu":
        return None
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        return f"head_dim {d} is not one of {KERNEL_HEAD_DIMS}"
    if q.dtype not in KERNEL_DTYPES:
        return f"dtype {q.dtype} is not f32 or bf16"
    if k.dtype != q.dtype or v.dtype != q.dtype:
        return (f"q, k, v dtypes differ ({q.dtype}, {k.dtype}, "
                f"{v.dtype})")
    return gradient_reason(torch.is_grad_enabled(),
                           [(t.device.type, t.requires_grad)
                            for t in (q, k, v)])


def _check(q, k, v, kv_mask) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, H, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if kv_mask is not None and tuple(kv_mask.shape) != (q.shape[0],
                                                        q.shape[2]):
        raise ValueError(f"kv_mask must be [B, S] = "
                         f"{(q.shape[0], q.shape[2])}, got "
                         f"{tuple(kv_mask.shape)}")
    devs = {t.device for t in (q, k, v)} | (
        set() if kv_mask is None else {kv_mask.device})
    if len(devs) != 1:
        raise ValueError(f"q, k, v, kv_mask lie on different devices: "
                         f"{sorted(map(str, devs))}")


def flash_attention_fwd(q, k, v, causal: bool = False, *, kv_mask=None,
                        tile_counter=None):
    """``(O, lse)``: O ``[B, H, S, D]`` in q's dtype, lse ``[B, H, S]``
    f32. CPU tensors → :func:`attention_plain`; CUDA tensors → the
    kernel, after checks that raise on what it does not take. Counts
    its launches in ``flash_attention_fwd.launches``.

    ``tile_counter``: an optional one-element int32 tensor on q's device;
    the tensor-core kernel adds to it the (64-row Q tile, 64-row K tile)
    pairs it computed, the f32 kernel leaves it as it is. For checks of
    the dead-tile skip; it costs one atomic a block."""
    _check(q, k, v, kv_mask)
    if tile_counter is not None and (
            tile_counter.dtype != torch.int32
            or tile_counter.numel() != 1
            or tile_counter.device != q.device):
        raise ValueError("tile_counter must be one int32 element on q's "
                         "device")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    reason = support_reason(q, k, v)
    if reason is not None:
        raise ValueError(f"flash_attention kernel: {reason}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention kernel needs contiguous, "
                             "16-byte aligned q, k, v")
    from . import _build

    b, h, s, d = q.shape
    mask = None if kv_mask is None else kv_mask.to(torch.float32).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.sdl_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, s, d, int(bool(causal)),
            _VARIANT_IDS[kernel_variant(q.dtype)],
            None if tile_counter is None else tile_counter.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = False, *, kv_mask=None):
    """Flash attention. q/k/v: ``[B, H, S, D]`` → ``[B, H, S, D]``.

    ``kv_mask``: optional ``[B, S]`` 0/1 tensor — key positions with 0 are
    excluded from every query's softmax (the BERT attention-mask
    contract)."""
    return flash_attention_fwd(q, k, v, causal, kv_mask=kv_mask)[0]


def dense_attention_masked(q, k, v, causal: bool = False, kv_mask=None):
    """The dense arm of :func:`adaptive_attention`: delegates to
    ``parallel.ring_attention.dense_attention`` (one source of truth for
    the reference numerics)."""
    return dense_attention(q, k, v, causal, kv_mask)


def _flash_min_seq() -> int:
    return int(os.environ.get("SPARKDL_FLASH_MIN_SEQ", "0"))


def adaptive_attention(q, k, v, causal: bool = False, *, kv_mask=None):
    """Length-adaptive attention: :func:`flash_attention` at and above
    ``SPARKDL_FLASH_MIN_SEQ`` (default 0: every length), dense attention
    below. Inputs the kernel does not take (see :func:`support_reason`)
    raise there, as they do through :func:`flash_attention`; pass
    ``attn_fn=None`` to a model for dense attention instead."""
    if q.shape[2] >= _flash_min_seq():
        return flash_attention(q, k, v, causal, kv_mask=kv_mask)
    return dense_attention_masked(q, k, v, causal, kv_mask)


def auto_attn_fn():
    """The default-attention policy: :func:`adaptive_attention` when a
    CUDA device exists, ``None`` (dense attention in-model) elsewhere.
    Models accept the returned value as their ``attn_fn``."""
    if is_cuda_backend():
        return adaptive_attention
    return None


def resolve_attn_fn(attn_fn):
    """Model-side resolver: the sentinel ``"auto"`` (the Llama module
    default) becomes :func:`auto_attn_fn`'s pick; any explicit callable
    or None passes through untouched."""
    if isinstance(attn_fn, str) and attn_fn == "auto":
        return auto_attn_fn()
    return attn_fn
