"""Flash attention, forward and backward: hand-written CUDA kernels and
their policy.

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
- The backward: :func:`flash_attention_bwd` returns ``(dq, dk, dv)`` from
  the saved ``(q, k, v, O, lse)`` and dO — the port of the JAX package's
  ``_bwd_one_head`` / ``_flash_bwd`` (plain JAX under a ``custom_vjp``
  there). CPU tensors take :func:`attention_bwd_plain`; CUDA tensors the
  kernel :func:`kernel_variant` picks, as for the forward: bf16
  ``"tc_mma_bf16"`` (``csrc/flash_attention_bwd_tc.cu``, all five products
  on the tensor cores, P and dS rounded to bf16 on the way, held to the
  wider rule of :func:`bwd_tolerance`), f32 ``"fma_f32"``
  (``csrc/flash_attention_bwd.cu``, f32 FMAs). :func:`flash_attention` goes
  through :class:`_FlashAttention`, a ``torch.autograd.Function`` over the
  two, whenever grad mode is on and q, k or v requires grad; otherwise it
  launches the forward alone, as the no-grad prefill and the captured decode
  graphs do.

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
from ..utils import flops
from ..utils.platform import is_cuda_backend

#: what the CUDA kernel takes (its plain version takes anything)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_VARIANT_IDS = {"fma_f32": 0, "tc_mma_bf16": 1}  # the C entry's `variant`
# The tensor-core variant's rule: atol, ·|O_plain|, ·(P|V|)_plain
TC_BF16_RULE = (1e-5, 2.0 ** -7, 2.0 ** -8)
# The backward's rule (bwd_tolerance), ·grad_abs, ·|grad_plain|: f32
# ("fma_f32") by dtype, and the tensor-core variant's, which rounds P and
# dS to bf16
BWD_RULE = {torch.float32: (1e-5, 1e-5)}
TC_BWD_RULE = (2.0 ** -8, 2.0 ** -7)


# products a live (query row, key) pair: q·kᵀ and P·V forward; q·kᵀ
# again, dV, dP, dK and dQ backward
FWD_PRODUCTS, BWD_PRODUCTS = 2, 5


def attention_flops(q, causal: bool = False, kv_mask=None,
                    products: int = FWD_PRODUCTS) -> int:
    """The FLOPs flash attention does at ``q``'s shape ``[B, H, S, D]``:
    2·D a product for each live (query row, key) pair and head,
    ``products`` products a pair (:data:`FWD_PRODUCTS` or
    :data:`BWD_PRODUCTS`). A pair is live where the kernels keep its
    score: ``kv_mask[col] > 0`` and, causal, ``col <= row``; a padded
    key is dead for every row, a padded query row still attends its live
    keys. What the wrappers report to a FLOP counter. With a ``kv_mask``
    it reads the mask's live keys (a wait for the device)."""
    _, h, s, d = q.shape
    if kv_mask is None:
        pairs = q.shape[0] * (s * (s + 1) // 2 if causal else s * s)
    else:
        live = (kv_mask.float() > 0).to(torch.int64)
        if causal:  # key col is live for the S - col rows at or after it
            live = live * torch.arange(s, 0, -1, device=live.device)
            pairs = int(live.sum())
        else:
            pairs = s * int(live.sum())
    return products * 2 * d * h * pairs


def kernel_variant(dtype) -> str:
    """Which CUDA kernels :func:`flash_attention_fwd` and
    :func:`flash_attention_bwd` launch for ``dtype``: ``"tc_mma_bf16"``
    (tensor cores) for bf16, ``"fma_f32"`` (CUDA cores) for f32. Other
    dtypes have no kernel (see :func:`support_reason`)."""
    if dtype == torch.bfloat16:
        return "tc_mma_bf16"
    if dtype == torch.float32:
        return "fma_f32"
    raise ValueError(f"flash_attention has no kernel for {dtype}")


def _plain_scores(q, k, causal, kv_mask):
    """f32 ``scale·q·kᵀ`` and the live-score mask (the kernels' rule: a
    score is live when ``kv_mask[col] > 0`` and, causal, ``col <= row``),
    broadcastable to ``[B, H, S, S]``."""
    _, _, s, d = q.shape
    scores = (q.float() * (1.0 / math.sqrt(d))) @ k.float().transpose(-1, -2)
    live = torch.ones((1, 1, 1, s), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        live = (kv_mask.float() > 0)[:, None, None, :]
    if causal:
        live = live & torch.ones((s, s), dtype=torch.bool,
                                 device=q.device).tril()
    return scores, live


def _plain_probs(q, k, causal, kv_mask):
    """Unnormalized f32 probabilities ``p``, row max ``m`` and ``safe_l``
    of :func:`attention_plain`, with the kernel's mask semantics."""
    scores, live = _plain_scores(q, k, causal, kv_mask)
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


def attention_bwd_plain(q, k, v, o, lse, do, causal: bool = False,
                        kv_mask=None):
    """Plain PyTorch version of the backward kernel, written from the JAX
    package's ``_bwd_one_head`` on whole matrices, in f32: ``(dq, dk,
    dv)``, each in its input's dtype. P = ``exp(scale·q·kᵀ - lse)`` where
    the score is live and 0 elsewhere (taken from the mask, never from the
    exp: a fully-masked row has lse = ``NEG_INF``); ``delta`` =
    ``rowsum(dO·O)``; dV = Pᵀ·dO; dS = P·(dO·Vᵀ - delta)·scale; dK =
    dSᵀ·q; dQ = dS·K."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores, live = _plain_scores(q, k, causal, kv_mask)
    p = torch.where(live, torch.exp(scores - lse.float()[..., None]), 0.0)
    dof = do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ v.float().transpose(-1, -2) - delta) * scale
    dk = ds.transpose(-1, -2) @ q.float()
    dq = ds @ k.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_abs_plain(q, k, v, o, lse, do, causal: bool = False,
                            kv_mask=None):
    """:func:`attention_bwd_plain` with every product taken over absolute
    values, in f32: ``(A_dq, A_dk, A_dv)``, each entry the sum of the
    magnitudes of the terms its gradient sums (``|dS|`` from ``P·(|dO|·
    |V|ᵀ + rowsum|dO·O|)·scale``). Checks of the backward kernel scale
    their tolerance by it (:func:`bwd_tolerance`). Used only by checks."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores, live = _plain_scores(q, k, causal, kv_mask)
    p = torch.where(live, torch.exp(scores - lse.float()[..., None]), 0.0)
    dof = do.float().abs()
    delta = (dof * o.float().abs()).sum(-1, keepdim=True)
    ds = p * (dof @ v.float().abs().transpose(-1, -2) + delta) * scale
    return (ds @ k.float().abs(), ds.transpose(-1, -2) @ q.float().abs(),
            p.transpose(-1, -2) @ dof)


def attention_bwd_tc_plain(q, k, v, o, lse, do, causal: bool = False,
                           kv_mask=None):
    """:func:`attention_bwd_plain` with the tensor-core variant's two
    roundings: P to bf16 before dV = Pᵀ·dO, and dS/scale to bf16 before
    dK = (dS/scale)ᵀ·q·scale and dQ = (dS/scale)·K·scale (the scale
    applied in f32 after the product, as the kernel's epilogue does); dS
    itself from the unrounded P. Used only by checks of the rule
    :data:`TC_BWD_RULE`."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores, live = _plain_scores(q, k, causal, kv_mask)
    p = torch.where(live, torch.exp(scores - lse.float()[..., None]), 0.0)
    dof = do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dof @ v.float().transpose(-1, -2) - delta)  # dS / scale
    p, ds = (t.bfloat16().float() for t in (p, ds))
    dv = p.transpose(-1, -2) @ dof
    dk = (ds.transpose(-1, -2) @ q.float()) * scale
    dq = (ds @ k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_tolerance(grad_plain, grad_abs):
    """Elementwise bound on ``|grad_kernel - grad_plain|`` for one of the
    backward's outputs: ``a·grad_abs + r·|grad_plain|``, ``grad_abs`` its
    entry of :func:`attention_bwd_abs_plain` and ``(a, r)`` picked by the
    kernel variant of ``grad_plain``'s dtype (:func:`kernel_variant`):
    :data:`BWD_RULE` (1e-5, 1e-5) for f32 (``"fma_f32"``),
    :data:`TC_BWD_RULE` (2**-8, 2**-7) for bf16 (``"tc_mma_bf16"``). The f32
    kernel and :func:`attention_bwd_plain` compute in f32 from the same
    inputs and differ in summation order only. An entry sums at most
    n = D + S terms (dP's and delta's D, then the S rows or columns) whose
    magnitudes add up to ``grad_abs``; two f32 orderings of such a sum
    differ by about sqrt(n)·2**-24·grad_abs, below 3e-6·grad_abs for
    n <= 2**13, which a·grad_abs covers (and dS = P·(dP - delta) can
    cancel to rounding noise, so a bound relative to the result alone would
    not). The bf16 outputs round their f32 value once and may land one
    bf16 step, at most 2**-7 of the value, from the plain version's. The
    tensor-core variant also rounds P (before dV) and dS/scale (before dK
    and dQ) to bf16, which :func:`attention_bwd_tc_plain` emulates: each
    rounding moves a term by at most 2**-9 of its magnitude, so the entry
    by at most 2**-9·grad_abs; a = 2**-8 doubles that for the f32 order
    and ``ex2`` differences ahead of the rounding. A fully-masked row has
    grad_abs = 0: its dq must be exactly 0. Used only by checks."""
    tc = kernel_variant(grad_plain.dtype) == "tc_mma_bf16"
    a, r = TC_BWD_RULE if tc else BWD_RULE[grad_plain.dtype]
    return a * grad_abs + r * grad_plain.float().abs()


def support_reason(q, k, v) -> str | None:
    """None when :func:`flash_attention` takes these inputs, else why not.
    CPU tensors take the plain versions, which cover every shape; other
    tensors need what the kernels (forward and backward) need: head dim
    64 or 128, f32 or bf16, one dtype for q, k and v."""
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
    return None


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
    the dead-tile skip; it costs one atomic a block.

    Under a FLOP counter (``utils.flops.count_flops``) it reports
    :func:`attention_flops` with the forward's 2 products, once, on the
    CPU as on the card."""
    with flops.kernel_work(
            lambda: attention_flops(q, causal, kv_mask, FWD_PRODUCTS)):
        return _fwd(q, k, v, causal, kv_mask, tile_counter)


def _fwd(q, k, v, causal, kv_mask, tile_counter):
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
    from . import _build
    _build.refuse_export("flash_attention")
    reason = support_reason(q, k, v)
    if reason is not None:
        raise ValueError(f"flash_attention kernel: {reason}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention kernel needs contiguous, "
                             "16-byte aligned q, k, v")

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
    _build.count_launch(flash_attention_fwd)
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                        kv_mask=None):
    """``(dq, dk, dv)`` of flash attention, each in its input's dtype, from
    the forward's ``(q, k, v, O, lse)`` (:func:`flash_attention_fwd`) and
    the gradient ``do`` of O. CPU tensors → :func:`attention_bwd_plain`;
    CUDA tensors → the kernel :func:`kernel_variant` picks, after the
    forward's checks, which raise on what it does not take. Counts its
    launches in ``flash_attention_bwd.launches``, and by variant in
    ``flash_attention_bwd.variant_launches``. Under a FLOP counter it
    reports :func:`attention_flops` with the backward's 5 products."""
    with flops.kernel_work(
            lambda: attention_flops(q, causal, kv_mask, BWD_PRODUCTS)):
        return _bwd(q, k, v, o, lse, do, causal, kv_mask)


def _bwd(q, k, v, o, lse, do, causal, kv_mask):
    _check(q, k, v, kv_mask)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and device "
                             f"({tuple(q.shape)}, {q.dtype}, {q.device}), got "
                             f"{tuple(t.shape)}, {t.dtype}, {t.device}")
    if (tuple(lse.shape) != tuple(q.shape[:3]) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"lse must be f32 {tuple(q.shape[:3])} on q's "
                         f"device, got {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}")
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do, causal, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    reason = support_reason(q, k, v)
    if reason is not None:
        raise ValueError(f"flash_attention_bwd kernel: {reason}")
    for t in (q, k, v, o, do, lse):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention_bwd kernel needs contiguous, "
                             "16-byte aligned q, k, v, o, do, lse")
    from . import _build

    b, h, s, d = q.shape
    variant = kernel_variant(q.dtype)
    mask = None if kv_mask is None else kv_mask.to(torch.float32).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.sdl_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(),
            None if mask is None else mask.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), b, h, s, d,
            int(bool(causal)), _VARIANT_IDS[variant],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.variant_launches[variant] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.variant_launches = dict.fromkeys(_VARIANT_IDS, 0)


class _FlashAttention(torch.autograd.Function):
    """O = flash attention of (q, k, v), with :func:`flash_attention_bwd`
    as its backward (the JAX package's ``custom_vjp`` ``_flash_core``).
    Saves ``(q, k, v, kv_mask, O, lse)``; ``kv_mask`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal):
        o, lse = flash_attention_fwd(q, k, v, causal, kv_mask=kv_mask)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, kv_mask)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, *, kv_mask=None):
    """Flash attention. q/k/v: ``[B, H, S, D]`` → ``[B, H, S, D]``.

    ``kv_mask``: optional ``[B, S]`` 0/1 tensor — key positions with 0 are
    excluded from every query's softmax (the BERT attention-mask
    contract). With grad mode on and q, k or v requiring grad, O carries
    the backward kernel (:class:`_FlashAttention`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kv_mask, bool(causal))
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
