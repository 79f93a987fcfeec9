"""Cache-aware flash DECODE attention: a hand-written CUDA kernel.

The counterpart of ``sparkdl_tpu/ops/flash_decode.py``. One query token
per row attends the KV cache at a fill index: ``q`` ``[B, Hq, 1, D]``,
caches ``[B, Hkv, L, D]`` with ``Hq % Hkv == 0`` (GQA), ``cur`` a scalar or
a ``[B]`` vector (slots ``>= cur[b]`` are unwritten), ``pad_lens`` an
optional ``[B]`` vector (slots ``< pad_lens[b]`` are left padding).

Decode is bound by the bytes of the cache it reads. The kernel in
``csrc/flash_decode.cu`` reads the live slots ``[pad_lens[b], cur[b])``
only — the dead tail and the left pad cost nothing, the TPU kernel's
O(cur) contract — and reads each kv head's K/V once for its whole query
group, with no repeat of the cache.

A CPU tensor takes :func:`flash_decode_plain`; a CUDA tensor launches the
kernel or raises. The TPU kernel's ``L % 128`` rule was a Mosaic tiling
rule; this kernel takes any cache length (see :func:`support_reason`).
"""

from __future__ import annotations

import math
import os

import torch

from ..parallel.ring_attention import NEG_INF

#: what the CUDA kernel takes (its plain version takes anything)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_GQA = (1, 2, 4, 8)

#: the cache-length multiple the kernel needs: 1, any length works (the
#: JAX kernel needed whole 128-slot blocks, and its generate() rounded
#: the default cache up for it; the port's generate() has nothing to do)
KV_BLOCK = 1


def _rows(x, b: int, device, name: str) -> torch.Tensor:
    """A scalar or ``[B]`` int as a contiguous ``[B]`` int32 tensor on
    ``device``."""
    t = torch.as_tensor(x, device=device)
    if t.dim() == 0:
        t = t.expand(b)
    if t.shape != (b,):
        raise ValueError(f"{name} must be a scalar or [B={b}] vector, got "
                         f"shape {tuple(t.shape)}")
    return t.to(torch.int32).contiguous()


def flash_decode_plain(q, k_cache, v_cache, cur, pad_lens=None):
    """Plain PyTorch version of the kernel: grouped scores over the whole
    cache, slots outside ``[pad_lens[b], cur[b])`` masked, f32 softmax
    with the kernel's semantics (a row with nothing live gives 0)."""
    b, hq, _, d = q.shape
    _, h_kv, max_len, _ = k_cache.shape
    rep = hq // h_kv
    qg = q.float().reshape(b, h_kv, rep, d) * (1.0 / math.sqrt(d))
    s = torch.einsum("bgrd,bgld->bgrl", qg, k_cache.float())
    col = torch.arange(max_len, device=q.device)[None, :]
    valid = col < _rows(cur, b, q.device, "cur")[:, None]
    if pad_lens is not None:
        valid = valid & (col >= _rows(pad_lens, b, q.device,
                                      "pad_lens")[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(m <= NEG_INF, 0.0, p)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bgrl,bgld->bgrd", p, v_cache.float()) / torch.where(
        l > 0, l, 1.0)
    return o.reshape(b, hq, 1, d).to(q.dtype)


def support_reason(q, k_cache) -> str | None:
    """None when :func:`flash_decode` takes these inputs, else a
    human-readable reason, which :func:`flash_decode` raises with. CPU
    tensors take the plain version, which covers
    every shape; CUDA tensors need what the kernel needs: head dim 64 or
    128, f32 or bf16 (q and cache alike), a GQA ratio of 1, 2, 4 or 8.
    Any cache length works."""
    if q.device.type == "cpu":
        return None
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        return f"head_dim {d} is not one of {KERNEL_HEAD_DIMS}"
    if q.dtype not in KERNEL_DTYPES:
        return f"dtype {q.dtype} is not f32 or bf16"
    if k_cache.dtype != q.dtype:
        return f"cache dtype {k_cache.dtype} differs from q's {q.dtype}"
    rep = q.shape[1] // max(k_cache.shape[1], 1)
    if rep not in KERNEL_GQA:
        return f"GQA ratio {rep} is not one of {KERNEL_GQA}"
    return None


def supports(q, k_cache) -> bool:
    """Boolean twin of :func:`support_reason`."""
    return support_reason(q, k_cache) is None


def flash_decode(q, k_cache, v_cache, cur, pad_lens=None):
    """Single-step cache attention → ``[B, Hq, 1, D]`` in q's dtype.

    ``cur``: a Python int (one fill index for every row), or an int
    tensor, scalar or ``[B]``. ``pad_lens``: optional ``[B]`` ints. CPU
    tensors → :func:`flash_decode_plain`; CUDA tensors → the kernel, after
    checks that raise on what it does not take. Counts its launches in
    ``flash_decode.launches``."""
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"q must be [B, Hq, 1, D] and the caches one "
                         f"[B, Hkv, L, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, hq, s1, d = q.shape
    _, h_kv, max_len, _ = k_cache.shape
    if s1 != 1:
        raise ValueError(f"flash_decode is single-token (got S={s1})")
    if k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if hq % h_kv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={h_kv}")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, cur, pad_lens)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu tensors, got "
                         f"{q.device}")
    reason = support_reason(q, k_cache)
    if reason is not None:
        raise ValueError(f"flash_decode kernel: {reason}")
    if v_cache.dtype != q.dtype:
        raise ValueError(f"flash_decode kernel: v cache dtype "
                         f"{v_cache.dtype} differs from q's {q.dtype}")
    for t in (q, k_cache, v_cache):
        if t.device != q.device:
            raise ValueError("q and the caches lie on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_decode kernel needs contiguous, 16-byte "
                             "aligned q and caches")
    from . import _build

    cur_vec, cur_scalar = None, 0
    if isinstance(cur, int):
        cur_scalar = cur
    else:
        cur_vec = _rows(cur, b, q.device, "cur")
    pad = (None if pad_lens is None
           else _rows(pad_lens, b, q.device, "pad_lens"))
    o = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.sdl_flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            o.data_ptr(), None if cur_vec is None else cur_vec.data_ptr(),
            cur_scalar, None if pad is None else pad.data_ptr(), b, h_kv,
            hq // h_kv, max_len, d, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_decode")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0


def tri_state_env(name: str) -> str:
    """Shared knob parser for the decode-kernel levers: ``0/off/false`` →
    ``"off"``, ``1/on/force/true`` → ``"force"``, anything else →
    ``"auto"``. One accepted-spelling table, so sibling knobs cannot
    drift."""
    v = os.environ.get(name, "auto").strip().lower()
    if v in ("0", "off", "false"):
        return "off"
    if v in ("1", "on", "force", "true"):
        return "force"
    return "auto"


def decode_fn_for(attn_fn):
    """Call-site resolver (``models.llama.LlamaAttention``): the decode
    kernel pairs with the flash prefill — when the model's resolved
    ``attn_fn`` is :func:`ops.flash_attention.flash_attention` or
    :func:`ops.flash_attention.adaptive_attention`, per-token decode steps
    run through :func:`flash_decode`; any other attention keeps the
    in-model dense cache path. ``SPARKDL_FLASH_DECODE=0`` (or ``off``,
    ``false``; read by :func:`tri_state_env`) turns it off, the ablation
    lever. The tensor-parallel ``mesh=`` branch of the JAX resolver comes
    with the multi-GPU slice."""
    if tri_state_env("SPARKDL_FLASH_DECODE") == "off":
        return None
    from .flash_attention import adaptive_attention, flash_attention
    if attn_fn is flash_attention or attn_fn is adaptive_attention:
        return flash_decode
    return None
