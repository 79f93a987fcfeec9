"""Paged flash-decode attention: a hand-written CUDA kernel that reads the
K/V cache through block tables, straight from the shared pool.

The counterpart of ``sparkdl_tpu/ops/paged_flash_decode.py``. The paged
serving engine keeps every slot's K/V in one pool of ``[P, Hkv, bs, D]``
blocks and gives each slot a table of the blocks it owns: logical
position ``p`` of slot ``r`` lives at pool row ``(tables[r, p // bs],
p % bs)``. One kernel serves both serving windows: ``S = 1`` is the
decode step, ``S = k+1`` the speculative verify window, and query ``i``
of slot ``r`` attends logical positions ``[pad_lens[r], slot_cur[r] +
i]``; a position past the table has nothing to attend.

The kernel (``csrc/paged_flash_decode.cu`` over the split-KV template
``csrc/decode_splitkv.cuh``) is bound by the bytes it reads. It reads
only the live positions of each slot, each through the table, so no
dense per-slot view of the pool is ever made and a step costs O(cur)
bytes per slot. Each slot's ``MB * bs`` positions split into chunks of
256 (:func:`ops.flash_decode.split_plan`, from static shapes only) spread
over the grid; a block reads its chunk's table entries once, streams
the live rows through a ``cp.async`` ring, and the chunks' partial
softmaxes merge in the same launch, in split order, in the block that
finishes last (its workspace allocated per call, its counters kept per
device by :func:`ops.flash_decode.splitkv_workspace`). A quantized pool
(int8 or fp8 codes) comes with its ``[P, Hkv, 2]`` f32 scale plane, and
the scales fold in after each product, so only the codes are read.

A CPU tensor takes :func:`paged_flash_decode_plain`; a CUDA tensor
launches the kernel or raises. There is no stand-down to the gathered
view: dense attention runs only where the caller asks for it
(``attn_fn=None`` or ``SPARKDL_SERVE_PAGED_KERNEL=0``).
:func:`paged_flash_decode_emulation` repeats the kernel's arithmetic
for the CPU tests; nothing on the main path calls it.
"""

from __future__ import annotations

import math

import torch

from ..parallel.ring_attention import NEG_INF
from .flash_decode import (MAX_POSITIONS, _rows, check_block_counter,
                           split_plan, splitkv_emulation, splitkv_workspace,
                           tri_state_env)

#: the explicit engagement knob: ``0`` off (the gathered view, the
#: ablation lever), anything else engages exactly when the dense
#: flash-decode kernel would for the same model
PAGED_KERNEL_ENV = "SPARKDL_SERVE_PAGED_KERNEL"

#: what the CUDA kernel takes (its plain version takes anything)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_Q_DTYPES = (torch.float32, torch.bfloat16)
#: quantized pool storage the kernel reads, with its kind code
KERNEL_CODE_DTYPES = {torch.int8: 1, torch.float8_e4m3fn: 2}
#: the most query rows (S * rep) one call may carry: the rows split into
#: groups of 2 across blocks, and each group reads the live K/V again
KERNEL_MAX_ROWS = 128


def gathered_view(pool, tables, plane=None, ch: int = 0):
    """The dense per-slot view ``[B, Hkv, MB*bs, D]`` of one pool leaf
    ``[P, Hkv, bs, D]`` through ``[B, MB]`` tables, in the pool's dtype;
    with a scale ``plane``, the codes dequantized by ``plane[..., ch]``
    in f32. The plain version's gather, and the model's dense arm."""
    t = tables.long()
    v = pool[t]                                           # [B, MB, Hkv, bs, D]
    if plane is not None:
        v = v.float() * plane[t][..., ch].float()[..., None, None]
    b, mb, hkv, bs, d = v.shape
    return v.permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, d)


def paged_flash_decode_plain(q, k_pool, v_pool, tables, slot_cur,
                             pad_lens=None, kv_scales=None):
    """Plain PyTorch version of the kernel: the gathered (dequantized)
    view of every slot's table, then a masked f32 softmax with the
    kernel's semantics (a row with nothing to attend gives 0). Positions
    no query of a slot may read (left pad, past ``cur + S``) are zeroed
    in the view first, so whatever they hold, NaN included, never reaches
    the output — as the kernel never reads them."""
    b, hq, s_q, d = q.shape
    hkv = k_pool.shape[1]
    rep = hq // hkv
    k = gathered_view(k_pool, tables, kv_scales, 0).float()
    v = gathered_view(v_pool, tables, kv_scales, 1).float()
    length = k.shape[2]
    col = torch.arange(length, device=q.device)
    cur = _rows(slot_cur, b, q.device, "slot_cur")
    pad = (torch.zeros(b, dtype=torch.int32, device=q.device)
           if pad_lens is None else _rows(pad_lens, b, q.device, "pad_lens"))
    qpos = cur[:, None] + torch.arange(s_q, device=q.device)[None, :]
    valid = ((col[None, None, :] <= qpos[..., None])
             & (col[None, None, :] >= pad[:, None, None]))    # [B, S, L]
    read = ((col[None, :] >= pad[:, None])
            & (col[None, :] < (cur + s_q)[:, None]))[:, None, :, None]
    k = torch.where(read, k, 0.0)
    v = torch.where(read, v, 0.0)
    qg = q.float().reshape(b, hkv, rep, s_q, d) * (1.0 / math.sqrt(d))
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(m <= NEG_INF, 0.0, p)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v) / torch.where(l > 0, l, 1.0)
    return o.reshape(b, hq, s_q, d).to(q.dtype)


def paged_flash_decode_emulation(q, k_pool, v_pool, tables, slot_cur,
                                 pad_lens=None, kv_scales=None):
    """:func:`ops.flash_decode.splitkv_emulation` with the kernel's table
    pages, for the CPU tests: query row ``i * rep + g`` attends
    ``[pad, cur + i]``; positions outside ``[pad, min(cur + S, MB*bs))``
    are zero (the kernel zero-fills them without reading), and a code
    pool's scales fold in per position, after each product."""
    b, hq, s_q, d = q.shape
    hkv, bs = k_pool.shape[1], k_pool.shape[2]
    rep, npos = hq // hkv, tables.shape[1] * bs
    cur = _rows(slot_cur, b, "cpu", "slot_cur").long()
    start = (torch.zeros(b, dtype=torch.long) if pad_lens is None else
             _rows(pad_lens, b, "cpu", "pad_lens").long().clamp(min=0))
    end = torch.minimum(cur + s_q, torch.tensor(npos))
    col = torch.arange(npos)
    ok = (col[None] >= start[:, None]) & (col[None] < end[:, None])
    ok4 = ok[:, None, :, None]
    k, v = (torch.where(ok4, gathered_view(x, tables).float(), 0.0)
            for x in (k_pool, v_pool))
    sk = sv = None
    if kv_scales is not None:
        blk = tables.long()[:, col // bs]                     # [B, npos]
        pair = kv_scales.float()[blk].permute(0, 2, 1, 3)     # [B,Hkv,P,2]
        sk, sv = (torch.where(ok[:, None], pair[..., c], 1.0)
                  for c in (0, 1))
    qg = q.float().reshape(b, hkv, rep, s_q, d).transpose(2, 3).reshape(
        b, hkv, s_q * rep, d)
    lim = cur[:, None] + torch.arange(s_q * rep)[None] // rep
    o = splitkv_emulation(qg, k, v, lim, start, end,
                          elt_bytes=k_pool.element_size(), sk=sk, sv=sv)
    return o.reshape(b, hkv, s_q, rep, d).transpose(2, 3).reshape(
        b, hq, s_q, d).to(q.dtype)


def support_reason(q, k_pool, kv_scales=None, tables=None) -> str | None:
    """None when :func:`paged_flash_decode` takes these inputs, else a
    human-readable reason, which it raises with. CPU tensors take the
    plain version, which covers every shape. CUDA tensors need what the
    kernel needs: head dim 64 or 128; f32 or bf16 queries; a pool in the
    query's dtype, or int8 / e4m3 codes with their scale plane; at most
    :data:`KERNEL_MAX_ROWS` query rows (``S * rep``); at most
    :data:`ops.flash_decode.MAX_POSITIONS` positions a table (``MB *
    bs``, checked when ``tables`` is given). Any block size, table width
    up to that and GQA ratio work (the TPU kernel's ``block_size % 8``
    was a Mosaic sublane rule)."""
    if q.device.type == "cpu":
        return None
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        return f"head_dim {d} is not one of {KERNEL_HEAD_DIMS}"
    if q.dtype not in KERNEL_Q_DTYPES:
        return f"dtype {q.dtype} is not f32 or bf16"
    if kv_scales is None and k_pool.dtype != q.dtype:
        return f"pool dtype {k_pool.dtype} differs from q's {q.dtype}"
    if kv_scales is not None and k_pool.dtype not in KERNEL_CODE_DTYPES:
        return (f"pool dtype {k_pool.dtype} is not a code type the kernel "
                f"reads ({sorted(str(t) for t in KERNEL_CODE_DTYPES)})")
    rows = q.shape[2] * (q.shape[1] // max(k_pool.shape[1], 1))
    if rows > KERNEL_MAX_ROWS:
        return (f"S * rep = {rows} query rows exceed the kernel's "
                f"{KERNEL_MAX_ROWS}")
    if tables is not None and tables.shape[1] * k_pool.shape[2] > \
            MAX_POSITIONS:
        return (f"{tables.shape[1]} blocks of {k_pool.shape[2]} positions "
                f"a table exceed the kernel's {MAX_POSITIONS}")
    return None


def _check(q, k_pool, v_pool, tables, kv_scales):
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"q must be [B, Hq, S, D] and the pools one "
                         f"[P, Hkv, bs, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, hq, _, d = q.shape
    _, hkv, _, _ = k_pool.shape
    if k_pool.shape[3] != d:
        raise ValueError(f"pool head dim {k_pool.shape[3]} != q's {d}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if kv_scales is None and k_pool.element_size() == 1:
        # codes without their scale plane would attend over raw code
        # values: refuse loudly instead
        raise ValueError(
            f"pool dtype {k_pool.dtype} holds quantized codes; pass the "
            f"[pool_blocks, Hkv, 2] kv_scales plane")
    if kv_scales is not None and tuple(kv_scales.shape) != (
            k_pool.shape[0], hkv, 2):
        raise ValueError(f"kv_scales must be [P={k_pool.shape[0]}, "
                         f"Hkv={hkv}, 2], got {tuple(kv_scales.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"tables must be [B={b}, max_blocks], got shape "
                         f"{tuple(tables.shape)}")


def paged_flash_decode(q, k_pool, v_pool, tables, slot_cur, pad_lens=None,
                       kv_scales=None, *, block_counter=None):
    """Block-table cache attention over the shared pool → ``[B, Hq, S,
    D]`` in q's dtype.

    ``q`` ``[B, Hq, S, D]``; ``k_pool``/``v_pool`` ``[P, Hkv, bs, D]``
    (``Hq % Hkv == 0``); ``tables`` ``[B, MB]`` int pool block ids, each
    in ``[0, P)``; ``slot_cur`` ``[B]`` ints, each slot's write frontier
    BEFORE the window (the window's own tokens are already written
    through the table); ``pad_lens`` optional ``[B]`` ints;
    ``kv_scales`` the ``[P, Hkv, 2]`` f32 scale plane, required exactly
    when the pools hold int8 / fp8 codes. CPU tensors →
    :func:`paged_flash_decode_plain`; CUDA tensors → the kernel, after
    checks that raise on what it does not take. Counts its launches in
    ``paged_flash_decode.launches``. ``block_counter``: as
    :func:`ops.flash_decode.flash_decode`'s."""
    _check(q, k_pool, v_pool, tables, kv_scales)
    check_block_counter(block_counter, q.device)
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pool, v_pool, tables, slot_cur,
                                        pad_lens, kv_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode runs on cuda or cpu tensors, "
                         f"got {q.device}")
    from . import _build
    _build.refuse_export("paged_flash_decode")
    reason = support_reason(q, k_pool, kv_scales, tables)
    if reason is not None:
        raise ValueError(f"paged_flash_decode kernel: {reason}")
    if v_pool.dtype != k_pool.dtype:
        raise ValueError(f"paged_flash_decode kernel: v pool dtype "
                         f"{v_pool.dtype} differs from k's {k_pool.dtype}")
    operands = [q, k_pool, v_pool] + ([] if kv_scales is None
                                      else [kv_scales])
    for t in operands:
        if t.device != q.device:
            raise ValueError("q, the pools and the scales lie on different "
                             "devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("paged_flash_decode kernel needs contiguous, "
                             "16-byte aligned q, pools and scales")
    if kv_scales is not None and kv_scales.dtype != torch.float32:
        raise ValueError(f"kv_scales must be f32, got {kv_scales.dtype}")

    b, hq, s_q, d = q.shape
    _, hkv, bs, _ = k_pool.shape
    mb = tables.shape[1]
    tbl = tables.to(device=q.device, dtype=torch.int32).contiguous()
    cur = _rows(slot_cur, b, q.device, "slot_cur")
    pad = (None if pad_lens is None
           else _rows(pad_lens, b, q.device, "pad_lens"))
    o = torch.empty_like(q)
    lib = _build.library()
    rows = s_q * (hq // hkv)
    rt, chunk, n_splits = split_plan(mb * bs, rows)
    with torch.cuda.device(q.device):
        ws, cnt = splitkv_workspace(q.device, b * hkv * -(-rows // rt),
                                    n_splits, rt, d)
        err = lib.sdl_paged_flash_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            None if kv_scales is None else kv_scales.data_ptr(),
            tbl.data_ptr(), cur.data_ptr(),
            None if pad is None else pad.data_ptr(), o.data_ptr(), b, hkv,
            hq // hkv, s_q, d, bs, mb, int(q.dtype == torch.bfloat16),
            KERNEL_CODE_DTYPES.get(k_pool.dtype, 0) if kv_scales is not None
            else 0, rt, chunk, ws.data_ptr(), ws.numel(), cnt.data_ptr(),
            None if block_counter is None else block_counter.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "paged_flash_decode")
    _build.count_launch(paged_flash_decode)
    return o


paged_flash_decode.launches = 0


def paged_decode_fn_for(attn_fn):
    """Call-site resolver (``models.llama`` paged ``slot_cur`` branch),
    the :func:`ops.flash_decode.decode_fn_for` twin for the block-table
    pool: the kernel runs when the model's resolved ``attn_fn`` is the
    flash kernel (the pairing the dense decode kernel uses), and also
    for any other ``attn_fn`` when ``SPARKDL_SERVE_PAGED_KERNEL=1``
    forces it. ``=0`` turns it off (the gathered view, the ablation
    lever). Returns :func:`paged_flash_decode` or None. The
    tensor-parallel ``mesh=`` branch of the JAX resolver comes with the
    tensor-parallel serving backends (ROADMAP.md, Queue A 8 (b))."""
    mode = tri_state_env(PAGED_KERNEL_ENV)  # one parser for both knobs
    if mode == "off":
        return None
    if mode == "auto":
        from .flash_decode import decode_fn_for
        if decode_fn_for(attn_fn) is None:
            return None
    return paged_flash_decode
