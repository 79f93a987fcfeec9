"""Cache-aware flash DECODE attention: a hand-written CUDA kernel.

The counterpart of ``sparkdl_tpu/ops/flash_decode.py``. One query token
per row attends the KV cache at a fill index: ``q`` ``[B, Hq, 1, D]``,
caches ``[B, Hkv, L, D]`` with ``Hq % Hkv == 0`` (GQA), ``cur`` a scalar or
a ``[B]`` vector (slots ``>= cur[b]`` are unwritten), ``pad_lens`` an
optional ``[B]`` vector (slots ``< pad_lens[b]`` are left padding).

Decode is bound by the bytes of the cache it reads. The kernel
(``csrc/flash_decode.cu`` over the split-KV template
``csrc/decode_splitkv.cuh``) splits each row's ``L`` positions into
chunks (:func:`split_plan`, the one place the launch's plan is made: 256
positions, from the static shape only, so a captured CUDA graph stays
right when ``cur`` changes) spread over the grid; a block streams its chunk's live slots ``[pad_lens[b], cur[b])``
through a ``cp.async`` ring in shared memory, and the chunks' partial
softmaxes merge in the same launch, in split order, in the block that
finishes last. The dead tail and the left pad are never read — the TPU
kernel's O(cur) contract. A block holds :data:`MAX_ROWS` query rows of
a kv head's group; a larger group reads the head's K/V again for each
further block, mostly from L2. The wrapper allocates the merge's workspace per call
and keeps one zeroed counter buffer per device and size
(:func:`splitkv_workspace`); the kernel leaves it zeroed.

A CPU tensor takes :func:`flash_decode_plain`; a CUDA tensor launches the
kernel or raises. :func:`splitkv_emulation` repeats the kernel's
arithmetic in PyTorch for the CPU tests; nothing on the main path calls
it. The TPU kernel's ``L % 128`` rule was a Mosaic tiling rule; this
kernel takes any cache length (see :func:`support_reason`).
"""

from __future__ import annotations

import math
import os

import torch

from ..parallel.ring_attention import NEG_INF

LOG2E = 1.4426950408889634

#: what the CUDA kernel takes (its plain version takes anything)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_GQA = (1, 2, 4, 8)

#: the cache-length multiple the kernel needs: 1, any length works (the
#: JAX kernel needed whole 128-slot blocks, and its generate() rounded
#: the default cache up for it; the port's generate() has nothing to do)
KV_BLOCK = 1

#: the split-KV plan (:func:`split_plan`): positions a split, doubled
#: until the splits number at most MAX_SPLITS, up to MAX_CHUNK (the most
#: the kernel was built for); at most MAX_ROWS query rows a block, 1 or 2
#: (what the kernel was built for; chosen on the card: PERF.md §6)
SPLIT_CHUNK = 256
MAX_ROWS = 2
MAX_SPLITS = 1024
MAX_CHUNK = 512
#: the most positions a row the kernels take (``support_reason``)
MAX_POSITIONS = MAX_SPLITS * MAX_CHUNK

_COUNTERS: dict = {}


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


def split_plan(npos: int, rows: int) -> tuple[int, int, int]:
    """``(rows a block, positions a split, splits)`` of one launch over
    ``npos`` positions and ``rows = S * rep`` query rows, which the
    wrappers hand the kernel and size its workspace by: at most
    :data:`MAX_ROWS` rows a block; :data:`SPLIT_CHUNK` positions a split,
    doubled until the splits number at most :data:`MAX_SPLITS`. Only
    static shapes enter, never ``cur``. The kernel refuses a plan it was
    not built for."""
    rt = min(rows, MAX_ROWS)
    chunk = SPLIT_CHUNK
    while -(-npos // chunk) > MAX_SPLITS:
        chunk *= 2
    if chunk > MAX_CHUNK:
        raise ValueError(f"{npos} positions need chunks above {MAX_CHUNK}")
    return rt, chunk, -(-npos // chunk)


def split_blocks(npos: int, rows: int, hkv: int, spans) -> dict:
    """The blocks one launch of :func:`split_plan` runs, and those whose
    chunk meets a row's live span ``[start, end)`` (``spans``, one pair a
    slot): what the kernel's ``block_counter`` should read. For checks;
    nothing on the main path calls it."""
    rt, chunk, n = split_plan(npos, rows)
    groups = -(-rows // rt)
    live = sum((hi - 1) // chunk - lo // chunk + 1
               for lo, hi in spans if hi > lo)
    return dict(rows_per_block=rt, chunk=chunk, n_splits=n,
                grid_blocks=len(spans) * hkv * groups * n,
                live_blocks=live * hkv * groups)


def check_block_counter(counter, device) -> None:
    """Raise unless ``counter`` is None or two int32 elements on
    ``device``: the wrappers' optional ``block_counter``."""
    if counter is not None and (counter.dtype != torch.int32
                                or counter.numel() != 2
                                or counter.device != device):
        raise ValueError("block_counter must be two int32 elements on q's "
                         "device")


def splitkv_workspace(device, groups: int, n_splits: int, rt: int,
                      d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The split-KV merge's workspace and counters for one launch of
    ``groups`` (slot, kv head, row group) triples: a fresh f32 workspace
    of ``(m, l, acc[d])`` per (group, split, row) on PyTorch's current
    stream, and the ``[groups]`` int32 counters, zeroed once and kept per
    device and size (the kernel leaves them at 0; a refused launch never
    touches them, and a fault inside the kernel leaves the CUDA context
    unusable, so a stale count is never seen). Calls that may run at once
    on two streams must not share counters: the port issues every call on
    the current stream."""
    ws = torch.empty(groups * n_splits * rt * (d + 2), dtype=torch.float32,
                     device=device)
    key = (device.index, groups)
    cnt = _COUNTERS.get(key)
    if cnt is None:
        cnt = _COUNTERS[key] = torch.zeros(groups, dtype=torch.int32,
                                           device=device)
    return ws, cnt


def splitkv_emulation(qg, k, v, lim, start, end, *, elt_bytes: int,
                      sk=None, sv=None, chunk: int = SPLIT_CHUNK):
    """The split-KV kernels' arithmetic in PyTorch (f32, CPU), for tests.

    ``qg`` ``[B, Hkv, R, D]`` query rows (row ``i * rep + g``); ``k``,
    ``v`` ``[B, Hkv, npos, D]`` f32, already zero wherever a position lies
    outside ``[start[b], end[b])`` (the kernel zero-fills those instead of
    reading them); ``lim`` ``[B, R]`` the last position each row attends;
    ``sk``, ``sv`` ``[B, Hkv, npos]`` per-position scales of a code pool.
    As the kernel: scores in log2 units; a chunk of ``chunk`` positions a
    split, cut in tiles of 4096 / (D * elt_bytes) rows; key slot j of a
    block takes row j of each tile with its own online softmax; the slots
    of a warp merge pairwise, the warps in order; a split with nothing
    live is the empty partial (NEG_INF, 0); the splits merge in index
    order. Returns ``[B, Hkv, R, D]`` f32."""
    b, hkv, r, d = qg.shape
    npos = k.shape[2]
    cpr = d * elt_bytes // 16
    tr, kpw = 256 // cpr, max(1, 32 // cpr)
    n = -(-npos // chunk)
    pad_to = n * chunk
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad_to - npos))
            for x in (k, v))
    sk = (torch.ones(b, hkv, pad_to) if sk is None else
          torch.nn.functional.pad(sk, (0, pad_to - npos), value=1.0))
    sv = (torch.ones(b, hkv, pad_to) if sv is None else
          torch.nn.functional.pad(sv, (0, pad_to - npos), value=1.0))
    q2 = qg.float() * (LOG2E / math.sqrt(d))
    pos = torch.arange(pad_to)
    ok = (pos[None] >= start[:, None]) & (pos[None] < end[:, None])
    live = ok[:, None, :] & (pos[None, None] <= lim[:, :, None])  # [B,R,P]
    neg = torch.tensor(NEG_INF)

    def merge(x, y):
        mn = torch.maximum(x[0], y[0])
        a, c = torch.exp2(x[0] - mn), torch.exp2(y[0] - mn)
        return (mn, x[1] * a + y[1] * c,
                x[2] * a[..., None] + y[2] * c[..., None])

    parts = []
    for s in range(n):
        sl = slice(s * chunk, (s + 1) * chunk)
        chunk_live = ok[:, sl].any(1)               # [B]
        kc = k[:, :, sl].reshape(b, hkv, chunk // tr, tr, d)
        vc = v[:, :, sl].reshape(b, hkv, chunk // tr, tr, d)
        sc = torch.einsum("bhrd,bhtjd->bhrtj", q2, kc)
        sc = sc * sk[:, :, sl].reshape(b, hkv, 1, chunk // tr, tr)
        lv = live[:, :, sl].reshape(b, 1, r, chunk // tr, tr)
        sc = torch.where(lv, sc, neg)
        svc = sv[:, :, sl].reshape(b, hkv, 1, chunk // tr, tr)
        m = torch.full((b, hkv, r, tr), NEG_INF)
        l = torch.zeros((b, hkv, r, tr))
        acc = torch.zeros((b, hkv, r, tr, d))
        for t in range(chunk // tr):                # each slot's keys
            st = sc[:, :, :, t]
            mn = torch.maximum(m, st)
            alpha = torch.exp2(m - mn)
            p = torch.where(st > NEG_INF, torch.exp2(st - mn), 0.0)
            l = l * alpha + p
            acc = (acc * alpha[..., None]
                   + (p * svc[:, :, :, t])[..., None] * vc[:, :, None, t])
            m = mn
        w = (m.reshape(b, hkv, r, -1, kpw), l.reshape(b, hkv, r, -1, kpw),
             acc.reshape(b, hkv, r, -1, kpw, d))
        while w[0].shape[-1] > 1:                   # a warp's slots
            w = merge((w[0][..., 0::2], w[1][..., 0::2], w[2][..., 0::2, :]),
                      (w[0][..., 1::2], w[1][..., 1::2], w[2][..., 1::2, :]))
        wm, wl, wa = w[0][..., 0], w[1][..., 0], w[2][..., 0, :]
        mx = wm.amax(-1)                            # the warps, in order
        c = torch.exp2(wm - mx[..., None])
        lsum = torch.zeros_like(mx)
        a = torch.zeros((b, hkv, r, d))
        for i in range(wm.shape[-1]):
            lsum = lsum + wl[..., i] * c[..., i]
            a = a + wa[..., i, :] * c[..., i, None]
        empty = ~chunk_live[:, None, None]
        parts.append((torch.where(empty, neg, mx),
                      torch.where(empty, 0.0, lsum),
                      torch.where(empty[..., None], 0.0, a)))
    mx = torch.stack([p[0] for p in parts]).amax(0)
    lsum = torch.zeros_like(mx)
    a = torch.zeros((b, hkv, r, d))
    for pm, pl_, pa in parts:                       # splits, in order
        wgt = torch.where(pm > NEG_INF, torch.exp2(pm - mx), 0.0)
        lsum = lsum + pl_ * wgt
        a = a + pa * wgt[..., None]
    return a / torch.where(lsum > 0, lsum, 1.0)[..., None]


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


def flash_decode_emulation(q, k_cache, v_cache, cur, pad_lens=None,
                           chunk: int = SPLIT_CHUNK):
    """:func:`splitkv_emulation` with the kernel's contiguous pages, for
    the CPU tests: S = 1 and a last position of ``cur - 1`` (cur is
    exclusive here); slots outside ``[pad_lens[b], cur[b])`` are zero,
    as the kernel zero-fills them without reading."""
    b, hq, _, d = q.shape
    _, h_kv, max_len, _ = k_cache.shape
    rep = hq // h_kv
    curv = _rows(cur, b, "cpu", "cur").long()
    start = (torch.zeros(b, dtype=torch.long) if pad_lens is None else
             _rows(pad_lens, b, "cpu", "pad_lens").long().clamp(min=0))
    end = torch.minimum(curv, torch.tensor(max_len))
    col = torch.arange(max_len)
    ok = ((col[None] >= start[:, None]) & (col[None] < end[:, None])
          )[:, None, :, None]
    k, v = (torch.where(ok, x.float(), 0.0) for x in (k_cache, v_cache))
    o = splitkv_emulation(q.float().reshape(b, h_kv, rep, d), k, v,
                          (curv - 1)[:, None].expand(b, rep), start, end,
                          elt_bytes=k_cache.element_size(), chunk=chunk)
    return o.reshape(b, hq, 1, d).to(q.dtype)


def support_reason(q, k_cache) -> str | None:
    """None when :func:`flash_decode` takes these inputs, else a
    human-readable reason, which :func:`flash_decode` raises with. CPU
    tensors take the plain version, which covers
    every shape; CUDA tensors need what the kernel needs: head dim 64 or
    128, f32 or bf16 (q and cache alike), a GQA ratio of 1, 2, 4 or 8, at
    most :data:`MAX_POSITIONS` cache slots. Any cache length up to that
    works."""
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
    if k_cache.shape[2] > MAX_POSITIONS:
        return (f"cache length {k_cache.shape[2]} exceeds the kernel's "
                f"{MAX_POSITIONS} positions")
    return None


def supports(q, k_cache) -> bool:
    """Boolean twin of :func:`support_reason`."""
    return support_reason(q, k_cache) is None


def flash_decode(q, k_cache, v_cache, cur, pad_lens=None, *,
                 block_counter=None):
    """Single-step cache attention → ``[B, Hq, 1, D]`` in q's dtype.

    ``cur``: a Python int (one fill index for every row), or an int
    tensor, scalar or ``[B]``. ``pad_lens``: optional ``[B]`` ints. CPU
    tensors → :func:`flash_decode_plain`; CUDA tensors → the kernel, after
    checks that raise on what it does not take. Counts its launches in
    ``flash_decode.launches``.

    ``block_counter``: an optional two-element int32 tensor on q's
    device; the kernel adds to it the blocks it ran and those that found
    a live slot. For checks of the split plan; it costs one or two
    atomics a block."""
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
    check_block_counter(block_counter, q.device)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, cur, pad_lens)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu tensors, got "
                         f"{q.device}")
    from . import _build
    _build.refuse_export("flash_decode")
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

    cur_vec, cur_scalar = None, 0
    if isinstance(cur, int):
        cur_scalar = cur
    else:
        cur_vec = _rows(cur, b, q.device, "cur")
    pad = (None if pad_lens is None
           else _rows(pad_lens, b, q.device, "pad_lens"))
    o = torch.empty_like(q)
    lib = _build.library()
    rep = hq // h_kv
    rt, chunk, n_splits = split_plan(max_len, rep)
    with torch.cuda.device(q.device):
        ws, cnt = splitkv_workspace(q.device, b * h_kv * -(-rep // rt),
                                    n_splits, rt, d)
        err = lib.sdl_flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            o.data_ptr(), None if cur_vec is None else cur_vec.data_ptr(),
            cur_scalar, None if pad is None else pad.data_ptr(), b, h_kv,
            rep, max_len, d, int(q.dtype == torch.bfloat16), rt, chunk,
            ws.data_ptr(), ws.numel(), cnt.data_ptr(),
            None if block_counter is None else block_counter.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_decode")
    _build.count_launch(flash_decode)
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


def decode_fn_for(attn_fn, mesh=None):
    """Call-site resolver (``models.llama.LlamaAttention``): the decode
    kernel pairs with the flash prefill — when the model's resolved
    ``attn_fn`` is :func:`ops.flash_attention.flash_attention` or
    :func:`ops.flash_attention.adaptive_attention`, per-token decode steps
    run through :func:`flash_decode`; any other attention keeps the
    in-model dense cache path. ``SPARKDL_FLASH_DECODE=0`` (or ``off``,
    ``false``; read by :func:`tri_state_env`) turns it off, the ablation
    lever, under a mesh too.

    ``mesh`` (the tensor-parallel serving model's ``{"tp": n}`` mesh,
    whose prefill is dense, ``attn_fn=None``): the kernel runs on each
    rank's local heads through ``parallel.sharding.head_sharded_kernel``,
    whatever ``attn_fn`` is (on a CPU gang the wrapper runs its plain
    version, as it does for any CPU tensor)."""
    if tri_state_env("SPARKDL_FLASH_DECODE") == "off":
        return None
    if mesh is not None:
        from ..parallel.sharding import head_sharded_kernel
        return head_sharded_kernel(flash_decode, mesh)
    from .flash_attention import adaptive_attention, flash_attention
    if attn_fn is flash_attention or attn_fn is adaptive_attention:
        return flash_decode
    return None
