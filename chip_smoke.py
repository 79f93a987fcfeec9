#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``sparkdl_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with one CUDA device::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises, so the exit
code is not 0:

a. build — every ``sparkdl_tpu_torch/csrc/*.cu`` through one ``nvcc`` for
   ``sm_90a``, timed; the card's name and power limit from ``nvidia-smi``.
b. kernels — each kernel against its plain PyTorch version on the same
   inputs on the card, in f32 and bf16 (tolerances at ``TOL``), at the
   main path's shapes:
   flash_attention at B=4, H=16, S=2048, D=128, causal, left-pad kv_mask;
   flash_attention at a ragged S=1000 with an all-masked row (O exactly 0
   there); flash_decode at the main path's first decode step, at per-row
   fill levels, and at llama3_8b's 32:8 GQA layout. Each prints the
   kernel's time, its bound, the plain version's time and, as a yardstick
   the port never calls, ``F.scaled_dot_product_attention``'s.
   paged_flash_decode at ``LlamaConfig.small()``'s serving shapes (8
   slots, 16/8 heads, D 128, block 16, 132 blocks a table), ragged fills
   [2047, 1500, 900, 513, 300, 64, 17, 0] (the last slot parked on the
   trash block), non-contiguous tables, every block no live range reads
   filled with NaN; S = 1 and S = 5; bf16 and f32 pools, int8 and fp8
   pools with scales. Its SDPA yardstick runs on the pre-gathered dense
   view and so excludes the gather.
c. main path — ``generate()`` on ``LlamaConfig.small()`` at full width and
   depth (2048 hidden, 16 layers, 16/8 heads, head_dim 128, vocab 32000),
   bf16, random weights from a seeded generator on the card; four prompts
   of 2048, 1500, 700 and 33 tokens, left-padded; 64 new tokens, greedy.
   The launch counters are set to 0 just before and read just after:
   flash_attention must have launched once a layer, flash_decode once a
   layer per decode step. Prefill ms and decode ms per step are timed
   inside that one call.
d. parity — the same model in f32 (TF32 off): the dense in-model path
   (``attn_fn=None``) is fed the kernel path's tokens and its logits are
   held to the kernel path's at the prefill's last position and at every
   decode step.
e. serve — ``GenerationEngine.from_model`` on ``LlamaConfig.small()`` at
   full width and depth, bf16, seeded random weights on the card; four
   legs, each a fresh engine and one JSON line (requests completed, new
   tokens/s over the leg, TTFT p50/p95, mean decode-iteration ms, peak
   device memory, launch counters set to 0 just before the leg and read
   just after):
   1. paged (block 16, 256-token chunks), 12 requests of 32–1536 prompt
      tokens, four sharing their first 512 (radix grafts), 32 new tokens
      each: paged_flash_decode launches == 16 × engine steps, and
      flash_decode none;
   2. the same with ``spec_k=4`` (n-gram drafts), 4 requests whose
      prompts repeat n-grams: 16 paged launches per verify or decode
      iteration;
   3. ``kv_dtype="int8"``, 4 requests: the same identity, on int8 codes;
   4. unpaged blocking (``block_size=0, stall_free=False``), 4 requests:
      flash_attention launches == 16 × prefills and flash_decode
      launches == 16 × steps.
f. serve parity — f32, TF32 off, full depth: the paged engine (kernel)
   against the port's static ``generate()`` (flash kernels) on 4 prompts,
   16 new tokens each. Greedy streams must be identical at every position
   whose top-2 logit gap (from one dense forward over each finished
   sequence) exceeds 10 × ``LOGIT_TOL``; a flip below that is printed as
   a near tie with its gap.

Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Without a CUDA device, or without the package beside this file,
it prints no result and exits 2. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

H100_BYTES_S = 3.35e12            # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # f32 outside the tensor cores
# kernel vs plain, elementwise |kernel - plain| <= atol + rtol * |plain|.
# Both compute in f32. In f32 out they differ in summation order only
# (measured < 1e-6). In bf16 out each rounds its f32 value once, so they
# may land one bf16 step apart, and one step is at most 2**-7 of the
# value; atol covers the f32 differences under that rounding.
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-5, 2.0 ** -7)}
LOGIT_TOL = 2e-3
PROMPT_LENS = [2048, 1500, 700, 33]
NEW_TOKENS = 64
PARITY_TOKENS = 16
# paged_flash_decode cases: LlamaConfig.small()'s serving shapes
PAGED_CUR = [2047, 1500, 900, 513, 300, 64, 17, 0]  # slot 7 parked on trash
PAGED_PADS = [0, 0, 37, 0, 0, 0, 0, 0]
PAGED_BS, PAGED_MB = 16, 132
SERVE_NEW = 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 10, flush=None) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, CUDA events
    around each launch; ``flush`` (a large buffer) is zeroed before each
    one so the inputs come from device memory, not the 50 MB L2."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def check_close(got, want, dtype: str, what: str) -> float:
    """Hold ``got`` to ``want`` within ``TOL[dtype]``, elementwise; return
    the max |got - want|."""
    atol, rtol = TOL[dtype]
    diff = (got.float() - want.float()).abs()
    excess = (diff - rtol * want.float().abs()).max().item()
    err = diff.max().item()
    assert excess <= atol, (f"{what} {dtype}: |kernel - plain| exceeds "
                            f"{atol} + {rtol}·|plain| by {excess - atol} "
                            f"(max |kernel - plain| {err})")
    return err


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / H100_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ptxas_summary(log: str | None) -> dict | str:
    """Registers and spill stores of every kernel, from ``nvcc -Xptxas
    -v``: the most registers any kernel uses, and each kernel that
    spills (mangled name, cut). "not measured" without a report."""
    import re

    if not log:
        return "not measured"

    fn, regs, spills = None, {}, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn and int(m.group(1)):
            spills[fn[:90]] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[fn] = int(m.group(1))
    return dict(kernels=len(regs), max_registers=max(regs.values(),
                                                     default=None),
                spilling=spills)


def phase_build(_build) -> dict:
    t0 = time.perf_counter()
    _build.library()
    cached = _build.build_info.get("cached")
    info = dict(phase="build", seconds=time.perf_counter() - t0,
                cached=cached,
                nvcc_seconds="not measured" if cached
                else _build.build_info.get("seconds"),
                library=Path(_build.build_info["library"]).name,
                ptxas=ptxas_summary(_build.build_info.get("log")),
                nvidia_smi=smi())
    print(info["nvidia_smi"], flush=True)
    emit(info)
    return info


def attention_case(torch, fa, flush, *, name, b, h, s, d, causal, pads,
                   dtype):
    """flash_attention kernel vs plain on one seeded input, then the
    kernel's, the plain version's and SDPA's times; returns the phase-b
    record."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(s + d)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, h, s, d), generator=g, device="cuda",
                           dtype=torch.float32).to(dt) for _ in range(3))
    col = torch.arange(s, device="cuda")
    mask = (col[None, :] >= torch.tensor(pads, device="cuda")[:, None]
            ).float()
    o, lse = fa.flash_attention_fwd(q, k, v, causal, kv_mask=mask)
    o_ref, lse_ref = fa.attention_plain(q, k, v, causal, mask)
    torch.cuda.synchronize()
    err = check_close(o, o_ref, dtype, name)
    live = lse_ref > -1e29
    lse_err = (lse[live] - lse_ref[live]).abs().max().item()
    dead_rows = [r for r, p in enumerate(pads) if p >= s]
    for r in dead_rows:  # an all-masked row outputs exactly 0
        assert torch.all(o[r] == 0), f"{name}: masked row {r} is not 0"
        assert torch.all(lse[r] == lse_ref[r]), f"{name}: lse row {r}"
    tol, rtol = TOL[dtype]
    assert lse_err <= 1e-3, f"{name} {dtype}: lse error {lse_err}"
    rec = dict(phase="kernels", kernel="flash_attention", case=name,
               dtype=dtype, shape=[b, h, s, d], causal=causal, pads=pads,
               max_abs_err=err, tol=tol, rtol=rtol, lse_max_abs_err=lse_err)
    live_cols = mask > 0                                  # [B, S]
    if causal:
        per_row = torch.cumsum(live_cols.long(), dim=1)   # cols <= row
    else:
        per_row = live_cols.long().sum(1, keepdim=True).expand(b, s)
    pairs = float(per_row.sum().item()) * h
    # What the function must move: q only for rows with a live key, k and
    # v only for live columns, all of O and lse, the mask once.
    q_rows = int((per_row > 0).sum().item())
    kv_cols = int(live_cols.sum().item())
    elt = q.element_size()
    nbytes = (h * d * elt * (q_rows + 2 * kv_cols) + b * h * s * d * elt
              + b * h * s * 4 + b * s * 4)
    bms, by = bound(4.0 * d * pairs, nbytes, dtype)
    sdpa_mask = live_cols[:, None, None, :]
    if causal:
        sdpa_mask = sdpa_mask & torch.ones(
            (s, s), dtype=torch.bool, device="cuda").tril()
    rec.update(
        ms=time_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, causal, kv_mask=mask), flush=flush),
        plain_ms=time_ms(torch, lambda: fa.attention_plain(
            q, k, v, causal, mask), flush=flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask), flush=flush),
        bound_ms=bms, bound_by=by, flops=4.0 * d * pairs, bytes=nbytes)
    emit(rec)
    return rec


def decode_case(torch, fd, flush, *, name, b, hq, hkv, length, d, cur, pads,
                dtype):
    """flash_decode kernel vs plain on one seeded input, then the three
    times; returns the phase-b record."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(hq * 1000 + length)
    dt = getattr(torch, dtype)
    q = torch.randn((b, hq, 1, d), generator=g, device="cuda").to(dt)
    kc = torch.randn((b, hkv, length, d), generator=g, device="cuda").to(dt)
    vc = torch.randn((b, hkv, length, d), generator=g, device="cuda").to(dt)
    pad_t = None if pads is None else torch.tensor(pads, dtype=torch.int32,
                                                   device="cuda")
    cur_arg = cur if isinstance(cur, int) else torch.tensor(
        cur, dtype=torch.int32, device="cuda")
    o = fd.flash_decode(q, kc, vc, cur_arg, pad_t)
    o_ref = fd.flash_decode_plain(q, kc, vc, cur_arg, pad_t)
    torch.cuda.synchronize()
    err = check_close(o, o_ref, dtype, name)
    curs = [cur] * b if isinstance(cur, int) else list(cur)
    pl = [0] * b if pads is None else list(pads)
    live = [max(0, min(c, length) - p) for c, p in zip(curs, pl)]
    for r, n in enumerate(live):
        if n == 0:
            assert torch.all(o[r] == 0), f"{name}: empty row {r} is not 0"
    tol, rtol = TOL[dtype]
    rec = dict(phase="kernels", kernel="flash_decode", case=name,
               dtype=dtype, shape=[b, hq, hkv, length, d], cur=cur,
               pads=pads, live_slots=live, max_abs_err=err, tol=tol,
               rtol=rtol)
    elt = q.element_size()
    nbytes = 2 * hkv * d * elt * sum(live) + 2 * b * hq * d * elt
    flops = 4.0 * hq * d * sum(live)
    bms, by = bound(flops, nbytes, dtype)
    col = torch.arange(length, device="cuda")
    cur_t = torch.tensor(curs, device="cuda")
    pad_v = torch.tensor(pl, device="cuda")
    sdpa_mask = ((col[None] < cur_t[:, None])
                 & (col[None] >= pad_v[:, None]))[:, None, None, :]
    rec.update(
        ms=time_ms(torch, lambda: fd.flash_decode(q, kc, vc, cur_arg,
                                                  pad_t), flush=flush),
        plain_ms=time_ms(torch, lambda: fd.flash_decode_plain(
            q, kc, vc, cur_arg, pad_t), flush=flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kc, vc, attn_mask=sdpa_mask, enable_gqa=True),
            flush=flush),
        bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes)
    emit(rec)
    return rec


def paged_case(torch, pfd, flush, *, name, dtype, kv, s_q):
    """paged_flash_decode kernel vs plain on one seeded pool, then the
    three times; returns the phase-b record. ``kv``: "same" (pools in
    ``dtype``), "int8" or "fp8" (codes with a scale plane)."""
    import torch.nn.functional as F

    b, hq, hkv, d, bs, mb = 8, 16, 8, 128, PAGED_BS, PAGED_MB
    g = torch.Generator().manual_seed(1000 * s_q + len(kv))
    dt = getattr(torch, dtype)
    need = [0 if c == 0 else -(-min(c + s_q, mb * bs) // bs)
            for c in PAGED_CUR]
    spare = 64
    pool = 1 + sum(need) + spare
    ids = torch.randperm(pool - 1, generator=g) + 1
    dead = ids[sum(need):]
    tables = torch.zeros((b, mb), dtype=torch.int32)
    used = 0
    for r, n in enumerate(need):
        if n:  # a non-contiguous run of pool ids, then NaN blocks
            tables[r, :n] = ids[used:used + n].int()
            tables[r, n:] = int(dead[r % spare])
            used += n
    shape = (pool, hkv, bs, d)
    scales = None
    if kv == "same":
        kp, vp = (torch.randn(shape, generator=g).to(dt) for _ in range(2))
        kp[dead], vp[dead] = float("nan"), float("nan")
    else:
        code = torch.int8 if kv == "int8" else torch.float8_e4m3fn
        qmax = 127.0 if kv == "int8" else 448.0
        kp, vp = ((torch.rand(shape, generator=g) * 2 - 1) * qmax
                  for _ in range(2))
        kp, vp = kp.round().to(code), vp.round().to(code)
        scales = torch.rand((pool, hkv, 2), generator=g) * 0.02 + 1e-3
        scales[dead] = float("nan")
        if kv == "fp8":
            kp[dead], vp[dead] = float("nan"), float("nan")
    q = torch.randn((b, hq, s_q, d), generator=g).to(dt)
    cur_t = torch.tensor(PAGED_CUR, dtype=torch.int32)
    pad_t = torch.tensor(PAGED_PADS, dtype=torch.int32)
    q, kp, vp, tables, cur_t, pad_t = (
        t.to("cuda") for t in (q, kp, vp, tables, cur_t, pad_t))
    scales = None if scales is None else scales.to("cuda")
    args = (q, kp, vp, tables, cur_t, pad_t, scales)
    o = pfd.paged_flash_decode(*args)
    o_ref = pfd.paged_flash_decode_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all(), f"{name}: NaN reached the output"
    err = check_close(o, o_ref, dtype, name)
    # the parked slot attends position 0 of trash block 0: finite
    # garbage, not the all-masked zero output
    assert torch.any(o[7, :, 0] != 0), f"{name}: parked slot output is 0"

    # what the function must move: the K/V rows of the live positions
    # [pad, min(cur + S, MB·bs)) of each slot, the scale pair of each
    # live block those rows lie in, q and O; the operations of the live
    # (query, column) pairs
    length = mb * bs
    spans = [(p, min(c + s_q, length)) for c, p in zip(PAGED_CUR, PAGED_PADS)]
    rows = sum(max(0, e - p) for p, e in spans)
    blocks = sum(max(0, -(-e // bs) - p // bs) for p, e in spans)
    pairs = sum(max(0, min(c + i, length - 1) - p + 1)
                for c, p in zip(PAGED_CUR, PAGED_PADS) for i in range(s_q))
    nbytes = (2 * rows * hkv * d * kp.element_size()
              + (0 if scales is None else blocks * hkv * 2 * 4)
              + 2 * q.numel() * q.element_size())
    flops = 4.0 * d * hq * pairs
    bms, by = bound(flops, nbytes, dtype)
    # yardstick: SDPA over the PRE-GATHERED dense view, never-read
    # columns zeroed and masked (the gather itself is not timed)
    kv_k = pfd.gathered_view(kp, tables, scales, 0)
    kv_v = pfd.gathered_view(vp, tables, scales, 1)
    col = torch.arange(length, device="cuda")
    qpos = cur_t.long()[:, None] + torch.arange(s_q, device="cuda")
    pad_l = pad_t.long()
    read = ((col >= pad_l[:, None]) & (col < qpos[:, -1:] + 1))
    kv_k = torch.where(read[:, None, :, None], kv_k, 0.0).to(dt)
    kv_v = torch.where(read[:, None, :, None], kv_v, 0.0).to(dt)
    mask = ((col[None, None] <= qpos[..., None])
            & (col[None, None] >= pad_l[:, None, None]))[:, None]
    tol, rtol = TOL[dtype]
    rec = dict(phase="kernels", kernel="paged_flash_decode", case=name,
               dtype=dtype, kv=kv, s_q=s_q,
               shape=[b, hq, hkv, s_q, d, bs, mb, pool], cur=PAGED_CUR,
               pads=PAGED_PADS, live_rows=rows, blocks_touched=blocks,
               max_abs_err=err,
               tol=tol, rtol=rtol,
               ms=time_ms(torch, lambda: pfd.paged_flash_decode(*args),
                          flush=flush),
               plain_ms=time_ms(torch, lambda: pfd.paged_flash_decode_plain(
                   *args), flush=flush),
               library_ms=time_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       q, kv_k, kv_v, attn_mask=mask, enable_gqa=True),
                   flush=flush),
               library="SDPA on the pre-gathered dense view (excludes "
                       "the gather)",
               bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes)
    emit(rec)
    return rec


def phase_kernels(torch, fa, fd, pfd) -> dict:
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    b, s = len(PROMPT_LENS), PROMPT_LENS[0]
    main_pads = [s - n for n in PROMPT_LENS]           # [0, 548, 1348, 2015]
    length = s + NEW_TOKENS                             # the main path's cache
    main = {}
    for dtype in ("bfloat16", "float32"):
        rec = attention_case(torch, fa, flush, name="prefill", b=b, h=16,
                             s=s, d=128, causal=True, pads=main_pads,
                             dtype=dtype)
        if dtype == "bfloat16":  # the main path's dtype
            main["flash_attention"] = rec
        attention_case(torch, fa, flush, name="ragged_all_masked", b=4,
                       h=16, s=1000, d=128, causal=False,
                       pads=[0, 300, 999, 1000], dtype=dtype)
        rec = decode_case(torch, fd, flush, name="decode_step1", b=b, hq=16,
                          hkv=8, length=length, d=128, cur=s + 1,
                          pads=main_pads, dtype=dtype)
        if dtype == "bfloat16":
            main["flash_decode"] = rec
        decode_case(torch, fd, flush, name="per_row_cur", b=b, hq=16, hkv=8,
                    length=length, d=128, cur=[2049, 1700, 900, 40],
                    pads=[0, 548, 348, 7], dtype=dtype)
        decode_case(torch, fd, flush, name="llama3_8b_gqa", b=b, hq=32,
                    hkv=8, length=length, d=128, cur=s + 1, pads=None,
                    dtype=dtype)
        for kv in ("same", "int8", "fp8"):
            if kv != "same" and dtype == "float32":
                continue  # a quantized pool serves the bf16 model
            for s_q in (1, 5):
                rec = paged_case(torch, pfd, flush,
                                 name=f"paged_{kv}_s{s_q}", dtype=dtype,
                                 kv=kv, s_q=s_q)
                if dtype == "bfloat16" and kv == "same" and s_q == 1:
                    main["paged_flash_decode"] = rec
    del flush
    return main


def prompts(torch, cfg):
    from sparkdl_tpu_torch.models.llama import left_pad_prompts

    g = torch.Generator().manual_seed(1)
    toks = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
            for n in PROMPT_LENS]
    return left_pad_prompts(toks)


def phase_main(torch, fa, fd) -> dict:
    from sparkdl_tpu_torch.models import llama as L

    cfg = L.LlamaConfig.small()
    t0 = time.perf_counter()
    model = L.LlamaModel(cfg, dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids, pads = prompts(torch, cfg)
    L.generate(model, ids, 2, pad_lens=pads)  # warm-up: cuBLAS handles etc.
    dev_ids, dev_pads = ids.cuda(), pads.cuda()

    # The prefill and the decode loop are timed inside the one generate()
    # call below: generate() calls the module's _prefill and _decode, which
    # are wrapped here for that call only (host clock, device synced on
    # both sides, so each span holds its own device work).
    spans, outs = {}, {}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[name] = time.perf_counter() - t0
            return outs[name]
        return run

    real = L._prefill, L._decode
    L._prefill, L._decode = timed("prefill", real[0]), timed("decode", real[1])
    try:
        fa.flash_attention_fwd.launches = 0
        fd.flash_decode.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, steps = L.generate(model, ids, NEW_TOKENS, pad_lens=pads,
                                return_steps=True)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = {"flash_attention": fa.flash_attention_fwd.launches,
                    "flash_decode": fd.flash_decode.launches}
    finally:
        L._prefill, L._decode = real

    assert torch.isfinite(outs["prefill"]).all(), "prefill logits not finite"
    assert steps == NEW_TOKENS, f"decode ran {steps} steps"
    assert launches["flash_attention"] == cfg.num_layers, launches
    assert launches["flash_decode"] == cfg.num_layers * steps, launches
    assert out.shape == (len(PROMPT_LENS), ids.shape[1] + NEW_TOKENS)
    assert torch.equal(out[:, :ids.shape[1]].cpu(), ids), "prompt changed"
    new = out[:, ids.shape[1]:]
    assert int(new.min()) >= 0 and int(new.max()) < cfg.vocab_size
    prefill_ms = spans["prefill"] * 1e3
    decode_ms = spans["decode"] * 1e3 / steps
    rec = dict(phase="main_path", config="LlamaConfig.small", dtype="bfloat16",
               layers=cfg.num_layers, hidden=cfg.hidden_size,
               heads=[cfg.num_heads, cfg.num_kv_heads], head_dim=cfg.head_dim,
               vocab=cfg.vocab_size, prompt_lens=PROMPT_LENS,
               new_tokens=NEW_TOKENS, decode_steps=steps, launches=launches,
               init_s=init_s, generate_s=total_s, prefill_ms=prefill_ms,
               decode_ms_per_step=decode_ms,
               rest_ms=(total_s - spans["prefill"] - spans["decode"]) * 1e3,
               new_tokens_per_s=len(PROMPT_LENS) * steps / total_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               first_new_tokens=new[:, :4].tolist())
    emit(rec)
    emit(profile_decode(torch, L, model, dev_ids, dev_pads))
    del model
    torch.cuda.empty_cache()
    return rec


def device_profile(torch, step, steps: int, window: str) -> dict:
    """Where ``steps`` calls of ``step`` spend their time:
    ``torch.profiler`` device busy share of the wall time and the kernels
    that take it. Reports "not measured" when the profiler sees no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for ev in prof.events():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(ev.name, [0, 0.0])
            kernels[ev.name][0] += 1
            kernels[ev.name][1] += ev.device_time_total \
                if hasattr(ev, "device_time_total") else ev.cuda_time_total
    busy_us = sum(t for _, t in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(
        phase="profile", window=window,
        wall_ms_per_step=wall_us / steps / 1e3,
        device_busy_ms_per_step=(busy_us / steps / 1e3) if busy_us
        else "not measured",
        device_idle_share=(1 - busy_us / wall_us) if busy_us
        else "not measured",
        device_launches_per_step=sum(n for n, _ in kernels.values()) / steps,
        top_kernels=[dict(name=n[:80], launches=c, us=t)
                     for n, (c, t) in top])


def profile_decode(torch, L, model, ids, pads, steps: int = 4) -> dict:
    """Where a decode step of ``generate()`` spends its time, over
    ``steps`` steps after a prefill."""
    cache = L.init_cache(model, ids.shape[0], ids.shape[1] + steps + 1)
    tok = [L._prefill(model, ids, cache, pads).argmax(-1)]

    def step():
        tok[0] = L._decode_step(model, cache, tok[0], pads).argmax(-1)
    return device_profile(torch, step, steps,
                          f"{steps} decode steps, small bf16")


def phase_parity(torch) -> dict:
    from sparkdl_tpu_torch.models import llama as L

    cfg = L.LlamaConfig.small()
    model = L.LlamaModel(cfg, dtype=torch.float32, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    ids, pads = prompts(torch, cfg)
    ids, pads = ids.cuda(), pads.cuda()
    max_len = ids.shape[1] + PARITY_TOKENS

    def run(tokens=None):
        """Logits at the prefill's last position and at each decode
        step; greedy tokens when ``tokens`` is None, else ``tokens`` fed."""
        cache = L.init_cache(model, ids.shape[0], max_len)
        logits = [L._prefill(model, ids, cache, pads)]
        fed = []
        for i in range(PARITY_TOKENS - 1):
            tok = logits[-1].argmax(-1) if tokens is None else tokens[i]
            fed.append(tok)
            logits.append(L._decode_step(model, cache, tok, pads))
        return torch.stack(logits, 1), fed

    assert L.resolve_attn_fn(model.attn_fn) is not None
    kern, toks = run()
    model.attn_fn = None  # the dense in-model path
    dense, _ = run(toks)
    err = (kern - dense).abs().max().item()
    scale = dense.abs().max().item()
    agree = float((kern.argmax(-1) == dense.argmax(-1)).float().mean())
    assert torch.isfinite(kern).all() and torch.isfinite(dense).all()
    assert err <= LOGIT_TOL, f"logits: kernel vs dense {err} > {LOGIT_TOL}"
    rec = dict(phase="parity", config="LlamaConfig.small", dtype="float32",
               tf32=False, positions=PARITY_TOKENS,
               max_abs_logit_err=err, tol=LOGIT_TOL, max_abs_logit=scale,
               argmax_agreement=agree)
    emit(rec)
    return rec


def serve_prompts(torch, cfg, lens, seed, shared=(), head_len=512,
                  repeat=None):
    """Seeded prompts of ``lens`` tokens; those at indices ``shared`` start
    with one common ``head_len``-token head; ``repeat`` n makes every
    prompt a cycle of an n-token phrase (n-gram drafts find matches)."""
    g = torch.Generator().manual_seed(seed)

    def rand(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()

    head = rand(head_len)
    out = []
    for i, n in enumerate(lens):
        if repeat:
            phrase = rand(repeat)
            p = (phrase * (n // repeat + 1))[:n]
        elif i in shared:
            p = head + rand(n - head_len)
        else:
            p = rand(n)
        out.append(p)
    return out


def reset_counts(fa, fd, pfd) -> None:
    fa.flash_attention_fwd.launches = 0
    fd.flash_decode.launches = 0
    pfd.paged_flash_decode.launches = 0


def read_counts(fa, fd, pfd) -> dict:
    return {"flash_attention": fa.flash_attention_fwd.launches,
            "flash_decode": fd.flash_decode.launches,
            "paged_flash_decode": pfd.paged_flash_decode.launches}


def serve_leg(torch, model, kernels, *, leg, prompts, **kw) -> tuple:
    """One fresh engine serving ``prompts`` (all submitted at once) to the
    end; the launch counters are set to 0 just before and read just
    after. Returns the leg's record and the engine."""
    from sparkdl_tpu_torch import GenerationEngine

    eng = GenerationEngine.from_model(model, num_slots=8, max_len=2048,
                                      device="cuda", **kw)
    iter_s = []
    for attr in ("step", "verify"):  # time each decode iteration
        fn = getattr(eng.backend, attr)

        def timed(*a, _fn=fn, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)  # returns host tokens: the device is done
            iter_s.append(time.perf_counter() - t0)
            return out
        setattr(eng.backend, attr, timed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    hs = [eng.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(*kernels)
    outs = [h.result(1) for h in hs]
    ttft = sorted(h.t_first_token - h.t_submit for h in hs)
    st = eng.stats
    new = sum(len(o) for o in outs)
    for o in outs:
        assert len(o) == SERVE_NEW and 0 <= min(o) and max(o) < \
            model.cfg.vocab_size, f"{leg}: bad stream {o[:8]}"
    rec = dict(phase="serve", leg=leg, config="LlamaConfig.small",
               dtype="bfloat16", layers=model.cfg.num_layers,
               engine={k: v for k, v in kw.items()}, num_slots=8,
               max_len=2048, requests=len(prompts),
               completed=st["completed"],
               prompt_lens=[len(p) for p in prompts], new_tokens=new,
               wall_s=wall, new_tokens_per_s=new / wall,
               ttft_p50_s=ttft[len(ttft) // 2],
               ttft_p95_s=ttft[max(0, -(-95 * len(ttft) // 100) - 1)],
               decode_iterations=len(iter_s),
               decode_iter_ms_mean=1e3 * sum(iter_s) / max(len(iter_s), 1),
               steps=st["steps"], prefills=st["prefills"],
               prefill_chunks=st["prefill_chunks"],
               preemptions=st["preemptions"],
               spec_verifies=st["spec_verifies"],
               spec_tokens_accepted=st["spec_tokens_accepted"],
               prefix=eng.backend.prefix_stats(), launches=launches,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    assert st["completed"] == len(prompts), rec
    return rec, eng


def profile_serve(torch, eng, cfg, steps: int = 4) -> dict:
    """Where a paged engine iteration spends its time once all 8 slots
    decode: 8 requests of 64-token prompts are prefilled (one chunk an
    iteration), then ``steps`` decode-only iterations are profiled."""
    for p in serve_prompts(torch, cfg, [64] * 8, 9):
        eng.submit(p, max_new_tokens=SERVE_NEW)
    for _ in range(10):  # 8 one-chunk prefills, then decoding
        eng.step()
    rec = device_profile(torch, eng.step, steps,
                         f"{steps} paged engine iterations, 8 slots "
                         f"decoding, small bf16")
    eng.run_until_idle()
    return rec


def phase_serve(torch, kernels) -> dict:
    from sparkdl_tpu_torch.models import llama as L

    cfg = L.LlamaConfig.small()
    nl = cfg.num_layers
    model = L.LlamaModel(cfg, dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    paged = dict(block_size=16, prefill_chunk=256)
    # warm-up (cuBLAS handles, allocator), outside every counted leg
    warm, _ = serve_leg(torch, model, kernels, leg="warm-up",
                        prompts=[[1, 2, 3] * 20], **paged)
    del warm
    g = torch.Generator().manual_seed(3)
    lens = torch.randint(32, 1537, (12,), generator=g).tolist()
    shared = (0, 9, 10, 11)  # 9-11 queue behind 0's committed prefix
    for i in shared:
        lens[i] = max(lens[i], 600)
    legs = {}

    rec, eng = serve_leg(torch, model, kernels, leg="paged",
                         prompts=serve_prompts(torch, cfg, lens, 4, shared),
                         **paged)
    hits = (rec["prefix"] or {}).get("hits", 0)
    assert rec["launches"]["paged_flash_decode"] == nl * rec["steps"], rec
    assert rec["launches"]["flash_decode"] == 0, rec
    assert hits >= 1, f"no radix graft in the paged leg: {rec['prefix']}"
    emit(rec)
    legs["paged"] = rec
    emit(profile_serve(torch, eng, cfg))
    del eng

    rec, eng = serve_leg(
        torch, model, kernels, leg="speculative", spec_k=4,
        prompts=serve_prompts(torch, cfg, [700, 400, 260, 96], 5,
                              repeat=24), **paged)
    assert rec["spec_verifies"] >= 1, rec
    assert rec["launches"]["paged_flash_decode"] == nl * rec["steps"], rec
    emit(rec)
    legs["speculative"] = rec
    del eng

    rec, eng = serve_leg(torch, model, kernels, leg="int8_kv",
                         kv_dtype="int8",
                         prompts=serve_prompts(torch, cfg,
                                               [700, 300, 1200, 64], 6),
                         **paged)
    assert eng.backend.cache.k[0].dtype == torch.int8
    assert rec["launches"]["paged_flash_decode"] == nl * rec["steps"] > 0, \
        rec  # every launch read int8 codes: the pool holds nothing else
    emit(rec)
    legs["int8_kv"] = rec
    del eng

    rec, eng = serve_leg(torch, model, kernels, leg="unpaged_blocking",
                         block_size=0, stall_free=False,
                         prompts=serve_prompts(torch, cfg,
                                               [900, 500, 200, 40], 7))
    assert rec["launches"]["flash_attention"] == nl * rec["prefills"], rec
    assert rec["launches"]["flash_decode"] == nl * rec["steps"], rec
    assert rec["launches"]["paged_flash_decode"] == 0, rec
    emit(rec)
    legs["unpaged_blocking"] = rec
    del eng, model
    torch.cuda.empty_cache()
    return legs


def phase_serve_parity(torch, kernels) -> dict:
    from sparkdl_tpu_torch import GenerationEngine
    from sparkdl_tpu_torch.models import llama as L

    cfg = L.LlamaConfig.small()
    model = L.LlamaModel(cfg, dtype=torch.float32, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    prompts = serve_prompts(torch, cfg, [600, 300, 90, 33], 8)
    new = PARITY_TOKENS
    ids, pads = L.left_pad_prompts(prompts)
    out = L.generate(model, ids, new, pad_lens=pads)
    refs = [out[i, ids.shape[1]:].tolist() for i in range(len(prompts))]
    eng = GenerationEngine.from_model(model, num_slots=4, max_len=1024,
                                      block_size=16, prefill_chunk=256,
                                      device="cuda")
    reset_counts(*kernels)
    hs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.run_until_idle()
    launches = read_counts(*kernels)
    got = [h.result(1) for h in hs]
    assert launches["paged_flash_decode"] == \
        cfg.num_layers * eng.stats["steps"] > 0, launches
    # top-2 logit gaps at every generated position, from one dense
    # forward over each finished engine sequence
    model.attn_fn = None
    gate = 10 * LOGIT_TOL
    near_ties, min_gap, identical = [], float("inf"), 0
    with torch.no_grad():
        for r, (p, stream, ref) in enumerate(zip(prompts, got, refs)):
            seq = torch.tensor([p + stream], device="cuda")
            logits = model(seq)[0, len(p) - 1:len(p) - 1 + new]
            top2 = logits.topk(2, dim=-1).values
            gaps = (top2[:, 0] - top2[:, 1]).tolist()
            min_gap = min(min_gap, min(gaps))
            flip = next((j for j in range(new) if stream[j] != ref[j]),
                        None)
            if flip is None:
                identical += 1
                continue
            assert gaps[flip] <= gate, (
                f"request {r}: engine and generate() differ at position "
                f"{flip} with a top-2 gap of {gaps[flip]} > {gate}")
            near_ties.append(dict(request=r, position=flip,
                                  gap=gaps[flip]))
    rec = dict(phase="serve_parity", config="LlamaConfig.small",
               dtype="float32", tf32=False, layers=cfg.num_layers,
               depth_cut=False, prompt_lens=[len(p) for p in prompts],
               new_tokens=new, engine="paged, block 16, 256-token chunks",
               reference="generate() through the flash kernels",
               identical_streams=identical, requests=len(prompts),
               near_tie_gate=gate, near_ties=near_ties,
               min_top2_gap=min_gap, launches=launches)
    emit(rec)
    del eng, model
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "sparkdl_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no sparkdl_tpu_torch/ package; run "
              f"it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sparkdl_tpu_torch.ops import _build
    from sparkdl_tpu_torch.ops import flash_attention as fa
    from sparkdl_tpu_torch.ops import flash_decode as fd
    from sparkdl_tpu_torch.ops import paged_flash_decode as pfd

    phase_build(_build)
    main_recs = phase_kernels(torch, fa, fd, pfd)
    mp = phase_main(torch, fa, fd)
    phase_parity(torch)
    legs = phase_serve(torch, (fa, fd, pfd))
    phase_serve_parity(torch, (fa, fd, pfd))

    # each kernel's launches come from the main path that runs it:
    # generate() (phase c) for the first two, the paged serve leg for B3
    sources = {
        "flash_attention": ("sparkdl_tpu_torch/csrc/flash_attention.cu",
                            "sparkdl_tpu/ops/flash_attention.py:50",
                            mp["launches"]),
        "flash_decode": ("sparkdl_tpu_torch/csrc/flash_decode.cu",
                         "sparkdl_tpu/ops/flash_decode.py:62",
                         mp["launches"]),
        "paged_flash_decode": (
            "sparkdl_tpu_torch/csrc/paged_flash_decode.cu",
            "sparkdl_tpu/ops/paged_flash_decode.py:63",
            legs["paged"]["launches"]),
    }
    kernels = []
    for name, (src, replaces, counts) in sources.items():
        r = main_recs[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts[name], max_abs_err=r["max_abs_err"],
            tol=r["tol"], rtol=r["rtol"], case=r["case"], dtype=r["dtype"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
