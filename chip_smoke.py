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


def phase_build(_build) -> dict:
    t0 = time.perf_counter()
    _build.library()
    info = dict(phase="build", seconds=time.perf_counter() - t0,
                nvcc_seconds=_build.build_info.get("seconds"),
                library=Path(_build.build_info["library"]).name,
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


def phase_kernels(torch, fa, fd) -> dict:
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


def profile_decode(torch, L, model, ids, pads, steps: int = 4) -> dict:
    """Where a decode step's time goes: ``torch.profiler`` over ``steps``
    decode steps after a prefill — device busy share of the wall time and
    the kernels that take it. Reports "not measured" when the profiler
    sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    cache = L.init_cache(model, ids.shape[0], ids.shape[1] + steps + 1)
    tok = L._prefill(model, ids, cache, pads).argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = L._decode_step(model, cache, tok, pads).argmax(-1)
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
        phase="profile", window=f"{steps} decode steps, small bf16",
        wall_ms_per_step=wall_us / steps / 1e3,
        device_busy_ms_per_step=(busy_us / steps / 1e3) if busy_us
        else "not measured",
        device_idle_share=(1 - busy_us / wall_us) if busy_us
        else "not measured",
        device_launches_per_step=sum(n for n, _ in kernels.values()) / steps,
        top_kernels=[dict(name=n[:80], launches=c, us=t)
                     for n, (c, t) in top])


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

    phase_build(_build)
    main_recs = phase_kernels(torch, fa, fd)
    mp = phase_main(torch, fa, fd)
    phase_parity(torch)

    sources = {
        "flash_attention": ("sparkdl_tpu_torch/csrc/flash_attention.cu",
                            "sparkdl_tpu/ops/flash_attention.py:50"),
        "flash_decode": ("sparkdl_tpu_torch/csrc/flash_decode.cu",
                         "sparkdl_tpu/ops/flash_decode.py:62"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = main_recs[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=mp["launches"][name], max_abs_err=r["max_abs_err"],
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
