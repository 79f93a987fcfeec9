#!/usr/bin/env python3
"""Time the port's split-KV decode kernels at several split plans, or the
decode kernels of another checkout, on one CUDA card.

Run from the root of a checkout::

    python3 scripts/torch_decode_chunk_sweep.py [--variants 256:2 128:1 ...]
    python3 scripts/torch_decode_chunk_sweep.py --checkout DIR

A variant ``C:R`` is the split plan of ``ops/flash_decode.split_plan``
with ``SPLIT_CHUNK = C`` positions a split and ``MAX_ROWS = R`` query
rows a block (1 or 2, what the kernel is built for); the wrappers hand
the plan to the kernel, so no variant needs a rebuild. With
``--checkout DIR``, the package ``DIR/sparkdl_tpu_torch`` (another
commit, unpacked with ``git archive``) is timed instead, at its own
plan; the inputs (``chip_smoke.decode_inputs`` / ``paged_inputs``) and
the timing (``chip_smoke.time_ms``) stay this checkout's, so two commits
compare like for like.

Times the main path's bf16 decode cases of ``chip_smoke.py``
(``decode_step1``, ``llama3_8b_gqa``, ``paged_same_s1``,
``paged_same_s5``, ``paged_int8_s1``), the variants in turns, for
``--rounds`` rounds. Each case is checked against its plain version as in
``chip_smoke.py``. Prints one JSON line per (round, variant, case), then
a summary line with the least time of each (variant, case), the decode
kernels' ptxas spills, the build's seconds and the card's name and power
limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+",
                    default=["256:2", "128:2", "64:2", "512:2", "256:1",
                             "128:1"])
    ap.add_argument("--checkout", type=Path, default=None,
                    help="time the package of this checkout at its own "
                         "plan instead")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # before the other checkout goes on the path

    pkg_root = (args.checkout or ROOT).resolve()
    sys.path.insert(0, str(pkg_root))
    from sparkdl_tpu_torch.ops import _build
    from sparkdl_tpu_torch.ops import flash_decode as fd
    from sparkdl_tpu_torch.ops import paged_flash_decode as pfd

    assert Path(fd.__file__).resolve().is_relative_to(pkg_root), fd.__file__
    _build.library()
    ptxas = cs.ptxas_summary(_build.build_info.get("log"))
    variants = ["default"] if args.checkout else args.variants
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    b, s = len(cs.PROMPT_LENS), cs.PROMPT_LENS[0]
    pads = [s - n for n in cs.PROMPT_LENS]
    length = s + cs.NEW_TOKENS

    def decode(hq):
        x = cs.decode_inputs(torch, b=b, hq=hq, hkv=8, length=length, d=128,
                             cur=s + 1, pads=pads if hq == 16 else None,
                             dtype="bfloat16")
        return fd.flash_decode, fd.flash_decode_plain, x, (length, hq // 8)

    def paged(kv, s_q):
        x = cs.paged_inputs(torch, dtype="bfloat16", kv=kv, s_q=s_q)
        return (pfd.paged_flash_decode, pfd.paged_flash_decode_plain, x,
                (cs.PAGED_MB * cs.PAGED_BS, s_q * 2))

    cases = {"decode_step1": lambda: decode(16),
             "llama3_8b_gqa": lambda: decode(32),
             "paged_same_s1": lambda: paged("same", 1),
             "paged_same_s5": lambda: paged("same", 5),
             "paged_int8_s1": lambda: paged("int8", 1)}
    best: dict = {}
    for rnd in range(args.rounds):
        for var in variants:
            if var != "default":
                chunk, rows = (int(x) for x in var.split(":"))
                fd.SPLIT_CHUNK, fd.MAX_ROWS = chunk, rows
            for name, make in cases.items():
                kernel, plain, x, (npos, rows_q) = make()
                out = kernel(*x)
                err = cs.check_close(out, plain(*x), "bfloat16", name)
                ms = cs.time_ms(torch, lambda: kernel(*x), flush=flush)
                rec = dict(phase="chunk_sweep", round=rnd, variant=var,
                           case=name, ms=ms, max_abs_err=err,
                           checkout=str(args.checkout or "."))
                if var != "default":
                    rt, c, n = fd.split_plan(npos, rows_q)
                    rec.update(rows_per_block=rt, chunk=c, n_splits=n)
                cs.emit(rec)
                key = f"{name}@{var}"
                best[key] = min(best.get(key, float("inf")), ms)
                del x, out
    cs.emit(dict(phase="chunk_sweep_summary",
                 checkout=str(args.checkout or "."), least_ms=best,
                 ptxas=ptxas if isinstance(ptxas, str) else dict(
                     decode_splitkv=ptxas.get("decode_splitkv"),
                     spilling=ptxas["spilling"]),
                 build_s=_build.build_info.get("seconds"),
                 nvidia_smi=cs.smi()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
