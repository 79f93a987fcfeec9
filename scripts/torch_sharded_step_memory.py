"""Peak device memory and step time of the FSDP×TP train step on one card,
with the products of gathered weights through ``parallel.fsdp.linear``
(the shard kept for the backward, the weight gathered again there) and
with plain ``F.linear`` of the gathered weight (which keeps every gathered
weight from the forward to the backward).

Llama at ``LlamaConfig.llama3_8b()`` widths, depth ``--layers``, bf16,
full-parameter ``sgd(1e-3)``, one batch of ``--batch`` x ``--seq`` seeded
ids, ``--steps`` steps an arm, on a one-rank NCCL gang: the unsharded step,
then the sharded step (``models.llama.shard_model`` on ``{"data": 1,
"model": 1}``, ``make_train_step(mesh=)``) with each product, in turns
(unsharded, regather, held, held, regather, unsharded), each arm's model
freed before the next. One JSON line an arm: step ms, peak GB (the peak
counter reset before the model is built); with ``--profile``, the
profiler's top device ops of one more step. The card's name and power
limit come first.

Usage: python scripts/torch_sharded_step_memory.py [--layers 4]
       [--steps 6] [--batch 2] [--seq 2048] [--profile]
Exits 2 without a CUDA device.
"""

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def top_ops(prof, n: int = 16) -> list:
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        rows.append((t / 1e3, e.key[:70], e.count))
    return sorted(rows, reverse=True)[:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from sparkdl_tpu_torch.core.runtime import make_mesh
    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.runner import XlaRunner, launcher
    from sparkdl_tpu_torch.runner.train_state import (TrainState,
                                                      make_train_step, sgd)
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    regather = L.linear

    def held(x, w, dtype=None):
        return F.linear(x, w.to(w.dtype if dtype is None else dtype))

    cfg = dataclasses.replace(L.LlamaConfig.llama3_8b(),
                              num_layers=args.layers)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.seq)), device="cuda")
    XlaRunner(device="cuda", num_processes=1, process_id=0,
              coordinator=f"127.0.0.1:{launcher.free_port()}")
    try:
        mesh = make_mesh({"data": 1, "model": 1})
        for arm in ("unsharded", "regather", "held", "held", "regather",
                    "unsharded"):
            L.linear = held if arm == "held" else regather
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            model = L.LlamaModel(cfg, dtype=torch.bfloat16, device="cuda",
                                 generator=torch.Generator(device="cuda")
                                 .manual_seed(0))
            if arm == "unsharded":
                step = make_train_step(L.causal_lm_loss_fn())
            else:
                model = L.shard_model(model, mesh)
                step = make_train_step(L.causal_lm_loss_fn(), mesh=mesh,
                                       param_rules=L.training_rules(mesh))
            state = TrainState.create(model, sgd(1e-3))
            del model
            ms = []
            for _ in range(args.steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(step(state, {"input_ids": ids})[1]["loss"])
                ms.append((time.perf_counter() - t0) * 1e3)
            rec = {"arm": arm, "step_ms": ms,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            if args.profile:
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    float(step(state, {"input_ids": ids})[1]["loss"])
                    torch.cuda.synchronize()
                rec["top_device_ms"] = top_ops(prof)
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
            print(json.dumps(rec), flush=True)
    finally:
        L.linear = regather
        leave_gang()
    return 0


if __name__ == "__main__":
    sys.exit(main())
