"""What one message of a started tensor-parallel engine's control channel
costs the host (``serving.group``): the per-call time of the gloo
collectives the front issues at an iteration boundary, on a one-rank
gang of this machine (NCCL on the card, gloo without one), beside the
threads a started engine runs.

Arms, each ``--calls`` calls after 50 warm-up calls: ``all_reduce`` of
the front's float64 header (5 values, the common boundary), the same
with ``--clients`` client threads blocked on events (a started engine's
clients waiting for their results), with one thread polling in Python
(``time.sleep(0.001)`` in a loop, as a caller watching a stream does),
and a ``broadcast`` of a 4 KiB payload (a message that carries
admissions). Prints one JSON line: per arm the p50, p95 and max µs of a
call, and ``nvidia-smi``'s name and power limit where there is a card.

Usage: ``python scripts/torch_control_channel_bench.py [--calls N]
[--clients K]``
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def timed(fn, calls: int) -> dict:
    for _ in range(50):
        fn()
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e6)
    out.sort()
    return {"p50_us": out[len(out) // 2],
            "p95_us": out[int(0.95 * len(out))], "max_us": out[-1]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--clients", type=int, default=4)
    args = ap.parse_args()

    from sparkdl_tpu_torch.runner import XlaRunner, launcher
    from sparkdl_tpu_torch.runner.xla_runner import leave_gang
    from sparkdl_tpu_torch.serving.backend import tp_mesh
    from sparkdl_tpu_torch.serving.group import control_group

    cuda = torch.cuda.is_available()
    runner = XlaRunner(device="cuda" if cuda else "cpu", num_processes=1,
                       process_id=0,
                       coordinator=f"127.0.0.1:{launcher.free_port()}")
    rec = {"gang": runner.gang.backend, "calls": args.calls, "arms": {}}
    try:
        group = control_group(tp_mesh(1))

        def header():
            t = torch.tensor([1.0, 0.0, time.time(), 0.0, 0.0],
                             dtype=torch.float64)
            dist.all_reduce(t, group=group)

        payload = torch.zeros(4096, dtype=torch.uint8)
        rec["arms"]["all_reduce_header"] = timed(header, args.calls)
        stop = threading.Event()
        waiters = [threading.Thread(target=stop.wait)
                   for _ in range(args.clients)]
        for t in waiters:
            t.start()
        rec["arms"]["with_blocked_clients"] = timed(header, args.calls)

        def poll():
            while not stop.is_set():
                time.sleep(0.001)
        poller = threading.Thread(target=poll)
        poller.start()
        rec["arms"]["with_a_polling_thread"] = timed(header, args.calls)
        stop.set()
        for t in [*waiters, poller]:
            t.join()
        rec["arms"]["broadcast_4kib_payload"] = timed(
            lambda: dist.broadcast(payload, src=0, group=group), args.calls)
    finally:
        leave_gang()
    if cuda:
        rec["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
