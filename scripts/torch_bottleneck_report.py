#!/usr/bin/env python
"""Bottleneck attribution report over flight-recorder span streams and
telemetry snapshots.

Consumes the per-rank ``events_rank{i}.jsonl`` streams a run left under
``SPARKDL_EVENT_DIR`` (supervised gangs stream one level down in
``gang-*/`` subdirs — picked up automatically) and prints a per-stage
utilization table: busy seconds, wall-busy fraction, exclusive time,
achieved parallelism, rows and bytes moved — then names the dominant
stage with the Amdahl-style projection ("decode 94% busy → ≤1.06x from
fixing anything else"). With ``--metrics-dir`` it also prints the
gang-level aggregate of the live telemetry snapshots
(``metrics_rank{i}.json``, written by ``SPARKDL_METRICS_DIR`` runs).

Usage:
    python scripts/torch_bottleneck_report.py EVENT_DIR [--metrics-dir DIR]
        [--json]

Exit codes: 0 = report printed; 2 = no span evidence found.
"""

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

# The readers are stdlib-only; the package import pulls torch into the
# interpreter (inert: nothing here queries or initializes a CUDA device,
# so the script runs beside a gang that holds the card).
from sparkdl_tpu_torch.runner import analysis, telemetry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-stage utilization + bottleneck attribution from "
                    "flight-recorder span streams")
    ap.add_argument("event_dir",
                    help="directory of events_rank*.jsonl streams "
                         "(SPARKDL_EVENT_DIR; gang-*/ subdirs included)")
    ap.add_argument("--metrics-dir", default=None,
                    help="directory of metrics_rank*.json telemetry "
                         "snapshots (SPARKDL_METRICS_DIR) to aggregate "
                         "alongside")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON object instead "
                         "of the table")
    ns = ap.parse_args(argv)

    recs = analysis.load_event_dir(ns.event_dir)
    rep = analysis.analyze(events=recs) if recs else None
    # When the stream holds serve_* spans, the stage table is
    # not the whole story — append the request-trace tail (slowest
    # requests, phase-attributed) and the SLO compliance block so the
    # report states compliance, not just percentiles.
    req = analysis.request_summary(recs) if recs else None
    agg = telemetry.aggregate_snapshots(ns.metrics_dir) \
        if ns.metrics_dir else None
    if rep is None and agg is None:
        print(f"torch_bottleneck_report: no span streams or snapshots under "
              f"{ns.event_dir}"
              + (f" / {ns.metrics_dir}" if ns.metrics_dir else ""),
              file=sys.stderr)
        return 2

    if ns.json:
        print(json.dumps({"report": rep, "gang_metrics": agg,
                          "requests": req}, default=str))
        return 0
    if rep is not None:
        print(analysis.format_report(rep))
    if agg is not None:
        print(f"\ngang telemetry ({agg['n_ranks']} rank(s), elapsed "
              f"{agg['elapsed_s']:.3f}s):")
        for name, st in sorted(agg["stages"].items(),
                               key=lambda kv: -kv[1]["busy_frac"]):
            print(f"  {name}: busy {st['busy_s']:.3f}s "
                  f"({100 * st['busy_frac']:.1f}% of gang rank-time), "
                  f"rows {st['rows']}, "
                  f"max_concurrency {st['max_concurrency']}")
        for name, n in sorted((agg.get("events") or {}).items()):
            print(f"  event {name}: {n}")
        for name, g in sorted((agg.get("gauges") or {}).items()):
            # Pool gauges make an HBM-bound engine attributable: a
            # serving_kv_blocks_free floor near 0 with admission waits
            # in the engine stats IS the bottleneck, no span needed.
            print(f"  gauge {name}: {g.get('value', 0):g} "
                  f"(high-water {g.get('max', 0):g})")
        for name, h in sorted((agg.get("histograms") or {}).items()):
            # One derivation for everyone: telemetry.histogram_quantile
            # is the same helper the serving bench uses, so a latency
            # percentile printed here can never disagree with the bench
            # on the same snapshot.
            qs = {q: telemetry.histogram_quantile(h, q)
                  for q in (0.5, 0.95, 0.99)}
            if qs[0.5] is None:
                continue
            print(f"  {name}: p50 {qs[0.5]:.4g}s  p95 {qs[0.95]:.4g}s  "
                  f"p99 {qs[0.99]:.4g}s  (n={h.get('count', 0)}, "
                  f"bucket-resolution)")
        spec = (agg.get("histograms") or {}).get("serve_spec_accept_len")
        if spec and spec.get("count"):
            # The speculative-decode observable: tokens committed per
            # verify window (1 = drafts never accepted = the k=0
            # economics; k+1 = every draft accepted). A dispatch-bound
            # engine's tokens/s scales with this mean.
            print(f"  speculation: mean accepted length "
                  f"{spec['sum'] / spec['count']:.2f} tokens/verify "
                  f"(n={spec['count']} verify windows)")
    if req is not None:
        print()
        print(analysis.format_request_summary(req))
        print("(per-request detail: scripts/torch_request_report.py "
              f"{ns.event_dir})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
