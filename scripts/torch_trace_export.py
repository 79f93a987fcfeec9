#!/usr/bin/env python
"""Export a merged Chrome-trace timeline from observability artifacts.

One command turns a run's scattered evidence — per-rank
``events_rank*.jsonl`` span streams (``gang-*/`` subdirs included), the
supervisor's ``trace_manifest.json`` span tree, telemetry snapshot
histories (gauge/counter tracks), and request traces — into ONE
Chrome trace-event JSON loadable in Perfetto (https://ui.perfetto.dev)
or ``chrome://tracing``. Cross-rank clock skew is measured from
heartbeat bodies when a heartbeat dir is given, and annotated in
``otherData.clock_skew`` either way — unmeasured skew says so
explicitly, it never silently reads as zero.

Usage:
    python scripts/torch_trace_export.py EVENT_DIR [--metrics-dir DIR]
        [--heartbeat-dir DIR] [--out FILE] [--validate]
        [--require-ranks N] [--require-requests N] [--require-counters]

Prints one JSON summary line (path, event counts, validation verdict).
Exit codes: 0 = exported (and validated, if asked); 1 = validation
failed; 2 = no events found under EVENT_DIR.
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
from sparkdl_tpu_torch.runner import traceview  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Merge flight-recorder streams, telemetry histories "
                    "and request traces into one Perfetto-loadable "
                    "Chrome trace")
    ap.add_argument("event_dir",
                    help="directory of events_rank*.jsonl streams "
                         "(SPARKDL_EVENT_DIR; gang-*/ subdirs included)")
    ap.add_argument("--metrics-dir", default=None,
                    help="SPARKDL_METRICS_DIR with metrics_rank*.jsonl "
                         "histories -> counter tracks")
    ap.add_argument("--heartbeat-dir", default=None,
                    help="SPARKDL_HEARTBEAT_DIR with rank*.hb beats -> "
                         "per-rank clock-skew annotation")
    ap.add_argument("--out", default=None,
                    help="output path (default EVENT_DIR/trace.json)")
    ap.add_argument("--validate", action="store_true",
                    help="run structural validation and fail (exit 1) "
                         "on problems")
    ap.add_argument("--require-ranks", type=int, default=1,
                    help="--validate: spans must cover >= N ranks "
                         "(default 1)")
    ap.add_argument("--require-requests", type=int, default=0,
                    help="--validate: >= N request tracks (default 0)")
    ap.add_argument("--require-counters", action="store_true",
                    help="--validate: demand gauge/counter tracks")
    ns = ap.parse_args(argv)

    trace = traceview.chrome_trace(ns.event_dir,
                                   metrics_dir=ns.metrics_dir,
                                   heartbeat_dir=ns.heartbeat_dir)
    other = trace["otherData"]
    if not other["spans"] and not other["instants"]:
        print(f"torch_trace_export: no events under {ns.event_dir}",
              file=sys.stderr)
        return 2
    out_path = ns.out or os.path.join(ns.event_dir, "trace.json")
    traceview.write_chrome_trace(out_path, trace)

    summary = {"out": os.path.abspath(out_path),
               "trace_id": other["trace_id"],
               "events": len(trace["traceEvents"]),
               "spans": other["spans"], "instants": other["instants"],
               "requests": other["requests"],
               "clock_skew": other["clock_skew"]}
    rc = 0
    if ns.validate:
        verdict = traceview.validate_chrome_trace(
            trace, require_ranks=ns.require_ranks,
            require_requests=ns.require_requests,
            require_counters=ns.require_counters)
        summary["validation"] = verdict
        rc = 0 if verdict["ok"] else 1
    print(json.dumps(summary, default=str))
    return rc


if __name__ == "__main__":
    sys.exit(main())
