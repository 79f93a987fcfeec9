#!/usr/bin/env python
"""Tail-latency explainer over flight-recorder span streams.

``torch_bottleneck_report.py`` answers "which *stage* is the
bottleneck"; this report answers "why was request X slow": it
re-assembles the serving engine's per-request ``serve_*`` spans (the
SAME fold the live ``telemetry.RequestTraceCollector`` runs — they
cannot drift) from an event dir into one trace per request, prints
exact latency/TTFT percentiles, the slowest-N requests with full phase
attribution (queue / prefill / prefill-wait / block-stall / draft /
decode / unattributed), and names the **dominant cause of the p99
tail**. With ``SPARKDL_SLO_*`` objectives armed it appends a
whole-stream SLO compliance block (exact per-trace values — the offline
twin of the live burn-rate monitor).

Usage:
    python scripts/torch_request_report.py EVENT_DIR [--top N] [--json]

Exit codes: 0 = report printed; 2 = no serve_* trace evidence found.
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
from sparkdl_tpu_torch.runner import analysis  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-request phase attribution + tail-latency "
                    "explanation from flight-recorder span streams")
    ap.add_argument("event_dir",
                    help="directory of events_rank*.jsonl streams "
                         "(SPARKDL_EVENT_DIR; gang-*/ subdirs included)")
    ap.add_argument("--top", type=int, default=8,
                    help="how many slowest requests to tabulate "
                         "(default 8)")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON object instead "
                         "of the table")
    ns = ap.parse_args(argv)

    recs = analysis.load_event_dir(ns.event_dir)
    req = analysis.request_summary(recs, top_n=max(1, ns.top))
    if req is None:
        print(f"torch_request_report: no completed serve_* request "
              f"traces under {ns.event_dir}", file=sys.stderr)
        return 2
    if ns.json:
        print(json.dumps(req, default=str))
    else:
        print(analysis.format_request_summary(req))
    return 0


if __name__ == "__main__":
    sys.exit(main())
