"""Merged Chrome-trace timeline export.

The port's copy of ``sparkdl_tpu/runner/traceview.py``, whole. A run's
observability artifacts live in several files: per-rank
``events_rank*.jsonl`` streams (plus the ``gang-*`` subdirs supervised
gangs stream into), the supervisor's ``trace_manifest.json`` span tree,
per-rank telemetry snapshot histories (``metrics_rank*.jsonl``), and the
request traces folded from serve_* spans. This module merges ALL of them
into one Chrome trace-event JSON — loadable in Perfetto or
``chrome://tracing`` — so a gang, its restarts, its chaos injections,
and its serving requests render on one timeline:

- **pid = rank** (the supervisor's own spans get a synthetic "driver"
  process), **tid = one lane per span name** — Chrome requires strict
  nesting per (pid, tid), which concurrent feed/serve spans of one rank
  do not satisfy, so each span family gets its own named lane instead.
- Span E records → ``"X"`` complete events (B records carry no duration
  and are implied); point events (chaos, anomaly, slo transitions,
  degradations) → ``"i"`` instants; gauge/counter histories → ``"C"``
  counter tracks; completed request traces → one summary span per
  request on a ``requests`` lane.
- **Cross-rank clock skew is measured, not silently ignored**: each
  rank's heartbeat body carries the rank's own wall clock while the
  file mtime is the host clock — the per-rank delta is annotated in
  ``otherData.clock_skew`` and flagged when it exceeds the threshold
  below. (Ranks on one host share a clock; the annotation is what makes
  a multi-host merge honest.)

Timestamps are microseconds (the trace-event contract); wall-clock
``time.time()`` seconds from the recorder multiply straight through.
Stdlib-only, like every other supervisor-side reader: it touches no
device. ``scripts/torch_trace_export.py`` is the CLI over it.
"""

from __future__ import annotations

import json
import os
import re

from . import events as events_lib
from . import telemetry as telemetry_lib
from .analysis import load_event_dir, read_span_stream

__all__ = ["chrome_trace", "validate_chrome_trace", "write_chrome_trace",
           "find_trace_manifest", "measure_clock_skew"]

DRIVER_PID = 1_000_000  # synthetic pid for supervisor-side manifest spans
_SKEW_FLAG_S = 0.25     # annotate-and-flag threshold for per-rank skew
_HB_FILE_RE = re.compile(r"rank(\d+)\.hb$")
_METRICS_HISTORY_RE = re.compile(r"metrics_rank(\d+)\.jsonl$")


# ---------------------------------------------------------------------------
# manifest + skew
# ---------------------------------------------------------------------------

def find_trace_manifest(event_dir: str) -> dict | None:
    """The supervisor's ``trace_manifest.json`` for this event dir — in
    the dir itself, or (when the caller hands us the PARENT of a
    supervised run's adopted ``gang-*`` subdir) in the newest gang
    subdir, the same newest-only rule as ``analysis.load_event_dir``."""
    cand = [os.path.join(event_dir, events_lib.TRACE_MANIFEST_FILE)]
    try:
        names = sorted(os.listdir(event_dir))
    except OSError:
        names = []
    gang = [os.path.join(event_dir, fn) for fn in names
            if fn.startswith("gang-")
            and os.path.isdir(os.path.join(event_dir, fn))]
    try:
        gang.sort(key=os.path.getmtime, reverse=True)
    except OSError:
        pass
    cand.extend(os.path.join(g, events_lib.TRACE_MANIFEST_FILE)
                for g in gang)
    for path in cand:
        try:
            with open(path) as f:
                m = json.load(f)
            if isinstance(m, dict) and m.get("trace_id"):
                return m
        except (OSError, ValueError):
            continue
    return None


def measure_clock_skew(heartbeat_dir: str | None) -> dict:
    """Per-rank ``body_time - file_mtime`` (rank clock minus host clock)
    from the heartbeat files. Always returns an annotation block — skew
    that could not be measured says so explicitly rather than reading as
    zero."""
    out: dict = {"measured": False, "per_rank_s": {}, "flagged": []}
    if not heartbeat_dir:
        out["note"] = "no heartbeat dir — skew unmeasured"
        return out
    try:
        names = sorted(os.listdir(heartbeat_dir))
    except OSError:
        out["note"] = f"heartbeat dir unreadable: {heartbeat_dir}"
        return out
    for fn in names:
        m = _HB_FILE_RE.match(fn)
        if not m:
            continue
        path = os.path.join(heartbeat_dir, fn)
        try:
            mtime = os.stat(path).st_mtime
            with open(path) as f:
                body = events_lib.parse_heartbeat_body(f.read())
        except OSError:
            continue
        t = body.get("time")
        if not isinstance(t, (int, float)):
            continue
        rank = int(m.group(1))
        skew = round(float(t) - mtime, 6)
        out["per_rank_s"][str(rank)] = skew
        if abs(skew) > _SKEW_FLAG_S:
            out["flagged"].append(rank)
    if out["per_rank_s"]:
        out["measured"] = True
    else:
        out["note"] = "no parseable heartbeats — skew unmeasured"
    return out


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

def _lane(tids: dict, meta: list, pid: int, name: str) -> int:
    """Stable per-(pid, lane-name) tid + its thread_name metadata event
    (emitted once, on first use)."""
    key = (pid, name)
    tid = tids.get(key)
    if tid is None:
        tid = tids[key] = sum(1 for k in tids if k[0] == pid) + 1
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "args": {"name": name}})
    return tid


def _span_args(rec: dict) -> dict:
    return {k: v for k, v in rec.items()
            if k not in ("t", "name", "ph", "dur_s")}


def _counter_tracks(metrics_dir: str | None, out: list, procs: set):
    """Gauge (and counter) histories from ``metrics_rank*.jsonl`` snapshot
    lines → Chrome ``"C"`` counter events, one track per metric name."""
    if not metrics_dir:
        return
    try:
        names = sorted(os.listdir(metrics_dir))
    except OSError:
        return
    for fn in names:
        m = _METRICS_HISTORY_RE.match(fn)
        if not m:
            continue
        rank = int(m.group(1))
        try:
            snaps = read_span_stream(os.path.join(metrics_dir, fn))
        except OSError:
            continue
        for snap in snaps:
            t = snap.get("t")
            if not isinstance(t, (int, float)):
                continue
            ts = t * 1e6
            for gname, g in (snap.get("gauges") or {}).items():
                v = g.get("value") if isinstance(g, dict) else g
                if isinstance(v, (int, float)):
                    procs.add(rank)
                    out.append({"ph": "C", "name": gname, "pid": rank,
                                "ts": ts, "args": {"value": v}})
            for cname, v in (snap.get("counters") or {}).items():
                if isinstance(v, (int, float)):
                    procs.add(rank)
                    out.append({"ph": "C", "name": cname, "pid": rank,
                                "ts": ts, "args": {"value": v}})


def _request_tracks(recs: list[dict], tids: dict, meta: list,
                    out: list) -> int:
    """Request traces as one summary span per completed request on
    the owning rank's ``requests`` lane. The serve_* phase spans are
    already on the timeline individually; the summary span is the
    human-scannable envelope with the folded phase attribution in args."""
    col = telemetry_lib.assemble_request_traces(recs)
    owner: dict = {}  # request id -> rank (from the spans that carried it)
    for r in recs:
        rid = r.get("request")
        if rid is not None and isinstance(r.get("rank"), int):
            owner.setdefault(rid, r["rank"])
    n = 0
    for tr in col.traces():
        t0, lat = tr.get("t_submit"), tr.get("latency_s")
        if not isinstance(t0, (int, float)) \
                or not isinstance(lat, (int, float)):
            continue
        pid = owner.get(tr.get("request"), 0)
        out.append({
            "ph": "X", "name": f"request {tr.get('request')}",
            "pid": pid, "tid": _lane(tids, meta, pid, "requests"),
            "ts": t0 * 1e6, "dur": max(lat, 0.0) * 1e6,
            "args": {"finish": tr.get("finish"),
                     "dominant_phase": tr.get("dominant_phase"),
                     "phases": tr.get("phases"),
                     "ttft_s": tr.get("ttft_s")}})
        n += 1
    return n


def chrome_trace(event_dir: str, metrics_dir: str | None = None,
                 heartbeat_dir: str | None = None) -> dict:
    """Assemble the merged Chrome trace-event JSON (see module docstring).

    ``event_dir`` may be a rank-stream dir or the parent of a supervised
    run's ``gang-*`` subdir (newest-only merge, the ``analysis`` rule).
    """
    recs = load_event_dir(event_dir)
    manifest = find_trace_manifest(event_dir)
    tids: dict = {}
    meta: list[dict] = []
    out: list[dict] = []
    procs: set[int] = set()
    spans = instants = 0
    for r in recs:
        ph = r.get("ph")
        t = r.get("t")
        rank = r.get("rank")
        if not isinstance(t, (int, float)) or not isinstance(rank, int):
            continue
        name = str(r.get("name"))
        if ph == "E":
            dur = r.get("dur_s")
            dur = float(dur) if isinstance(dur, (int, float)) \
                and dur >= 0 else 0.0
            procs.add(rank)
            out.append({"ph": "X", "name": name, "pid": rank,
                        "tid": _lane(tids, meta, rank, name),
                        "ts": (t - dur) * 1e6, "dur": dur * 1e6,
                        "args": _span_args(r)})
            spans += 1
        elif ph == "P":
            procs.add(rank)
            out.append({"ph": "i", "name": name, "pid": rank,
                        "tid": _lane(tids, meta, rank, name),
                        "ts": t * 1e6, "s": "t",
                        "args": _span_args(r)})
            instants += 1
        # B records: implied by their E twin; an unclosed B (crashed
        # mid-span) has no honest duration, and the crash itself is
        # already on the timeline via postmortem/chaos instants.
    requests = _request_tracks(recs, tids, meta, out)
    # Supervisor spans: siblings ordered by t — each span's visual extent
    # runs to the next supervisor span's start (its true end is implicit:
    # an attempt ends when the next one, or the run, begins).
    if manifest:
        mspans = [s for s in manifest.get("spans", [])
                  if isinstance(s.get("t"), (int, float))]
        mspans.sort(key=lambda s: s["t"])
        t_end = max((s["t"] for s in mspans), default=0.0)
        if recs:
            t_end = max(t_end, max(r.get("t", 0.0) for r in recs
                                   if isinstance(r.get("t"),
                                                 (int, float))))
        for i, s in enumerate(mspans):
            nxt = mspans[i + 1]["t"] if i + 1 < len(mspans) else t_end
            dur = max(0.0, (t_end if s.get("parent_id") is None else nxt)
                      - s["t"])
            out.append({
                "ph": "X", "name": str(s.get("name")), "pid": DRIVER_PID,
                "tid": _lane(tids, meta, DRIVER_PID,
                             str(s.get("name"))),
                "ts": s["t"] * 1e6, "dur": dur * 1e6,
                "args": {k: v for k, v in s.items() if k != "t"}})
        meta.append({"ph": "M", "name": "process_name", "pid": DRIVER_PID,
                     "args": {"name": "driver"}})
    _counter_tracks(metrics_dir, out, procs)
    for rank in sorted(procs):
        meta.append({"ph": "M", "name": "process_name", "pid": rank,
                     "args": {"name": f"rank {rank}"}})
    skew = measure_clock_skew(heartbeat_dir)
    out.sort(key=lambda e: e.get("ts", 0.0))
    return {
        "traceEvents": meta + out,
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": manifest.get("trace_id") if manifest else None,
            "root_span_id":
                manifest.get("root_span_id") if manifest else None,
            "event_dir": os.path.abspath(event_dir),
            "spans": spans, "instants": instants, "requests": requests,
            "clock_skew": skew,
        },
    }


def write_chrome_trace(path: str, trace: dict) -> str:
    return events_lib.atomic_write_json(path, trace)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def validate_chrome_trace(trace: dict, require_ranks: int = 1,
                          require_requests: int = 0,
                          require_counters: bool = False) -> dict:
    """Structural validation of an assembled trace — the acceptance
    contract ``chip_smoke.py``'s offline legs (and the export CLI's
    ``--validate``) check: every span that claims a trace id claims THE
    trace id, every ``parent_id`` chain resolves to the run root
    through known spans, and the merge actually covered ≥
    ``require_ranks`` rank processes / ``require_requests`` request
    tracks / counter tracks when asked.
    Returns ``{"ok": bool, "problems": [...], ...counts}`` — never
    raises, so the CLI can print the verdict as data."""
    problems: list[str] = []
    evs = trace.get("traceEvents") or []
    other = trace.get("otherData") or {}
    trace_id = other.get("trace_id")
    root = other.get("root_span_id")
    known: set = set()
    if root:
        known.add(root)
    parent_of: dict = {}
    for e in evs:
        args = e.get("args") or {}
        sid = args.get("span_id")
        if sid:
            known.add(sid)
            parent_of[sid] = args.get("parent_id")
    ranks = sorted({e["pid"] for e in evs
                    if e.get("ph") in ("X", "i")
                    and isinstance(e.get("pid"), int)
                    and e["pid"] != DRIVER_PID})
    traced_spans = bad_trace_id = unresolved = 0
    for e in evs:
        args = e.get("args") or {}
        if args.get("trace_id") is None and args.get("span_id") is None:
            continue
        traced_spans += 1
        if trace_id and args.get("trace_id") not in (None, trace_id):
            bad_trace_id += 1
        parent = args.get("parent_id")
        seen = set()
        while parent is not None and parent != root:
            if parent in seen:
                problems.append(f"parent cycle at {parent}")
                break
            seen.add(parent)
            if parent not in known:
                unresolved += 1
                break
            parent = parent_of.get(parent)
    counters = sum(1 for e in evs if e.get("ph") == "C")
    requests = other.get("requests", 0)
    if bad_trace_id:
        problems.append(
            f"{bad_trace_id} span(s) carry a FOREIGN trace_id")
    if unresolved:
        problems.append(
            f"{unresolved} span(s) have a parent_id that resolves to "
            f"no known span")
    if len(ranks) < require_ranks:
        problems.append(
            f"expected spans from >= {require_ranks} rank(s), "
            f"got {ranks}")
    if requests < require_requests:
        problems.append(
            f"expected >= {require_requests} request track(s), "
            f"got {requests}")
    if require_counters and not counters:
        problems.append("no counter tracks in the trace")
    if not other.get("clock_skew"):
        problems.append("clock skew block missing (must be annotated "
                        "even when unmeasured)")
    return {"ok": not problems, "problems": problems,
            "trace_id": trace_id, "events": len(evs),
            "traced_spans": traced_spans, "ranks": ranks,
            "counters": counters, "requests": requests}
