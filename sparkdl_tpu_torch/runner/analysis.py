"""Bottleneck attribution over span streams and telemetry snapshots.

The port's copy of ``sparkdl_tpu/runner/analysis.py``, whole. It turns a
span stream — the flight recorder's ring tail, a rank's
``events_rank{i}.jsonl``, or a whole event dir — into a per-stage
utilization breakdown:

- **busy_s** — summed span durations (slot-seconds; two pool workers busy
  one wall second contribute 2.0);
- **wall_busy_s** — the union of the stage's active intervals (wall
  seconds during which >= 1 span of the stage was open);
- **busy_frac** — wall-busy over the stream's elapsed wall: the
  bottleneck signal, in [0, 1] by construction;
- **exclusive_s** — wall seconds during which ONLY this stage was active
  (a timeline sweep across all stages): the Amdahl-relevant quantity —
  eliminating the stage entirely saves at most its exclusive time;
- **idle_s** — wall seconds where *no* stage was active (gaps the spans
  do not explain: GC, scheduling, untraced work).

Attribution names the **dominant stage** (highest busy fraction) and the
Amdahl-style projection: with the dominant stage wall-busy fraction f,
perfecting everything else yields at most **1/f** speedup. Requests fold
through ``telemetry.assemble_request_traces``, the fold the live
collector runs, so live and offline traces come from the same code.
Stdlib-only: it imports no torch and touches no device;
``scripts/torch_bottleneck_report.py`` and
``scripts/torch_request_report.py`` are the CLIs over it.
"""

from __future__ import annotations

import json
import os
import re
from typing import Iterable

__all__ = ["intervals_from_events", "read_span_stream", "load_event_dir",
           "union_seconds", "analyze", "utilization_from_events",
           "format_report", "request_summary", "format_request_summary"]

_EVENT_FILE_RE = re.compile(r"events_rank(\d+)\.jsonl$")
# Span names that are not pipeline *stages*: whole-run envelopes whose
# duration would swamp every real stage's busy fraction.
_NON_STAGE_SPANS = frozenset({"eval", "serve_request"})


def read_span_stream(path: str) -> list[dict]:
    """All records of one ``events_rank*.jsonl`` file (full read — this is
    the offline analysis tool, not the supervisor's bounded tail)."""
    recs = []
    with open(path, "rb") as f:
        for line in f:
            try:
                recs.append(json.loads(line))
            except ValueError:
                continue  # torn tail line from a killed rank
    return recs


def load_event_dir(event_dir: str) -> list[dict]:
    """Every rank's span stream under ``event_dir``, merged — plus the
    NEWEST non-empty ``gang-*/`` subdir supervised gangs stream into.
    Newest only, the same rule as ``telemetry.aggregate_snapshots``: a
    reused SPARKDL_EVENT_DIR accumulates one kept gang-* subdir per
    supervise() run, and merging unrelated runs into one timeline would
    turn the gap between them into fictitious idle time and collapse
    every busy fraction."""
    recs: list[dict] = []
    try:
        names = sorted(os.listdir(event_dir))
    except OSError:
        return recs
    for fn in names:
        if _EVENT_FILE_RE.match(fn):
            try:
                recs.extend(read_span_stream(os.path.join(event_dir, fn)))
            except OSError:
                continue
    gang_dirs = [os.path.join(event_dir, fn) for fn in names
                 if fn.startswith("gang-")
                 and os.path.isdir(os.path.join(event_dir, fn))]
    try:
        gang_dirs.sort(key=os.path.getmtime, reverse=True)
    except OSError:
        pass
    for gd in gang_dirs:
        gang_recs = load_event_dir(gd)
        if gang_recs:
            recs.extend(gang_recs)
            break
    return recs


def intervals_from_events(events: Iterable[dict]) -> dict[str, list]:
    """stage → [(t0, t1, rows, bytes), ...] from span END records (the E
    event carries ``t`` and ``dur_s``, so t0 = t - dur_s; B events are
    not needed and a stream truncated mid-span degrades gracefully)."""
    out: dict[str, list] = {}
    for r in events:
        if r.get("ph") != "E":
            continue
        dur = r.get("dur_s")
        name = r.get("name")
        if not isinstance(name, str) or name in _NON_STAGE_SPANS \
                or not isinstance(dur, (int, float)) or dur < 0:
            continue
        t1 = r.get("t")
        if not isinstance(t1, (int, float)):
            continue
        out.setdefault(name, []).append(
            (t1 - dur, t1, int(r.get("rows") or 0),
             int(r.get("bytes") or 0)))
    return out


def union_seconds(intervals: list) -> float:
    """Total length of the union of (t0, t1, ...) intervals."""
    if not intervals:
        return 0.0
    ivs = sorted((iv[0], iv[1]) for iv in intervals)
    total = 0.0
    cur0, cur1 = ivs[0]
    for t0, t1 in ivs[1:]:
        if t0 > cur1:
            total += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    return total + (cur1 - cur0)


def _sweep(per_stage: dict[str, list]) -> tuple[dict[str, float], float]:
    """Timeline sweep over all stages' intervals → (exclusive seconds per
    stage, idle seconds). A slice of wall time is *exclusive* to a stage
    when that stage alone is active; *idle* when none is."""
    points: list[tuple[float, int, str]] = []
    for name, ivs in per_stage.items():
        for iv in ivs:
            points.append((iv[0], +1, name))
            points.append((iv[1], -1, name))
    if not points:
        return {}, 0.0
    points.sort(key=lambda p: (p[0], -p[1]))  # opens before closes at ties
    active: dict[str, int] = {}
    exclusive = {name: 0.0 for name in per_stage}
    idle = 0.0
    prev_t = points[0][0]
    for t, delta, name in points:
        dt = t - prev_t
        if dt > 0:
            live = [s for s, n in active.items() if n > 0]
            if len(live) == 1:
                exclusive[live[0]] += dt
            elif not live:
                idle += dt
        prev_t = t
        active[name] = active.get(name, 0) + delta
    return exclusive, idle


def analyze(events: Iterable[dict] | None = None,
            event_dir: str | None = None) -> dict | None:
    """Per-stage utilization breakdown + bottleneck attribution.

    Pass raw records (``events``) or a directory of per-rank streams
    (``event_dir``). Returns None when no spans are found. The report is
    internally consistent by construction: every ``busy_frac`` is a
    clamped interval-union over the measured wall, exclusive+overlap
    never exceeds wall, and ``idle_s`` is what the spans leave
    unexplained.
    """
    if events is None:
        events = load_event_dir(event_dir) if event_dir else []
    events = list(events)
    per_stage = intervals_from_events(events)
    if not per_stage:
        return None
    t_begin = min(iv[0] for ivs in per_stage.values() for iv in ivs)
    t_end = max(iv[1] for ivs in per_stage.values() for iv in ivs)
    wall = max(t_end - t_begin, 1e-9)
    exclusive, idle = _sweep(per_stage)
    stages = {}
    for name, ivs in sorted(per_stage.items()):
        busy = sum(iv[1] - iv[0] for iv in ivs)
        wall_busy = min(union_seconds(ivs), wall)
        excl = min(exclusive.get(name, 0.0), wall_busy)
        stages[name] = {
            "count": len(ivs),
            "busy_s": round(busy, 6),
            "wall_busy_s": round(wall_busy, 6),
            "busy_frac": round(min(1.0, wall_busy / wall), 4),
            "exclusive_s": round(excl, 6),
            "exclusive_frac": round(min(1.0, excl / wall), 4),
            "avg_concurrency": round(busy / wall_busy, 2)
            if wall_busy > 0 else 0.0,
            "rows": sum(iv[2] for iv in ivs),
            "bytes": sum(iv[3] for iv in ivs),
        }
        if stages[name]["rows"] and wall > 0:
            stages[name]["rows_per_sec"] = round(
                stages[name]["rows"] / wall, 2)
    dominant = max(stages, key=lambda s: stages[s]["busy_frac"])
    dom_frac = stages[dominant]["busy_frac"]
    # Amdahl bound: the dominant stage stays on the critical path for its
    # wall-busy seconds however fast everything else gets — perfecting
    # the rest yields at most wall / wall_busy_dominant.
    max_speedup_others = round(1.0 / dom_frac, 2) if dom_frac > 0 else None
    # And per the dominant stage itself: removing only ITS exclusive time
    # (the overlapped part is hidden behind other stages already).
    dom_excl = stages[dominant]["exclusive_s"]
    dom_speedup = round(wall / max(wall - dom_excl, 1e-9), 2)
    return {
        "wall_s": round(wall, 6),
        "idle_s": round(idle, 6),
        "idle_frac": round(min(1.0, idle / wall), 4),
        "stages": stages,
        "dominant_stage": dominant,
        "dominant_busy_frac": dom_frac,
        "max_speedup_fixing_others": max_speedup_others,
        "max_speedup_fixing_dominant": dom_speedup,
    }


def utilization_from_events(events: Iterable[dict]) -> dict | None:
    """Compact ``stage_utilization`` block for bench records: the analyze
    report minus the per-stage exclusive sweep detail."""
    rep = analyze(events=events)
    if rep is None:
        return None
    return {
        "wall_s": rep["wall_s"],
        "idle_frac": rep["idle_frac"],
        "dominant_stage": rep["dominant_stage"],
        "max_speedup_fixing_others": rep["max_speedup_fixing_others"],
        "stages": {name: {k: st[k] for k in
                          ("busy_s", "busy_frac", "avg_concurrency",
                           "count", "rows")}
                   for name, st in rep["stages"].items()},
    }


def _pct(sorted_vals: list, q: float):
    """Nearest-rank percentile of an ascending list (exact values —
    offline trace analysis needs no bucket resolution)."""
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q * (len(sorted_vals) - 1)))))
    return round(sorted_vals[i], 6)


def request_summary(events: Iterable[dict], top_n: int = 8,
                    tail_frac: float = 0.01) -> dict | None:
    """Request-trace tail analysis over a span stream: the
    assembled per-request traces (``telemetry.assemble_request_traces``
    — the same fold the live collector runs), exact latency/TTFT
    percentiles, the slowest ``top_n`` with phase attribution, and the
    **dominant cause of the p99 tail** — the phase holding the most
    wall time across the slowest ``tail_frac`` of requests. None when
    the stream holds no completed ``serve_*`` traces.

    Also reports the attribution residual: ``max_unattributed_frac``
    over completed (non-error) traces is the "phases provably sum to
    measured latency" observable (the serve_bench acceptance bound is
    0.05). When objectives are armed (``SPARKDL_SLO_*``), an ``slo``
    compliance block is attached (exact per-trace values — the offline
    twin of the live burn-rate monitor)."""
    from . import slo, telemetry
    col = telemetry.assemble_request_traces(events)
    traces = col.traces()
    if not traces:
        return None
    by_slow = sorted(traces, key=lambda t: -t["latency_s"])
    lats = sorted(t["latency_s"] for t in traces)
    ttfts = sorted(t["ttft_s"] for t in traces
                   if t.get("ttft_s") is not None)
    n_tail = max(1, int(round(len(traces) * tail_frac)))
    tail = by_slow[:n_tail]
    tail_phases: dict[str, float] = {}
    for t in tail:
        for k, v in (t.get("phases") or {}).items():
            tail_phases[k] = tail_phases.get(k, 0.0) + v
    tail_wall = sum(tail_phases.values()) or 1e-9
    dominant = max(tail_phases, key=tail_phases.get) if tail_phases \
        else None
    complete = [t for t in traces
                if t.get("finish") != "error" and not t.get("partial")
                and t["latency_s"] > 0]
    unattr = [abs(t["unattributed_s"]) / t["latency_s"]
              for t in complete]
    out = {
        "completed": len(traces),
        "errors": sum(1 for t in traces if t.get("finish") == "error"),
        "open": col.open_count(),
        "latency_s": {"p50": _pct(lats, 0.50), "p95": _pct(lats, 0.95),
                      "p99": _pct(lats, 0.99),
                      "max": round(lats[-1], 6)},
        "ttft_s": {"p50": _pct(ttfts, 0.50), "p99": _pct(ttfts, 0.99)}
        if ttfts else None,
        "slowest": by_slow[:top_n],
        "tail_n": n_tail,
        "tail_dominant_phase": dominant,
        "tail_phase_frac": {k: round(v / tail_wall, 4)
                            for k, v in sorted(tail_phases.items())},
        "max_unattributed_frac": round(max(unattr), 4) if unattr
        else None,
        "mean_unattributed_frac": round(sum(unattr) / len(unattr), 4)
        if unattr else None,
    }
    slo_block = slo.compliance_from_traces(traces)
    if slo_block:
        out["slo"] = slo_block
    return out


def format_request_summary(req: dict) -> str:
    """Human rendering shared by ``scripts/torch_request_report.py`` and
    ``scripts/torch_bottleneck_report.py``: slowest-requests table with phase
    attribution, the p99-tail dominant cause, and the SLO compliance
    block when objectives are armed."""
    lines = []
    lat, ttft = req["latency_s"], req.get("ttft_s")
    lines.append(
        f"request traces: {req['completed']} completed "
        f"({req['errors']} errors, {req['open']} still open) — latency "
        f"p50 {lat['p50']}s p95 {lat['p95']}s p99 {lat['p99']}s "
        f"max {lat['max']}s"
        + (f"; TTFT p50 {ttft['p50']}s p99 {ttft['p99']}s" if ttft
           else ""))
    if req.get("max_unattributed_frac") is not None:
        lines.append(
            f"phase attribution residual: max "
            f"{100 * req['max_unattributed_frac']:.1f}% of latency "
            f"unattributed (mean "
            f"{100 * req['mean_unattributed_frac']:.1f}%)")
    cols = ("req", "latency_s", "queue", "prefill", "pf_wait",
            "blk_stall", "draft", "decode", "unattr", "toks", "finish",
            "dominant")
    rows = []
    for t in req["slowest"]:
        ph = t.get("phases") or {}
        rows.append((
            str(t["request"]), f"{t['latency_s']:.4f}",
            f"{ph.get('queue', 0):.4f}", f"{ph.get('prefill', 0):.4f}",
            f"{ph.get('prefill_wait', 0):.4f}",
            f"{ph.get('block_stall', 0):.4f}",
            f"{ph.get('draft', 0):.4f}", f"{ph.get('decode', 0):.4f}",
            f"{t['unattributed_s']:.4f}", str(t.get("tokens_out", 0)),
            str(t.get("finish")), str(t.get("dominant_phase"))))
    widths = [max(len(c), *(len(r[i]) for r in rows))
              for i, c in enumerate(cols)]
    lines.append("  ".join(c.ljust(widths[i])
                           for i, c in enumerate(cols)))
    lines += ["  ".join(v.ljust(widths[i]) for i, v in enumerate(r))
              for r in rows]
    if req.get("tail_dominant_phase"):
        fr = req["tail_phase_frac"].get(req["tail_dominant_phase"], 0)
        lines.append(
            f"p99 tail (slowest {req['tail_n']} request(s)): dominant "
            f"cause = {req['tail_dominant_phase']} "
            f"({100 * fr:.1f}% of tail wall)")
    slo_block = req.get("slo")
    if slo_block:
        lines.append("SLO compliance (whole stream, exact traces):")
        for name, ob in sorted(slo_block.items()):
            thr = ob.get("threshold_s", ob.get("max_error_rate"))
            comp = ob.get("compliance")
            lines.append(
                f"  {name} (<= {thr}"
                + ("s" if "threshold_s" in ob else " error rate")
                + f", target {ob['target']}): compliance "
                + (f"{comp:.4f}" if comp is not None else "n/a")
                + (" — MET" if ob.get("met")
                   else " — VIOLATED" if comp is not None else ""))
    return "\n".join(lines)


def format_report(rep: dict) -> str:
    """Human rendering: one aligned row per stage, attribution last."""
    cols = ("stage", "n", "busy_s", "busy%", "excl_s", "avg_par", "rows",
            "MB")
    rows = []
    for name, st in sorted(rep["stages"].items(),
                           key=lambda kv: -kv[1]["busy_frac"]):
        rows.append((
            name, str(st["count"]), f"{st['busy_s']:.3f}",
            f"{100 * st['busy_frac']:.1f}", f"{st['exclusive_s']:.3f}",
            f"{st['avg_concurrency']:.2f}", str(st["rows"]),
            f"{st['bytes'] / 1e6:.1f}"))
    widths = [max(len(c), *(len(r[i]) for r in rows))
              for i, c in enumerate(cols)]
    lines = ["  ".join(c.ljust(widths[i]) for i, c in enumerate(cols))]
    lines += ["  ".join(v.ljust(widths[i]) for i, v in enumerate(r))
              for r in rows]
    lines.append(
        f"wall {rep['wall_s']:.3f}s, idle (no stage active) "
        f"{rep['idle_s']:.3f}s ({100 * rep['idle_frac']:.1f}%)")
    dom = rep["dominant_stage"]
    lines.append(
        f"dominant stage: {dom} "
        f"({100 * rep['dominant_busy_frac']:.1f}% busy) — fixing anything "
        f"else yields <= {rep['max_speedup_fixing_others']}x; eliminating "
        f"{dom}'s exclusive time yields <= "
        f"{rep['max_speedup_fixing_dominant']}x")
    return "\n".join(lines)
