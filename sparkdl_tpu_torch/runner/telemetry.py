"""Live telemetry plane — metrics registry, stage accounting, request
traces, export.

The port's copy of ``sparkdl_tpu/runner/telemetry.py``, whole. Stdlib
only, like the rest of the runner's observability stack: it imports no
torch, so the gang supervisor (``launcher.supervise``) reads the ranks'
snapshots through it (``clear_rank_files``, ``aggregate_snapshots``).

- **Registry** (:class:`MetricsRegistry`): counters, gauges (with
  high-water marks), histograms — the queue-depth / slot-occupancy /
  fleet metrics the span stream cannot carry.
- **StageAccountant**: a tee on the flight recorder (``events.add_tee``)
  that turns every span exit — ``pad``/``put``/``dispatch``/``fetch`` in
  ``BatchRunner.run_stream``, ``data_fetch``/``shard_put``/
  ``step_compute`` in ``fit()``, the engine's ``serve_*`` spans — into
  per-stage **wall-clock time accounting**: busy-seconds (summed span
  durations = slot-seconds), *wall-busy* seconds (the union of active
  intervals, so two overlapping workers count the wall once), rows,
  bytes, error counts, and observed concurrency. The busy *fraction*
  (wall-busy over elapsed) is what names a bottleneck.
- **RequestTraceCollector**: a second tee folding the serving engine's
  per-request spans into one trace a request whose phases sum to its
  latency.
- **Export**: a background thread writing a per-rank snapshot to
  ``$SPARKDL_METRICS_DIR/metrics_rank{i}.json`` every
  ``SPARKDL_METRICS_INTERVAL_S`` seconds (atomic tmp+replace — the
  latest completed snapshot survives a SIGKILL) plus an append-mode
  ``metrics_rank{i}.jsonl`` history line; and an optional
  ``http.server`` endpoint (``SPARKDL_METRICS_PORT``) serving Prometheus
  text at ``/metrics``, JSON at ``/metrics.json``, the live engine and
  fleet inspector at ``/serving`` and a liveness probe at ``/healthz``.

The plane is **opt-in and ≈ free when off**: with neither env var set
(and no explicit :func:`start`), no tee is registered, no thread runs,
and the only residual cost is the recorder's one falsy ``_TEES`` check
per event. ``meter.summary()['stage_utilization']`` is the human-facing
end.
"""

from __future__ import annotations

import atexit
import bisect
import collections
import json
import logging
import os
import re
import threading
import time

from . import events

__all__ = [
    "METRICS_DIR_ENV", "METRICS_PORT_ENV", "METRICS_INTERVAL_ENV",
    "TRACE_RING_ENV", "TRACE_SLOWEST_ENV",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StageAccountant",
    "RequestTraceCollector", "assemble_request_traces", "request_traces",
    "start", "stop", "reset", "enabled", "maybe_start_from_env",
    "registry", "accountant", "fleet_metric",
    "snapshot", "flush_snapshot", "render_prometheus",
    "aggregate_snapshots", "clear_rank_files", "stage_utilization_summary",
    "server_port", "histogram_quantile", "histogram_fraction_below",
]

log = logging.getLogger("sparkdl_tpu_torch.runner")

METRICS_DIR_ENV = "SPARKDL_METRICS_DIR"
METRICS_PORT_ENV = "SPARKDL_METRICS_PORT"
METRICS_INTERVAL_ENV = "SPARKDL_METRICS_INTERVAL_S"
HISTORY_CAP_ENV = "SPARKDL_METRICS_MAX_MB"
# Request-scoped tracing: the completed-trace ring bound and
# how many slowest traces ride each exported snapshot (so the tail
# evidence survives a SIGKILL via the atomic latest-snapshot file).
TRACE_RING_ENV = "SPARKDL_TRACE_RING"
TRACE_SLOWEST_ENV = "SPARKDL_TRACE_SLOWEST"
_DEFAULT_TRACE_RING = 256
_DEFAULT_TRACE_SLOWEST = 8
_MAX_OPEN_TRACES = 4096  # in-flight fold states (queue+slots bound this
# in practice; the cap is a leak guard against half-traced streams)
_DEFAULT_INTERVAL_S = 2.0
_DEFAULT_HISTORY_CAP_MB = 64  # per-rank .jsonl history cap; the atomic
# latest-snapshot file keeps updating past it (same disk-safety rule as
# SPARKDL_EVENT_MAX_MB: a multi-day run must not fill the volume)
_SNAPSHOT_FILE_RE = re.compile(r"metrics_rank(\d+)\.json$")
# Latency-shaped default buckets (seconds), Prometheus-style with +Inf
# implicit: spans range from sub-ms pad/put to multi-second compiles.
_DEFAULT_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0)


def _history_cap_bytes() -> int:
    """Per-rank ``.jsonl`` history cap (``SPARKDL_METRICS_MAX_MB``,
    default 64)."""
    try:
        mb = float(os.environ.get(HISTORY_CAP_ENV,
                                  _DEFAULT_HISTORY_CAP_MB))
    except ValueError:
        mb = _DEFAULT_HISTORY_CAP_MB
    return int(mb * 2 ** 20)


def export_interval_default() -> float:
    """Exporter cadence (``SPARKDL_METRICS_INTERVAL_S``, default 2.0 s).
    The write is one small atomic JSON file per rank per tick — cheap
    enough that sub-second intervals are fine for tests/smokes."""
    try:
        return max(0.05, float(
            os.environ.get(METRICS_INTERVAL_ENV, _DEFAULT_INTERVAL_S)))
    except ValueError:
        return _DEFAULT_INTERVAL_S


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic counter. ``inc`` under the registry's lock-free contract:
    float += on CPython is not atomic across threads, so each metric
    carries its own tiny lock — the plane is only ever armed deliberately
    and a lock on an opted-in path beats silently wrong totals."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0):
        with self._lock:
            self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-set value + high-water mark (queue depths, slot occupancy:
    the *peak* is the sizing evidence, the last value the live view)."""

    __slots__ = ("value", "max", "_lock")

    def __init__(self):
        self.value = 0.0
        self.max = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self.value = v
            if v > self.max:
                self.max = v

    def snapshot(self):
        return {"value": self.value, "max": self.max}


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus semantics):
    ``observe(v)`` lands in every bucket whose bound >= v; count/sum are
    exact, quantiles are bucket-resolution."""

    __slots__ = ("bounds", "buckets", "count", "sum", "_lock")

    def __init__(self, buckets=None):
        self.bounds = tuple(sorted(buckets or _DEFAULT_BUCKETS))
        self.buckets = [0] * len(self.bounds)
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float):
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.count += 1
            self.sum += v
            for j in range(i, len(self.bounds)):
                self.buckets[j] += 1

    def snapshot(self):
        return {"bounds": list(self.bounds), "buckets": list(self.buckets),
                "count": self.count, "sum": round(self.sum, 6)}

    def quantile(self, q: float) -> float | None:
        """Bucket-resolution quantile of the live histogram — see
        :func:`histogram_quantile`."""
        return histogram_quantile(self.snapshot(), q)


def histogram_quantile(hist: dict, q: float) -> float | None:
    """Quantile estimate from a cumulative-bucket histogram snapshot
    (``Histogram.snapshot()``: ``{bounds, buckets, count, sum}``).

    Prometheus ``histogram_quantile`` semantics: find the first bucket
    whose cumulative count covers rank ``q·count`` and interpolate
    linearly inside it (lower edge 0 for the first bucket).
    Observations past the last finite bound (the implicit ``+Inf``
    bucket) resolve to the last finite bound — a bucket with no upper
    edge has no interpolable width. Returns None for an empty
    histogram. This is THE latency-percentile derivation, so two readers
    of one snapshot can never disagree on its p50/p95/p99."""
    count = int(hist.get("count") or 0)
    bounds = list(hist.get("bounds") or [])
    buckets = list(hist.get("buckets") or [])
    if count <= 0 or not bounds or len(bounds) != len(buckets):
        return None
    q = min(1.0, max(0.0, float(q)))
    rank = q * count
    prev_cum, prev_bound = 0, 0.0
    for bound, cum in zip(bounds, buckets):
        if cum >= rank and cum > prev_cum:
            width = bound - prev_bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return round(prev_bound + width * max(0.0, frac), 9)
        prev_cum, prev_bound = cum, bound
    return float(bounds[-1])  # rank lands in +Inf: report the last edge


def histogram_fraction_below(hist: dict, threshold: float
                             ) -> float | None:
    """Fraction of observations <= ``threshold`` in a cumulative-bucket
    histogram snapshot, interpolated inside the bucket the threshold
    falls in (the dual of :func:`histogram_quantile` — the SLO monitor's
    compliance derivation). Observations past the last finite bound (the
    implicit ``+Inf`` bucket) count as above any finite threshold.
    Returns None for an empty histogram."""
    count = int(hist.get("count") or 0)
    bounds = list(hist.get("bounds") or [])
    buckets = list(hist.get("buckets") or [])
    if count <= 0 or not bounds or len(bounds) != len(buckets):
        return None
    threshold = float(threshold)
    prev_cum, prev_bound = 0, 0.0
    for bound, cum in zip(bounds, buckets):
        if threshold < bound:
            width = bound - prev_bound
            frac = (threshold - prev_bound) / width if width > 0 else 1.0
            good = prev_cum + (cum - prev_cum) * max(0.0, min(1.0, frac))
            return round(good / count, 6)
        prev_cum = cum
        prev_bound = bound
    return round(prev_cum / count, 6)  # threshold >= last finite bound


class MetricsRegistry:
    """Name → metric, created on first touch. Snapshot-able as plain JSON
    so the exporter and the Prometheus endpoint read one shape."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str, buckets=None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(buckets)
            return h

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {k: v.snapshot()
                             for k, v in self._counters.items()},
                "gauges": {k: v.snapshot()
                           for k, v in self._gauges.items()},
                "histograms": {k: v.snapshot()
                               for k, v in self._histograms.items()},
            }


# ---------------------------------------------------------------------------
# Stage accounting
# ---------------------------------------------------------------------------

class _StageStats:
    __slots__ = ("count", "busy_s", "wall_busy_s", "rows", "bytes",
                 "errors", "active", "max_active", "_window_start")

    def __init__(self):
        self.count = 0
        self.busy_s = 0.0
        self.wall_busy_s = 0.0
        self.rows = 0
        self.bytes = 0
        self.errors = 0
        self.active = 0
        self.max_active = 0
        self._window_start = 0.0


class StageAccountant:
    """Wall-clock stage accounting off the event stream.

    Feed it every recorder event (:meth:`on_event` is the tee callback).
    Span begins/ends drive two time books per stage:

    - ``busy_s``: summed span durations — *slot-seconds*. Two decode
      workers busy for one wall second contribute 2.0.
    - ``wall_busy_s``: the union of intervals during which >= 1 span of
      the stage was open — wall seconds the stage was making progress at
      all. The union is computed incrementally from the B/E stream (a
      stage's window opens at its 0→1 transition, closes at 1→0), so it
      costs O(1) per event and never stores intervals.

    ``busy_frac = wall_busy_s / elapsed`` is the bottleneck signal;
    ``busy_s / wall_busy_s`` is the stage's achieved parallelism. Point
    events are tallied as ``events.<name>`` counters (with quarantined
    row counts summed), so retries/quarantines/recompiles ride the same
    snapshot. Thread-safe: feed threads, decode pools, and the consumer
    loop all emit concurrently.
    """

    def __init__(self):
        self._stages: dict[str, _StageStats] = {}
        self._events: dict[str, int] = {}
        self._event_rows: dict[str, int] = {}
        self._lock = threading.Lock()
        self.t_first: float | None = None
        self.t_last: float | None = None

    # -- tee callback -----------------------------------------------------
    def on_event(self, rec: dict):
        ph = rec.get("ph")
        name = rec.get("name")
        if not isinstance(name, str):
            return
        t = rec.get("t", 0.0)
        with self._lock:
            if ph == "B" or ph == "E":
                if self.t_first is None or t < self.t_first:
                    self.t_first = t
                if self.t_last is None or t > self.t_last:
                    self.t_last = t
            if ph == "B":
                st = self._stages.get(name)
                if st is None:
                    st = self._stages[name] = _StageStats()
                if st.active == 0:
                    st._window_start = t
                st.active += 1
                if st.active > st.max_active:
                    st.max_active = st.active
            elif ph == "E":
                st = self._stages.get(name)
                if st is None:
                    # E without a seen B (accountant armed mid-span):
                    # count the duration books, skip the union window.
                    st = self._stages[name] = _StageStats()
                st.count += 1
                dur = rec.get("dur_s")
                if isinstance(dur, (int, float)) and dur > 0:
                    st.busy_s += dur
                rows = rec.get("rows")
                if isinstance(rows, (int, float)):
                    st.rows += int(rows)
                nbytes = rec.get("bytes")
                if isinstance(nbytes, (int, float)):
                    st.bytes += int(nbytes)
                if "error" in rec:
                    st.errors += 1
                if st.active > 0:
                    st.active -= 1
                    if st.active == 0:
                        st.wall_busy_s += max(0.0, t - st._window_start)
            else:  # point event
                self._events[name] = self._events.get(name, 0) + 1
                rows = rec.get("rows")
                if isinstance(rows, (int, float)):
                    self._event_rows[name] = \
                        self._event_rows.get(name, 0) + int(rows)

    # -- snapshots --------------------------------------------------------
    def elapsed_s(self, now: float | None = None) -> float:
        with self._lock:
            if self.t_first is None:
                return 0.0
            end = self.t_last or self.t_first
        if now is not None:
            end = max(end, now)
        return max(0.0, end - self.t_first)

    def snapshot(self, now: float | None = None) -> dict:
        """Per-stage books, live: a stage with open spans gets its current
        window counted up to ``now`` so a wedged 30 s dispatch reads as
        busy, not idle, in the mid-run snapshot."""
        now = time.time() if now is None else now
        with self._lock:
            elapsed = 0.0
            if self.t_first is not None:
                end = self.t_last or self.t_first
                if any(s.active for s in self._stages.values()):
                    end = max(end, now)  # open spans extend the window
                elapsed = max(0.0, end - self.t_first)
            stages = {}
            for name, st in self._stages.items():
                wall_busy = st.wall_busy_s
                if st.active > 0:
                    wall_busy += max(0.0, now - st._window_start)
                busy_frac = (min(1.0, wall_busy / elapsed)
                             if elapsed > 0 else 0.0)
                stages[name] = {
                    "count": st.count,
                    "busy_s": round(st.busy_s, 6),
                    "wall_busy_s": round(wall_busy, 6),
                    "busy_frac": round(busy_frac, 4),
                    "rows": st.rows,
                    "bytes": st.bytes,
                    "errors": st.errors,
                    "active": st.active,
                    "max_concurrency": st.max_active,
                }
            out = {"elapsed_s": round(elapsed, 6), "stages": stages}
            if self._events:
                out["events"] = dict(self._events)
            if self._event_rows:
                out["event_rows"] = dict(self._event_rows)
            return out


# ---------------------------------------------------------------------------
# Request-scoped trace assembly
# ---------------------------------------------------------------------------

def _trace_ring_default() -> int:
    try:
        return max(8, int(os.environ.get(TRACE_RING_ENV,
                                         _DEFAULT_TRACE_RING)))
    except ValueError:
        return _DEFAULT_TRACE_RING


def _trace_slowest_default() -> int:
    try:
        return max(1, int(os.environ.get(TRACE_SLOWEST_ENV,
                                         _DEFAULT_TRACE_SLOWEST)))
    except ValueError:
        return _DEFAULT_TRACE_SLOWEST


class RequestTraceCollector:
    """Folds the serving engine's per-request ``serve_*`` spans/events
    into one trace record per request. Rides the same
    ``events.add_tee`` seam as :class:`StageAccountant` — zero cost when
    the plane is off (no tee registered), one dict fold per serving
    event when armed.

    The engine's per-request emissions carry ``request=<id>``:
    ``serve_queue`` (one completed span per queued stint — its duration
    is the stint's wait, its ``t - dur_s`` the enqueue time, so the
    FIRST one pins ``t_submit``), ``serve_prefill`` (duration = active
    prefill compute; ``wait_s`` = the PREFILLING phase's wall minus
    that — time the chunked prefill sat waiting for its round-robin
    turn; ``reused`` = prefix-cache tokens skipped), and
    ``serve_decode`` at retirement (duration = the decode phase wall,
    with ``draft_s`` / ``block_stall_s`` sub-phase attrs and the
    per-request speculation ledger folded in). Retry/preempt/quarantine
    point events tally counts; a quarantine finalizes the trace with
    ``finish="error"``. A stint that ends without its span — a
    preemption's decode (``serve_request_preempted``), or what a drain or
    a failover cut (``serve_request_detached``: decode, or a chunked
    prefill's compute and wait) — rides its point event's attrs and is
    added to its phase, so a request resumed elsewhere under its id keeps
    one whole trace.

    A completed trace's phases **provably sum to its measured
    latency**: ``latency_s = t_done - t_submit`` and
    ``unattributed_s = latency_s - (queue_s + prefill_s +
    prefill_wait_s + decode_s)`` is carried explicitly (|unattributed|
    stays within 5% of latency).
    ``phases`` breaks the wall down one level further — ``draft`` and
    ``block_stall`` are carved OUT of the decode wall, so the
    ``dominant_phase`` names the actual cause ("queue", "prefill",
    "prefill_wait", "block_stall", "draft", "decode", "unattributed").

    Completed traces land in a bounded ring (``SPARKDL_TRACE_RING``,
    default 256) and the slowest ``SPARKDL_TRACE_SLOWEST`` (default 8)
    are kept sorted for the snapshot exporter — the tail evidence
    survives SIGKILL via the atomic latest-snapshot file. Thread-safe.
    """

    def __init__(self, ring_size: int | None = None,
                 slowest_n: int | None = None):
        self._ring: collections.deque = collections.deque(
            maxlen=ring_size if ring_size is not None
            else _trace_ring_default())
        self._slowest_n = slowest_n if slowest_n is not None \
            else _trace_slowest_default()
        self._slowest: list[dict] = []  # sorted desc by latency_s
        self._open: dict = {}           # request id -> folding state
        self._completed = 0
        self._latency_sum = 0.0
        self._lock = threading.Lock()

    # -- tee callback -----------------------------------------------------
    def on_event(self, rec: dict):
        name = rec.get("name")
        if not isinstance(name, str) or not name.startswith("serve_"):
            return
        if name == "serve_request":
            # The request's causal envelope span: pure trace
            # parentage, emitted at retirement AFTER serve_decode already
            # finalized the trace — folding it would re-open a completed
            # request's state and leak it as a forever-open trace.
            return
        rid = rec.get("request")
        if rid is None:
            return  # engine-scoped serve_* events carry no request id
        ph = rec.get("ph")
        t = rec.get("t")
        t = float(t) if isinstance(t, (int, float)) else 0.0
        dur = rec.get("dur_s")
        dur = float(dur) if isinstance(dur, (int, float)) and dur > 0 \
            else 0.0
        with self._lock:
            tr = self._open.get(rid)
            if tr is None:
                if len(self._open) >= _MAX_OPEN_TRACES:
                    # leak guard for half-traced streams: drop the
                    # stalest fold state (insertion order = age)
                    self._open.pop(next(iter(self._open)))
                tr = self._open[rid] = {
                    "request": rid, "t_submit": None, "queue_s": 0.0,
                    "prefill_s": 0.0, "prefill_wait_s": 0.0,
                    "decode_s": 0.0, "draft_s": 0.0,
                    "block_stall_s": 0.0, "tokens_out": 0,
                    "reused_tokens": 0, "retries": 0, "preemptions": 0,
                    "spec_windows": 0, "spec_drafted": 0,
                    "spec_accepted": 0, "ttft_s": None}
            if name == "serve_queue" and ph == "E":
                tr["queue_s"] += dur
                if tr["t_submit"] is None:
                    tr["t_submit"] = t - dur
            elif name == "serve_prefill" and ph == "E":
                tr["prefill_s"] += dur
                w = rec.get("wait_s")
                if isinstance(w, (int, float)) and w > 0:
                    tr["prefill_wait_s"] += float(w)
                r = rec.get("reused")
                if isinstance(r, (int, float)):
                    tr["reused_tokens"] = max(tr["reused_tokens"], int(r))
                if "error" not in rec and tr["ttft_s"] is None \
                        and tr["t_submit"] is not None:
                    # the first token is delivered at prefill completion
                    tr["ttft_s"] = round(t - tr["t_submit"], 6)
            elif name == "serve_decode" and ph == "E":
                tr["decode_s"] += dur
                for k in ("draft_s", "block_stall_s"):
                    v = rec.get(k)
                    if isinstance(v, (int, float)) and v > 0:
                        tr[k] += float(v)
                for k in ("spec_windows", "spec_drafted",
                          "spec_accepted", "preemptions"):
                    v = rec.get(k)
                    if isinstance(v, (int, float)):
                        tr[k] = int(v)
                rows = rec.get("rows")
                if isinstance(rows, (int, float)):
                    tr["tokens_out"] = int(rows)
                self._finalize(tr, t, str(rec.get("reason") or "done"))
            elif name in ("serve_prefill_retry",
                          "serve_prefill_chunk_retry",
                          "serve_reserve_retry"):
                tr["retries"] += 1
            elif name in ("serve_request_preempted",
                          "serve_request_detached"):
                # the aborted stint's walls: a preemption's decode, or
                # what a drain or failover cut (decode, or a chunked
                # prefill's compute and wait)
                tr["preemptions"] += name == "serve_request_preempted"
                for k, into in (("decode_s", "decode_s"),
                                ("prefill_s", "prefill_s"),
                                ("wait_s", "prefill_wait_s")):
                    v = rec.get(k)
                    if isinstance(v, (int, float)) and v > 0:
                        tr[into] += float(v)
            elif name == "serve_request_quarantined":
                self._finalize(tr, t, "error")

    def _finalize(self, tr: dict, t_done: float, finish: str):
        """Caller holds the lock: close the fold state into a completed
        trace, append to the ring, update the slowest-N list."""
        self._open.pop(tr["request"], None)
        tr["finish"] = finish
        attributed = (tr["queue_s"] + tr["prefill_s"]
                      + tr["prefill_wait_s"] + tr["decode_s"])
        if tr["t_submit"] is not None:
            lat = max(0.0, t_done - tr["t_submit"])
        else:
            # ring/stream truncation ate the serve_queue span: the best
            # honest latency is the attributed time, flagged partial
            lat = attributed
            tr["partial"] = True
        tr["latency_s"] = round(lat, 6)
        tr["unattributed_s"] = round(lat - attributed, 6)
        tr["t_done"] = round(t_done, 6)
        if tr["t_submit"] is not None:
            tr["t_submit"] = round(tr["t_submit"], 6)
        if tr["spec_windows"] > 0:
            # committed tokens per verify window = accepted drafts + the
            # target's own token — the mean accept length observable
            tr["spec_mean_accept_len"] = round(
                (tr["spec_accepted"] + tr["spec_windows"])
                / tr["spec_windows"], 3)
        decode_compute = max(
            0.0, tr["decode_s"] - tr["draft_s"] - tr["block_stall_s"])
        phases = {
            "queue": tr["queue_s"], "prefill": tr["prefill_s"],
            "prefill_wait": tr["prefill_wait_s"],
            "block_stall": tr["block_stall_s"], "draft": tr["draft_s"],
            "decode": decode_compute,
            "unattributed": max(0.0, tr["unattributed_s"]),
        }
        tr["phases"] = {k: round(v, 6) for k, v in phases.items()}
        tr["dominant_phase"] = max(phases, key=phases.get)
        for k in ("queue_s", "prefill_s", "prefill_wait_s", "decode_s",
                  "draft_s", "block_stall_s"):
            tr[k] = round(tr[k], 6)
        self._completed += 1
        self._latency_sum += lat
        self._ring.append(tr)
        s = self._slowest
        s.append(tr)
        s.sort(key=lambda x: -x["latency_s"])
        del s[self._slowest_n:]

    # -- views ------------------------------------------------------------
    def traces(self) -> list[dict]:
        """Completed traces still in the ring, oldest first."""
        with self._lock:
            return [dict(t) for t in self._ring]

    def slowest(self) -> list[dict]:
        """The slowest completed traces seen (ever — not ring-bounded),
        highest latency first."""
        with self._lock:
            return [dict(t) for t in self._slowest]

    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def summary(self) -> dict | None:
        """The ``request_traces`` snapshot block: counts + the slowest-N
        traces (these survive SIGKILL via the exporter's atomic
        latest-snapshot file). None when nothing serving-shaped has been
        seen — non-serving snapshots stay clean."""
        with self._lock:
            if not self._completed and not self._open:
                return None
            return {
                "completed": self._completed,
                "open": len(self._open),
                "in_ring": len(self._ring),
                "latency_sum_s": round(self._latency_sum, 6),
                "slowest": [dict(t) for t in self._slowest],
            }


def assemble_request_traces(records, ring_size: int = 1_000_000
                            ) -> RequestTraceCollector:
    """Offline trace assembly: run a span stream (e.g. the records of
    an ``events_rank{i}.jsonl`` stream) through a fresh collector and
    return it. Records are time-sorted first so multi-rank merges fold
    in emission order. This is THE one fold implementation — the live
    tee and an offline reader cannot drift apart."""
    col = RequestTraceCollector(ring_size=ring_size, slowest_n=64)
    for rec in sorted(records, key=lambda r: r.get("t", 0.0)
                      if isinstance(r.get("t"), (int, float)) else 0.0):
        col.on_event(rec)
    return col


# ---------------------------------------------------------------------------
# The process-global plane
# ---------------------------------------------------------------------------

class _Plane:
    """One process's telemetry plane: registry + accountant + exporter
    thread + optional HTTP endpoint. Managed through the module-level
    start()/stop() — tests may build private instances."""

    def __init__(self):
        self.registry = MetricsRegistry()
        self.accountant = StageAccountant()
        self.traces = RequestTraceCollector()
        self.metrics_dir: str | None = None
        self.port: int | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._server = None
        self._server_thread = None
        self._started = False
        self._t_started: float | None = None  # /healthz uptime anchor
        self._lock = threading.Lock()
        # write_snapshot has two same-process callers (the exporter tick
        # and flush_snapshot, from a boundary or atexit) and the
        # atomic tmp file is only pid-tagged — serialize them or a race
        # can publish a torn latest-file.
        self._snap_lock = threading.Lock()
        self._history_bytes: int | None = None  # seeded from disk on
        self._history_capped = False            # first append

    # -- snapshot ---------------------------------------------------------
    def snapshot(self) -> dict:
        snap = {"t": round(time.time(), 6), "rank": events._rank(),
                "pid": os.getpid()}
        snap.update(self.accountant.snapshot())
        reg = self.registry.snapshot()
        for k in ("counters", "gauges", "histograms"):
            if reg[k]:
                snap[k] = reg[k]
        traces = self.traces.summary()
        if traces:
            snap["request_traces"] = traces
        # SLO evaluation rides the snapshot cadence (every exporter
        # tick + the boundary flushes, INCLUDING stop()'s final flush,
        # which runs after _started drops): the monitor diffs this
        # snapshot's cumulative histograms/counters against its window
        # history. It self-gates — armed only by SPARKDL_SLO_* env
        # knobs (unarmed = one cached-global read), and its gauges gate
        # on telemetry.enabled(), so the off-plane zero-registration
        # pin holds either way.
        try:
            from . import slo
            block = slo.evaluate(snap)
            if block:
                snap["slo"] = block
        except Exception:  # noqa: BLE001 — telemetry must never
            pass           # kill the exporter or a boundary flush
        return snap

    def write_snapshot(self) -> str | None:
        """One export tick: atomic latest-file + one JSONL history line.
        Never raises — a torn-down tmpdir must not kill the exporter (or,
        on the final flush, the job)."""
        d = self.metrics_dir
        if not d:
            return None
        snap = self.snapshot()
        rank = snap["rank"]
        try:
            with self._snap_lock:
                os.makedirs(d, exist_ok=True)
                path = events.atomic_write_json(
                    os.path.join(d, f"metrics_rank{rank}.json"), snap)
                self._append_history(d, rank, snap)
            return path
        except OSError:
            return None

    def _append_history(self, d: str, rank: int, snap: dict):
        """One JSONL history line, bounded by ``SPARKDL_METRICS_MAX_MB``
        (same disk-safety rule as the event stream's SPARKDL_EVENT_MAX_MB:
        a multi-day run must not fill the volume). The atomic latest-file
        keeps updating past the cap; the marker line makes the truncation
        visible to history readers. Caller holds ``_snap_lock``."""
        if self._history_capped:
            return
        hpath = os.path.join(d, f"metrics_rank{rank}.jsonl")
        if self._history_bytes is None:
            # Seed from on-disk size so restart loops appending to the
            # same file can't grow it N_attempts x cap.
            try:
                self._history_bytes = os.path.getsize(hpath)
            except OSError:
                self._history_bytes = 0
        # len() == encoded bytes: json.dumps defaults to ensure_ascii.
        line = json.dumps(snap, default=str) + "\n"
        capped = self._history_bytes + len(line) > _history_cap_bytes()
        with open(hpath, "a") as f:
            if capped:
                self._history_capped = True
                f.write(json.dumps(
                    {"t": round(time.time(), 6),
                     "name": "metrics_history_truncated", "rank": rank,
                     "cap_mb": _history_cap_bytes() // 2 ** 20}) + "\n")
            else:
                f.write(line)
                self._history_bytes += len(line)

    # -- exporter loop ----------------------------------------------------
    def _run_exporter(self):
        interval = export_interval_default()
        while not self._stop.wait(interval):
            self.write_snapshot()
        self.write_snapshot()  # final flush on clean stop

    # -- lifecycle --------------------------------------------------------
    def start(self, metrics_dir: str | None = None, port: int | None = None):
        with self._lock:
            if self._started:
                return self
            self._started = True
            self._t_started = time.time()
            self.metrics_dir = metrics_dir
            self._history_bytes = None   # re-seed from the (possibly
            self._history_capped = False  # new) dir's on-disk state
            events.add_tee(self.accountant.on_event)
            events.add_tee(self.traces.on_event)
            if metrics_dir:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run_exporter, daemon=True,
                    name="sparkdl-metrics-export")
                self._thread.start()
            if port is not None:
                self._start_server(port)
        return self

    def _start_server(self, port: int):
        try:
            from http.server import BaseHTTPRequestHandler, \
                ThreadingHTTPServer
            plane = self

            class _Handler(BaseHTTPRequestHandler):
                def do_GET(self):  # noqa: N802 — stdlib contract
                    if self.path.startswith("/metrics.json"):
                        body = json.dumps(plane.snapshot(),
                                          default=str).encode()
                        ctype = "application/json"
                    elif self.path.startswith("/metrics"):
                        body = render_prometheus(plane.snapshot()).encode()
                        ctype = "text/plain; version=0.0.4"
                    elif self.path.startswith("/serving"):
                        # Live engine inspector: every
                        # registered GenerationEngine's slot table /
                        # queue / KV pool / speculation state, mid-run.
                        # Same degrade-never-kill posture as the rest of
                        # the plane: an inspector failure answers as an
                        # error body, never takes the endpoint down.
                        try:
                            from ..serving import introspect
                            body = json.dumps(introspect.serving_snapshot(),
                                              default=str).encode()
                        except Exception as e:  # noqa: BLE001
                            body = json.dumps(
                                {"error":
                                 f"{type(e).__name__}: {e}"[:300]}).encode()
                        ctype = "application/json"
                    elif self.path.startswith("/healthz"):
                        # Liveness probe: cheap 200 that
                        # never touches the registry — orchestrators
                        # poll it at a rate /metrics shouldn't pay.
                        t0 = plane._t_started
                        body = json.dumps(
                            {"status": "ok", "pid": os.getpid(),
                             "rank": events._rank(),
                             "uptime_s": round(time.time() - t0, 3)
                             if t0 is not None else None}).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

                def log_message(self, *a):  # scrapes must not spam stderr
                    pass

            self._server = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
            self.port = self._server.server_port  # resolved (port=0 → real)
            self._server_thread = threading.Thread(
                target=self._server.serve_forever, daemon=True,
                name="sparkdl-metrics-http")
            self._server_thread.start()
        except OSError as e:
            # A taken port must degrade to no-endpoint, never kill the
            # job — same rule as a bad compile-cache path.
            log.warning("metrics endpoint disabled: cannot bind port %s "
                        "(%s)", port, e)
            self._server = None
            self.port = None

    def stop(self):
        with self._lock:
            if not self._started:
                return
            self._started = False
            events.remove_tee(self.accountant.on_event)
            events.remove_tee(self.traces.on_event)
            self._stop.set()
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)  # its loop flushes the final snapshot
        else:
            self.write_snapshot()  # no exporter thread: flush inline
        srv, self._server = self._server, None
        if srv is not None:
            try:
                srv.shutdown()
                srv.server_close()
            except OSError:
                pass


_PLANE: _Plane | None = None
_plane_lock = threading.Lock()
_atexit_registered = False


def _get_plane() -> _Plane:
    global _PLANE
    with _plane_lock:
        if _PLANE is None:
            _PLANE = _Plane()
        return _PLANE


def enabled() -> bool:
    """True when the plane is armed in this process — the gate every
    hot-path gauge update checks (one global read + attr when off)."""
    p = _PLANE
    return p is not None and p._started


def registry() -> MetricsRegistry:
    return _get_plane().registry


def accountant() -> StageAccountant:
    return _get_plane().accountant


def fleet_metric(event: str, value: float = 1.0):
    """Fleet-tier metric exports, registered HERE with literal names so
    every fleet metric is at one grep-able site. ``event``: ``"healthy"`` sets the
    ``fleet_replicas_healthy`` gauge to ``value``; the counter events
    (``hedge_fired`` / ``hedge_won`` / ``readmitted`` / ``shed``)
    increment by ``value``. No-op while the plane is off — the same
    zero-overhead contract as the engine's ``_metric`` helper."""
    if not enabled():
        return
    reg = registry()
    if event == "healthy":
        reg.gauge("fleet_replicas_healthy").set(value)
    elif event == "hedge_fired":
        reg.counter("fleet_hedges_fired_total").inc(value)
    elif event == "hedge_won":
        reg.counter("fleet_hedges_won_total").inc(value)
    elif event == "readmitted":
        reg.counter("fleet_readmissions_total").inc(value)
    elif event == "shed":
        reg.counter("fleet_requests_shed_total").inc(value)


def request_traces() -> RequestTraceCollector:
    """The plane's live request-trace collector. It only
    observes events while the plane is armed — with the plane off the
    tee is never registered and the collector stays empty."""
    return _get_plane().traces


def server_port() -> int | None:
    """The HTTP endpoint's resolved port (``SPARKDL_METRICS_PORT=0``
    binds an ephemeral one), or None when no endpoint is up."""
    p = _PLANE
    return p.port if p is not None else None


def start(metrics_dir: str | None = None, port: int | None = None):
    """Arm the telemetry plane: tee the stage accountant onto the flight
    recorder, start the snapshot exporter when ``metrics_dir`` is given,
    and serve Prometheus text on ``port`` when given (0 = ephemeral;
    read it back with :func:`server_port`). Idempotent. A final snapshot
    is flushed at interpreter exit (atexit) and on :func:`stop`."""
    global _atexit_registered
    plane = _get_plane()
    plane.start(metrics_dir=metrics_dir, port=port)
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(_final_flush)
    return plane


def _final_flush():
    p = _PLANE
    if p is not None and p._started:
        p.write_snapshot()


def stop():
    """Disarm the plane: final snapshot flushed, exporter joined, HTTP
    endpoint closed, the tee removed. Idempotent."""
    p = _PLANE
    if p is not None:
        p.stop()


def reset():
    """Fresh plane (tests): stop the current one and drop its books."""
    global _PLANE
    stop()
    with _plane_lock:
        _PLANE = None


def maybe_start_from_env() -> bool:
    """Env-driven arm: start the plane iff ``SPARKDL_METRICS_DIR`` or
    ``SPARKDL_METRICS_PORT`` is set. With neither var set this is two
    dict lookups, and the overhead-bounded test pins that the disabled
    plane registers nothing."""
    if enabled():
        return True
    d = os.environ.get(METRICS_DIR_ENV)
    port_s = os.environ.get(METRICS_PORT_ENV)
    if not d and not port_s:
        return False
    port = None
    if port_s:
        try:
            port = int(port_s)
        except ValueError:
            log.warning("ignoring unparseable %s=%r", METRICS_PORT_ENV,
                        port_s)
    if not d and port is None:
        # Only an unparseable port: arming would register the tee and pay
        # accountant work with no exporter and no endpoint — all overhead,
        # no telemetry.
        return False
    start(metrics_dir=d or None, port=port)
    return True


def snapshot() -> dict:
    return _get_plane().snapshot()


def flush_snapshot() -> str | None:
    """Write the current snapshot now, so the on-disk view is exact at
    a boundary (the end of a run), not one export interval stale."""
    p = _PLANE
    return p.write_snapshot() if p is not None and p._started else None


# ---------------------------------------------------------------------------
# Prometheus rendering
# ---------------------------------------------------------------------------

def _prom_escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _metric_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", name)


def render_prometheus(snap: dict, prefix: str = "sparkdl") -> str:
    """Render one snapshot in Prometheus text exposition format. Stage
    books become ``sparkdl_stage_*{stage="..."}`` families; registry
    counters/gauges/histograms keep their registered names."""
    lines: list[str] = []
    rank = snap.get("rank", 0)

    def fam(name, mtype, rows):
        full = f"{prefix}_{_metric_name(name)}"
        lines.append(f"# TYPE {full} {mtype}")
        for labels, value in rows:
            lab = dict(labels)
            lab.setdefault("rank", rank)
            lab_s = ",".join(f'{k}="{_prom_escape(str(v))}"'
                             for k, v in sorted(lab.items()))
            lines.append(f"{full}{{{lab_s}}} {value}")

    stages = snap.get("stages") or {}
    for key, fam_name, mtype in (
            ("busy_s", "stage_busy_seconds", "counter"),
            ("wall_busy_s", "stage_wall_busy_seconds", "counter"),
            ("busy_frac", "stage_busy_frac", "gauge"),
            ("count", "stage_count", "counter"),
            ("rows", "stage_rows", "counter"),
            ("bytes", "stage_bytes", "counter"),
            ("errors", "stage_errors", "counter"),
            ("active", "stage_active", "gauge"),
            ("max_concurrency", "stage_max_concurrency", "gauge")):
        fam(fam_name, mtype,
            [({"stage": s}, v.get(key, 0)) for s, v in sorted(
                stages.items())])
    if snap.get("elapsed_s") is not None:
        fam("stream_elapsed_seconds", "gauge", [({}, snap["elapsed_s"])])
    for name, n in sorted((snap.get("events") or {}).items()):
        fam(f"events_{name}_total", "counter", [({}, n)])
    for name, c in sorted((snap.get("counters") or {}).items()):
        fam(f"{name}_total", "counter", [({}, c)])
    for name, g in sorted((snap.get("gauges") or {}).items()):
        fam(name, "gauge", [({}, g.get("value", 0))])
        fam(f"{name}_max", "gauge", [({}, g.get("max", 0))])
    for name, h in sorted((snap.get("histograms") or {}).items()):
        full = f"{prefix}_{_metric_name(name)}"
        # Label values MUST be quoted (rank="0") — an unquoted one fails
        # the whole scrape, taking every other family down with it.
        lines.append(f"# TYPE {full} histogram")
        for bound, n in zip(h.get("bounds", []), h.get("buckets", [])):
            lines.append(
                f'{full}_bucket{{le="{bound}",rank="{rank}"}} {n}')
        lines.append(f'{full}_bucket{{le="+Inf",rank="{rank}"}} '
                     f'{h.get("count", 0)}')
        lines.append(f'{full}_sum{{rank="{rank}"}} {h.get("sum", 0)}')
        lines.append(f'{full}_count{{rank="{rank}"}} {h.get("count", 0)}')
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Gang-level aggregation (supervisor side — must stay jax-free)
# ---------------------------------------------------------------------------

def clear_rank_files(metrics_dir: str):
    """Remove one attempt's snapshot files before relaunch (the same
    staleness rule as ``events.clear_rank_files``): attempt N's gang view
    must not average in attempt N-1's books — or a dead earlier gang's
    high-rank snapshot from a larger world size."""
    try:
        names = os.listdir(metrics_dir)
    except OSError:
        return
    for fn in names:
        if _SNAPSHOT_FILE_RE.match(fn) or \
                re.match(r"metrics_rank\d+\.jsonl$", fn):
            try:
                os.unlink(os.path.join(metrics_dir, fn))
            except OSError:
                pass


def aggregate_snapshots(metrics_dir: str) -> dict | None:
    """Merge every rank's latest snapshot into one gang-level view:
    per-stage books summed across ranks (busy/rows/bytes/count; wall-busy
    sums too — it is per-rank wall, so the gang figure is slot-seconds of
    rank-walls), ``busy_frac`` recomputed against the widest rank's
    elapsed, registry counters summed, gauges max'd. None when the dir
    holds no parseable snapshots."""
    try:
        names = sorted(os.listdir(metrics_dir))
    except OSError:
        return None
    ranks: dict[int, dict] = {}
    for fn in names:
        m = _SNAPSHOT_FILE_RE.match(fn)
        if not m:
            continue
        try:
            with open(os.path.join(metrics_dir, fn)) as f:
                ranks[int(m.group(1))] = json.load(f)
        except (OSError, ValueError):
            continue
    if not ranks:
        # Supervised gangs export one level down (the same gang-* subdir
        # isolation event streams get): fall back to the newest such
        # subdir so pointing the report at $SPARKDL_METRICS_DIR itself
        # still finds the run. Newest only — merging attempts/gangs
        # would double-count.
        gang_dirs = [os.path.join(metrics_dir, fn) for fn in names
                     if fn.startswith("gang-")
                     and os.path.isdir(os.path.join(metrics_dir, fn))]
        gang_dirs.sort(key=lambda p: os.path.getmtime(p), reverse=True)
        for gd in gang_dirs:
            agg = aggregate_snapshots(gd)
            if agg is not None:
                return agg
        return None
    elapsed = max((s.get("elapsed_s") or 0.0) for s in ranks.values())
    stages: dict[str, dict] = {}
    events_total: dict[str, int] = {}
    counters: dict[str, float] = {}
    gauges: dict[str, dict] = {}
    histograms: dict[str, dict] = {}
    traces = {"completed": 0, "open": 0, "slowest": []}
    for snap in ranks.values():
        tb = snap.get("request_traces") or {}
        if tb:
            traces["completed"] += int(tb.get("completed") or 0)
            traces["open"] += int(tb.get("open") or 0)
            traces["slowest"].extend(tb.get("slowest") or [])
        for name, st in (snap.get("stages") or {}).items():
            agg = stages.setdefault(name, {
                "count": 0, "busy_s": 0.0, "wall_busy_s": 0.0, "rows": 0,
                "bytes": 0, "errors": 0, "max_concurrency": 0})
            for k in ("count", "rows", "bytes", "errors"):
                agg[k] += int(st.get(k) or 0)
            for k in ("busy_s", "wall_busy_s"):
                agg[k] = round(agg[k] + float(st.get(k) or 0.0), 6)
            agg["max_concurrency"] = max(agg["max_concurrency"],
                                         int(st.get("max_concurrency")
                                             or 0))
        for name, n in (snap.get("events") or {}).items():
            events_total[name] = events_total.get(name, 0) + int(n)
        for name, c in (snap.get("counters") or {}).items():
            counters[name] = counters.get(name, 0.0) + float(c)
        for name, g in (snap.get("gauges") or {}).items():
            cur = gauges.setdefault(name, {"value": 0.0, "max": 0.0})
            cur["value"] = max(cur["value"], float(g.get("value") or 0.0))
            cur["max"] = max(cur["max"], float(g.get("max") or 0.0))
        for name, h in (snap.get("histograms") or {}).items():
            bounds = list(h.get("bounds") or [])
            agg = histograms.setdefault(name, {
                "bounds": bounds, "buckets": [0] * len(bounds),
                "count": 0, "sum": 0.0})
            if agg["bounds"] != bounds:
                # Bucket layouts must agree to merge cumulative counts
                # (all ranks share the registry defaults; a custom
                # mismatch is skipped rather than summed into nonsense).
                continue
            agg["buckets"] = [a + int(b) for a, b in
                              zip(agg["buckets"], h.get("buckets") or [])]
            agg["count"] += int(h.get("count") or 0)
            agg["sum"] = round(agg["sum"] + float(h.get("sum") or 0.0), 6)
    n_ranks = len(ranks)
    for name, st in stages.items():
        # Gang busy fraction: wall-busy summed over ranks against the
        # gang's total rank-walls — "what fraction of the gang's rank
        # time was this stage busy".
        denom = elapsed * n_ranks
        st["busy_frac"] = round(min(1.0, st["wall_busy_s"] / denom), 4) \
            if denom > 0 else 0.0
    out = {"n_ranks": n_ranks, "elapsed_s": round(elapsed, 6),
           "stages": stages,
           "per_rank": {str(r): {"t": s.get("t"),
                                 "elapsed_s": s.get("elapsed_s")}
                        for r, s in sorted(ranks.items())}}
    if events_total:
        out["events"] = events_total
    if counters:
        out["counters"] = counters
    if gauges:
        out["gauges"] = gauges
    if histograms:
        out["histograms"] = histograms
    if traces["completed"] or traces["open"]:
        # gang view of the request-trace tail: slowest across ranks,
        # re-ranked to the same SPARKDL_TRACE_SLOWEST bound each rank's
        # export honors
        traces["slowest"].sort(
            key=lambda t: -(t.get("latency_s") or 0.0))
        del traces["slowest"][_trace_slowest_default():]
        out["request_traces"] = traces
    return out


# ---------------------------------------------------------------------------
# meter.summary() block
# ---------------------------------------------------------------------------

def stage_utilization_summary() -> dict | None:
    """The ``stage_utilization`` block for ``meter.summary()``: per-stage
    busy fraction / slot-seconds / rows from the live accountant, with
    the dominant stage named. None when the plane is off or has seen no
    spans — clean summaries stay clean."""
    p = _PLANE
    if p is None or not p._started:
        return None
    snap = p.accountant.snapshot()
    stages = snap.get("stages") or {}
    if not stages:
        return None
    dominant = max(stages, key=lambda s: stages[s]["busy_frac"])
    return {
        "elapsed_s": snap["elapsed_s"],
        "dominant_stage": dominant,
        "stages": {name: {k: st[k] for k in
                          ("busy_s", "wall_busy_s", "busy_frac", "count",
                           "rows", "bytes", "max_concurrency")}
                   for name, st in stages.items()},
    }
