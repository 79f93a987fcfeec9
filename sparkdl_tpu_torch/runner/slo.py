"""SLO burn-rate monitoring for the serving tier.

The port's copy of ``sparkdl_tpu/runner/slo.py``, whole. Stdlib only,
like the rest of the runner's observability stack: it imports no torch.

The telemetry plane can say "TTFT p99 is 1.8 s"; this module says
whether that is *okay*: objectives are declared with ``SPARKDL_SLO_*``
env knobs, evaluated as **multi-window burn rates** off the cumulative
histograms/counters the serving engine already exports
(``serving_ttft_s``, ``serving_request_latency_s``,
``serving_requests_quarantined_total`` / ``_completed_total``), and
surfaced three ways: compliance/burn-rate **gauges** in the registry, an
``slo`` block in every telemetry snapshot, and **flight-recorder breach
events** (``slo_breach`` / ``slo_recovered``).

Objectives (each armed by setting its knob; none set = monitor off,
zero gauges registered):

- ``SPARKDL_SLO_TTFT_S``     — TTFT objective: a fraction >=
  ``SPARKDL_SLO_TARGET`` (default 0.99) of requests must see their
  first token within the threshold.
- ``SPARKDL_SLO_LATENCY_S``  — same shape for end-to-end request
  latency.
- ``SPARKDL_SLO_ERROR_RATE`` — the windowed fraction of requests that
  quarantine must stay below this rate.

**Burn rate** is the SRE error-budget derivative: with target
compliance ``T``, the budget is ``1 - T`` and ``burn =
(1 - compliance) / (1 - T)`` — burn 1.0 consumes the budget exactly as
fast as sustainable, 10 means ten times too fast. Each objective is
evaluated over every window in ``SPARKDL_SLO_WINDOWS_S`` (default
``60,300`` seconds) by diffing the cumulative snapshot against the
monitor's history ring; an objective **breaches** when EVERY window
with traffic burns at >= ``SPARKDL_SLO_BURN_THRESHOLD`` (default 1.0)
— the classic multi-window gate: the short window proves the problem
is *current*, the long one that it is not a blip.

Evaluation is driven by the telemetry plane's snapshot cadence
(``_Plane.snapshot`` calls :func:`evaluate` on every exporter tick and
boundary flush), so the monitor costs nothing between snapshots and
nothing at all when the plane is off. :class:`ReplicaBurnTracker` is the
fleet router's per-replica twin, fed with the samples the router
observes.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from . import events
from .telemetry import histogram_fraction_below

__all__ = [
    "SLO_TTFT_ENV", "SLO_LATENCY_ENV", "SLO_ERROR_RATE_ENV",
    "SLO_TARGET_ENV", "SLO_WINDOWS_ENV", "SLO_BURN_ENV",
    "Objective", "SloMonitor", "ReplicaBurnTracker",
    "objectives_from_env", "from_env",
    "monitor", "evaluate", "enabled", "reset", "compliance_from_traces",
]

SLO_TTFT_ENV = "SPARKDL_SLO_TTFT_S"
SLO_LATENCY_ENV = "SPARKDL_SLO_LATENCY_S"
SLO_ERROR_RATE_ENV = "SPARKDL_SLO_ERROR_RATE"
SLO_TARGET_ENV = "SPARKDL_SLO_TARGET"
SLO_WINDOWS_ENV = "SPARKDL_SLO_WINDOWS_S"
SLO_BURN_ENV = "SPARKDL_SLO_BURN_THRESHOLD"

_DEFAULT_TARGET = 0.99
_DEFAULT_WINDOWS = (60.0, 300.0)
_DEFAULT_BURN = 1.0
_TTFT_HIST = "serving_ttft_s"
_LATENCY_HIST = "serving_request_latency_s"
_ERROR_COUNTER = "serving_requests_quarantined_total"
_COMPLETED_COUNTER = "serving_requests_completed_total"


def _env_float(name: str, default):
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


class Objective:
    """One declared objective. ``kind`` is ``"histogram"`` (compliance =
    fraction of observations <= ``threshold``, target =
    ``SPARKDL_SLO_TARGET``) or ``"error_rate"`` (compliance = 1 -
    windowed error fraction, target = ``1 - max_rate``)."""

    __slots__ = ("name", "kind", "source", "threshold", "target")

    def __init__(self, name: str, kind: str, source: str,
                 threshold: float, target: float):
        self.name = name
        self.kind = kind
        self.source = source
        self.threshold = float(threshold)
        self.target = min(0.999999, max(0.0, float(target)))

    def describe(self) -> dict:
        d = {"kind": self.kind, "target": round(self.target, 6)}
        if self.kind == "histogram":
            d["threshold_s"] = self.threshold
        else:
            d["max_error_rate"] = self.threshold
        return d


def objectives_from_env() -> list[Objective]:
    """The objectives the environment declares (empty list = monitor
    off). ``SPARKDL_SLO_TARGET`` applies to the latency-shaped
    objectives; the error objective's target derives from its own
    rate knob."""
    target = _env_float(SLO_TARGET_ENV, _DEFAULT_TARGET)
    out: list[Objective] = []
    ttft = _env_float(SLO_TTFT_ENV, None)
    if ttft is not None and ttft > 0:
        out.append(Objective("ttft", "histogram", _TTFT_HIST, ttft,
                             target))
    lat = _env_float(SLO_LATENCY_ENV, None)
    if lat is not None and lat > 0:
        out.append(Objective("latency", "histogram", _LATENCY_HIST, lat,
                             target))
    err = _env_float(SLO_ERROR_RATE_ENV, None)
    if err is not None and 0 < err < 1:
        out.append(Objective("errors", "error_rate", _ERROR_COUNTER, err,
                             1.0 - err))
    return out


def _windows_from_env():
    raw = os.environ.get(SLO_WINDOWS_ENV, "")
    windows = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            w = float(part)
        except ValueError:
            continue
        if w > 0:
            windows.append(w)
    return tuple(sorted(windows)) or _DEFAULT_WINDOWS


# Literal gauge registrations per objective (not f-strings), so every
# exported metric name can be found by a grep.
def _set_gauges(reg, name: str, compliance, burn):
    # No-traffic objectives register NOTHING: creating the gauge before
    # the None check would export a default 0.0 — "0% compliant", a
    # page-the-oncall signal, when the truth is "no data".
    if name == "ttft":
        if compliance is not None:
            reg.gauge("slo_ttft_compliance").set(round(compliance, 6))
        if burn is not None:
            reg.gauge("slo_ttft_burn_rate").set(round(burn, 4))
    elif name == "latency":
        if compliance is not None:
            reg.gauge("slo_latency_compliance").set(round(compliance, 6))
        if burn is not None:
            reg.gauge("slo_latency_burn_rate").set(round(burn, 4))
    elif name == "errors":
        if compliance is not None:
            reg.gauge("slo_errors_compliance").set(round(compliance, 6))
        if burn is not None:
            reg.gauge("slo_errors_burn_rate").set(round(burn, 4))


class SloMonitor:
    """Multi-window burn-rate evaluation over cumulative telemetry
    snapshots (see module doc). Feed it snapshots via
    :meth:`evaluate`; it keeps its own bounded history ring (one entry
    per evaluation, trimmed past the longest window) and carries breach
    state per objective so the flight-recorder event fires once per
    transition, not once per tick."""

    def __init__(self, objectives, windows_s=None,
                 burn_threshold: float | None = None):
        self.objectives = list(objectives)
        self.windows_s = tuple(sorted(windows_s)) if windows_s \
            else _windows_from_env()
        self.burn_threshold = burn_threshold if burn_threshold is not None \
            else _env_float(SLO_BURN_ENV, _DEFAULT_BURN)
        self._history: collections.deque = collections.deque()
        self._breaching: dict[str, bool] = {}
        self._lock = threading.Lock()

    # -- cumulative state extraction --------------------------------------
    def _state(self, snap: dict) -> dict:
        hists = snap.get("histograms") or {}
        counters = snap.get("counters") or {}
        state: dict = {"histograms": {}, "counters": {}}
        for obj in self.objectives:
            if obj.kind == "histogram":
                h = hists.get(obj.source)
                if h:
                    state["histograms"][obj.source] = {
                        "bounds": list(h.get("bounds") or []),
                        "buckets": list(h.get("buckets") or []),
                        "count": int(h.get("count") or 0)}
            else:
                state["counters"][obj.source] = float(
                    counters.get(obj.source) or 0.0)
                state["counters"][_COMPLETED_COUNTER] = float(
                    counters.get(_COMPLETED_COUNTER) or 0.0)
        return state

    @staticmethod
    def _hist_delta(cur: dict | None, base: dict | None) -> dict | None:
        """Window view of a cumulative histogram: current - base (the
        snapshot nearest the window's start). Buckets are monotone, so
        the diff is itself a valid cumulative histogram."""
        if not cur:
            return None
        if not base or base.get("bounds") != cur.get("bounds"):
            return cur
        return {"bounds": cur["bounds"],
                "buckets": [a - b for a, b in zip(cur["buckets"],
                                                  base["buckets"])],
                "count": cur["count"] - base["count"]}

    def _base_state(self, now: float, window: float) -> dict | None:
        """The newest history entry at or before the window start —
        diffing against it covers at LEAST the window (falling back to
        the oldest entry when history is still shorter than the
        window, i.e. the whole observed run)."""
        base = None
        for t, state in self._history:
            if t <= now - window:
                base = state
            else:
                break
        if base is None and self._history:
            base = self._history[0][1]
        return base

    # -- evaluation -------------------------------------------------------
    def evaluate(self, snap: dict, now: float | None = None) -> dict:
        now = float(snap.get("t") or time.time()) if now is None else now
        cur = self._state(snap)
        with self._lock:
            block: dict = {"windows_s": list(self.windows_s),
                           "burn_threshold": self.burn_threshold,
                           "objectives": {}}
            breaching_any = False
            for obj in self.objectives:
                ob = self._evaluate_objective(obj, cur, now)
                block["objectives"][obj.name] = ob
                breaching_any = breaching_any or ob["breaching"]
                self._note_transition(obj, ob)
            block["breaching"] = breaching_any
            self._history.append((now, cur))
            horizon = now - max(self.windows_s) - 1.0
            while len(self._history) > 1 and self._history[1][0] < horizon:
                self._history.popleft()
        self._export_gauges(block)
        return block

    def _evaluate_objective(self, obj: Objective, cur: dict,
                            now: float) -> dict:
        ob: dict = dict(obj.describe())
        windows: dict = {}
        burns: list = []
        for w in self.windows_s:
            base = self._base_state(now, w)
            if obj.kind == "histogram":
                delta = self._hist_delta(
                    cur["histograms"].get(obj.source),
                    (base or {}).get("histograms", {}).get(obj.source))
                total = int((delta or {}).get("count") or 0)
                compliance = histogram_fraction_below(
                    delta, obj.threshold) if total > 0 else None
            else:
                errs = cur["counters"].get(obj.source, 0.0) - \
                    ((base or {}).get("counters", {})
                     .get(obj.source, 0.0))
                done = cur["counters"].get(_COMPLETED_COUNTER, 0.0) - \
                    ((base or {}).get("counters", {})
                     .get(_COMPLETED_COUNTER, 0.0))
                total = int(errs + done)
                compliance = 1.0 - errs / total if total > 0 else None
            budget = 1.0 - obj.target
            burn = (1.0 - compliance) / budget \
                if compliance is not None and budget > 0 else None
            windows[f"{w:g}s"] = {
                "total": total,
                "compliance": None if compliance is None
                else round(compliance, 6),
                "burn_rate": None if burn is None else round(burn, 4),
            }
            burns.append(burn)
        ob["windows"] = windows
        with_data = [b for b in burns if b is not None]
        # the multi-window gate: current AND sustained — every window
        # that has traffic must be burning past the threshold, and at
        # least one window must have traffic at all
        ob["breaching"] = bool(with_data) and all(
            b >= self.burn_threshold for b in with_data)
        ob["burn_rate"] = min(with_data) if with_data else None
        shortest = windows[f"{self.windows_s[0]:g}s"]
        ob["compliance"] = shortest["compliance"]
        return ob

    def _note_transition(self, obj: Objective, ob: dict):
        was = self._breaching.get(obj.name, False)
        is_b = ob["breaching"]
        if is_b and not was:
            events.event("slo_breach", objective=obj.name,
                         burn_rate=ob["burn_rate"],
                         compliance=ob["compliance"],
                         **{k: v for k, v in ob.items()
                            if k in ("threshold_s", "max_error_rate",
                                     "target")})
        elif was and not is_b:
            events.event("slo_recovered", objective=obj.name,
                         compliance=ob["compliance"])
        self._breaching[obj.name] = is_b

    def _export_gauges(self, block: dict):
        try:
            from . import telemetry
            if not telemetry.enabled():
                return
            reg = telemetry.registry()
            for name, ob in block["objectives"].items():
                _set_gauges(reg, name, ob.get("compliance"),
                            ob.get("burn_rate"))
        except Exception:  # noqa: BLE001 — gauges are best-effort
            pass


class ReplicaBurnTracker:
    """Per-REPLICA burn rates for the fleet router: the
    process-global :class:`SloMonitor` evaluates ONE engine's cumulative
    telemetry, but replica health needs burn attributed to each replica
    separately — so the router feeds this tracker raw per-request
    samples (TTFT, latency, outcome) as it observes them and reads back
    windowed burn rates against the SAME ``SPARKDL_SLO_*`` objectives
    (:func:`objectives_from_env`). Single short window by design: the
    router reacts to *current* replica pain (a DEGRADED verdict is
    reversible), so the multi-window "sustained" gate that guards
    paging humans would only slow it down. No objectives armed = every
    read returns None and health falls back to the failover/heartbeat
    signals alone."""

    def __init__(self, objectives=None, window_s: float = 30.0):
        self.objectives = objectives_from_env() if objectives is None \
            else list(objectives)
        self.window_s = max(1.0, float(window_s))
        # (t, kind, value): kind "ttft"/"latency" carry seconds, kind
        # "outcome" carries 1.0 for an error, 0.0 for a completion
        self._samples: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def record_ttft(self, seconds: float, now: float | None = None):
        self._record("ttft", float(seconds), now)

    def record_latency(self, seconds: float, now: float | None = None):
        self._record("latency", float(seconds), now)

    def record_outcome(self, ok: bool, now: float | None = None):
        self._record("outcome", 0.0 if ok else 1.0, now)

    def _record(self, kind: str, value: float, now: float | None):
        now = time.time() if now is None else now
        with self._lock:
            self._samples.append((now, kind, value))
            self._trim(now)

    def _trim(self, now: float):
        horizon = now - self.window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

    def burn_rates(self, now: float | None = None) -> dict:
        """``{objective name: burn rate | None}`` over the window
        (None = no samples for that objective yet)."""
        now = time.time() if now is None else now
        with self._lock:
            self._trim(now)
            samples = list(self._samples)
        out: dict = {}
        for obj in self.objectives:
            if obj.kind == "histogram":
                kind = "ttft" if obj.name == "ttft" else "latency"
                vals = [v for _, k, v in samples if k == kind]
                compliance = (sum(1 for v in vals if v <= obj.threshold)
                              / len(vals)) if vals else None
            else:
                vals = [v for _, k, v in samples if k == "outcome"]
                compliance = (1.0 - sum(vals) / len(vals)) if vals \
                    else None
            budget = 1.0 - obj.target
            out[obj.name] = None if compliance is None or budget <= 0 \
                else round((1.0 - compliance) / budget, 4)
        return out

    def max_burn(self, now: float | None = None) -> float | None:
        """The worst objective's burn (the router's one-number health
        input); None when no objective has data (or none armed)."""
        burns = [b for b in self.burn_rates(now).values() if b is not None]
        return max(burns) if burns else None


# ---------------------------------------------------------------------------
# Process-global monitor (env-armed, resolved lazily like the plane)
# ---------------------------------------------------------------------------

_MONITOR: SloMonitor | None = None
_RESOLVED = False
_lock = threading.Lock()


def from_env() -> SloMonitor | None:
    objs = objectives_from_env()
    return SloMonitor(objs) if objs else None


def monitor() -> SloMonitor | None:
    """The process monitor, resolved once from the environment (None is
    cached too — an unarmed process pays two dict lookups once, then a
    single global read per snapshot)."""
    global _MONITOR, _RESOLVED
    with _lock:
        if not _RESOLVED:
            _MONITOR = from_env()
            _RESOLVED = True
        return _MONITOR


def enabled() -> bool:
    return monitor() is not None


def evaluate(snap: dict) -> dict | None:
    """One evaluation tick off a telemetry snapshot (the plane calls
    this from ``_Plane.snapshot``). None when no objective is armed."""
    m = monitor()
    return m.evaluate(snap) if m is not None else None


def reset():
    """Drop the cached monitor so the next call re-reads the env
    (tests; long-lived processes that re-arm objectives)."""
    global _MONITOR, _RESOLVED
    with _lock:
        _MONITOR = None
        _RESOLVED = False


# ---------------------------------------------------------------------------
# Offline compliance (request traces — exact, no bucket resolution)
# ---------------------------------------------------------------------------

def compliance_from_traces(traces, objectives=None) -> dict | None:
    """Whole-run compliance of assembled request traces against the
    declared objectives — the offline twin of the live monitor (exact
    per-request values, not histogram buckets). None when no objective
    is armed or no traces completed."""
    objs = objectives_from_env() if objectives is None else objectives
    traces = list(traces)
    if not objs or not traces:
        return None
    out: dict = {}
    for obj in objs:
        block = dict(obj.describe())
        if obj.name == "ttft":
            vals = [t.get("ttft_s") for t in traces
                    if t.get("ttft_s") is not None]
            good = sum(1 for v in vals if v <= obj.threshold)
            total = len(vals)
        elif obj.name == "latency":
            # mirror the live histogram's population exactly: the
            # engine observes serving_request_latency_s only at
            # _retire (completed requests) — quarantined traces
            # (submit→quarantine wall) and partial traces (fabricated
            # attributed-sum latency) must not skew the offline twin
            vals = [t.get("latency_s") for t in traces
                    if t.get("latency_s") is not None
                    and t.get("finish") != "error"
                    and not t.get("partial")]
            good = sum(1 for v in vals if v <= obj.threshold)
            total = len(vals)
        else:
            total = len(traces)
            good = sum(1 for t in traces if t.get("finish") != "error")
        block["total"] = total
        block["compliance"] = round(good / total, 6) if total else None
        if block["compliance"] is not None:
            block["met"] = block["compliance"] >= obj.target
        out[obj.name] = block
    return out
