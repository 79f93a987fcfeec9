"""Telemetry plane — the metrics registry the serving engine feeds.

The port's copy of ``sparkdl_tpu/runner/telemetry.py``, cut to what the
serving engine reaches: counters, gauges (with high-water marks) and
fixed-bucket histograms in one process-wide :class:`MetricsRegistry`,
the shared percentile derivation (:func:`histogram_quantile`), and the
on/off switch every hot-path update checks (:func:`enabled`). The JAX
package's stage accountant, request-trace collector, snapshot exporter,
HTTP endpoint and gang aggregation return with the slices that port
their readers (ROADMAP.md).

The plane is **opt-in and ≈ free when off**: until :func:`start` is
called, :func:`enabled` is one global read and the engine registers
nothing. :func:`snapshot` reads the books as plain JSON.
"""

from __future__ import annotations

import bisect
import threading
import time

from . import events

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "start", "stop", "reset", "enabled", "registry", "snapshot",
    "histogram_quantile",
]

# Latency-shaped default buckets (seconds), Prometheus-style with +Inf
# implicit.
_DEFAULT_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0)


class Counter:
    """Monotonic counter. float += on CPython is not atomic across
    threads, so each metric carries its own tiny lock — the plane is only
    ever armed deliberately and a lock on an opted-in path beats silently
    wrong totals."""

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
    histogram."""
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


class MetricsRegistry:
    """Name → metric, created on first touch. Snapshot-able as plain
    JSON."""

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
# The process-global plane
# ---------------------------------------------------------------------------

_REGISTRY: MetricsRegistry | None = None
_STARTED = False
_lock = threading.Lock()


def enabled() -> bool:
    """True when the plane is armed in this process — the gate every
    hot-path metric update checks (one global read when off)."""
    return _STARTED


def registry() -> MetricsRegistry:
    global _REGISTRY
    with _lock:
        if _REGISTRY is None:
            _REGISTRY = MetricsRegistry()
        return _REGISTRY


def start() -> MetricsRegistry:
    """Arm the plane: from here on the engine records its counters,
    gauges and histograms. Idempotent."""
    global _STARTED
    reg = registry()
    _STARTED = True
    return reg


def stop():
    """Disarm the plane; the books stay readable. Idempotent."""
    global _STARTED
    _STARTED = False


def reset():
    """Disarm and drop the books (tests)."""
    global _REGISTRY
    stop()
    with _lock:
        _REGISTRY = None


def snapshot() -> dict:
    """The registry's books as plain JSON, stamped with time and rank."""
    snap = {"t": round(time.time(), 6), "rank": events._rank()}
    snap.update({k: v for k, v in registry().snapshot().items() if v})
    return snap
