"""Online anomaly sentinel — rolling-baseline drift detection.

The port's copy of ``sparkdl_tpu/runner/sentinel.py``: the same code
under its own logger name (``sparkdl_tpu_torch.runner``).

The flight recorder and the metrics registry record what happened; this
module is the *online* layer: it keeps a long-run baseline of each
watched signal (TTFT, decode-step latency, queue depth) and fires an
``anomaly`` flight-recorder event + a counter the moment the signal's
rolling p95 drifts past a configurable multiple of that baseline.

The baseline is a seeded reservoir sample (deterministic, O(capacity)
memory over arbitrarily long runs) and percentiles are nearest-rank over
the sample. The short window is a plain deque — recent behaviour should
NOT be sampled away, it is the thing being judged.

Armed explicitly (``arm()``) or from the environment
(``SPARKDL_SENTINEL=1`` → :func:`maybe_arm_from_env`, called from the
serving-engine loop). Off by default: :func:`observe` is one
module-global read and an immediate return.

Stdlib-only at import time.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import random
import threading

from . import events
from . import telemetry

__all__ = ["Sentinel", "RollingBaseline", "observe", "arm", "disarm",
           "armed", "maybe_arm_from_env", "anomaly_counts", "stats",
           "SENTINEL_ENV", "RATIO_ENV", "WINDOW_ENV", "MIN_N_ENV"]

log = logging.getLogger("sparkdl_tpu_torch.runner")

SENTINEL_ENV = "SPARKDL_SENTINEL"
RATIO_ENV = "SPARKDL_SENTINEL_RATIO"
WINDOW_ENV = "SPARKDL_SENTINEL_WINDOW"
MIN_N_ENV = "SPARKDL_SENTINEL_MIN_N"

_TRUTHY = ("1", "true", "yes", "on")
_DEFAULT_RATIO = 2.0   # window p95 > ratio x baseline p95 => anomaly
_DEFAULT_WINDOW = 32   # rolling-window length (samples)
_DEFAULT_MIN_N = 16    # baseline samples required before judging
_BASELINE_CAP = 512    # reservoir capacity per watched metric
_MIN_WINDOW_FILL = 4   # window samples required before judging


def _env_float(name: str, default: float, env: dict | None = None) -> float:
    raw = (env or {}).get(name) or os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default  # a bad knob must not kill the run


def _env_int(name: str, default: int, env: dict | None = None) -> int:
    return int(_env_float(name, default, env))


class RollingBaseline:
    """One watched signal: seeded-reservoir baseline + rolling window.

    ``observe(value)`` returns an anomaly dict on the healthy→anomalous
    transition (edge-triggered — a sustained slowdown fires ONCE, then
    re-arms when the window recovers below the threshold), else ``None``.
    While anomalous the baseline absorbs nothing: a slowdown must not
    normalise itself into the reference it is being judged against.
    """

    def __init__(self, metric: str, ratio: float, window: int, min_n: int):
        self.metric = metric
        self.ratio = max(1.0, ratio)
        self.min_n = max(1, min_n)
        self._window: collections.deque = collections.deque(
            maxlen=max(window, _MIN_WINDOW_FILL))
        self._baseline: list[float] = []
        self._rng = random.Random(0xC0FFEE)
        self._n = 0                 # values ever offered to the baseline
        self._base_sorted = None    # cache; invalidated on insert
        self.anomalous = False
        self.anomalies = 0

    @staticmethod
    def _nearest_rank(sorted_sample: list[float], q: float) -> float:
        idx = max(0, min(len(sorted_sample) - 1,
                         math.ceil(q / 100.0 * len(sorted_sample)) - 1))
        return sorted_sample[idx]

    def baseline_p95(self) -> float:
        if not self._baseline:
            return 0.0
        if self._base_sorted is None:
            self._base_sorted = sorted(self._baseline)
        return self._nearest_rank(self._base_sorted, 95)

    def window_p95(self) -> float:
        if not self._window:
            return 0.0
        return self._nearest_rank(sorted(self._window), 95)

    def _absorb(self, value: float):
        self._n += 1
        if len(self._baseline) < _BASELINE_CAP:
            self._baseline.append(value)
            self._base_sorted = None
        else:
            j = self._rng.randrange(self._n)
            if j < _BASELINE_CAP:
                self._baseline[j] = value
                self._base_sorted = None

    def observe(self, value: float):
        if value < 0:
            return None
        self._window.append(value)
        base = self.baseline_p95()
        verdict = False
        if (len(self._baseline) >= self.min_n
                and len(self._window) >= _MIN_WINDOW_FILL
                and base > 0):
            # base > 0 guard: an all-zero baseline (an idle queue-depth
            # gauge) makes any activity an infinite ratio — not drift.
            verdict = self.window_p95() > self.ratio * base
        fired = None
        if verdict and not self.anomalous:
            self.anomalies += 1
            fired = {"metric": self.metric, "value": round(value, 6),
                     "window_p95": round(self.window_p95(), 6),
                     "baseline_p95": round(base, 6),
                     "ratio": round(self.ratio, 3),
                     "baseline_n": len(self._baseline)}
        self.anomalous = verdict
        if not verdict:
            self._absorb(value)
        return fired

    def summary(self) -> dict:
        return {"anomalies": self.anomalies,
                "anomalous": self.anomalous,
                "baseline_n": len(self._baseline),
                "baseline_p95": round(self.baseline_p95(), 6),
                "window_p95": round(self.window_p95(), 6)}


class Sentinel:
    """Per-process set of :class:`RollingBaseline`, keyed by metric name.

    Thread-safe: the engine loop and delivery callbacks observe
    concurrently. On an anomaly transition it emits an ``anomaly``
    flight-recorder point event and bumps the
    ``sentinel_anomalies_total`` counter — `registry()` works whether or
    not the telemetry plane is armed.
    """

    def __init__(self, ratio: float | None = None,
                 window: int | None = None, min_n: int | None = None,
                 env: dict | None = None):
        self.ratio = _env_float(RATIO_ENV, _DEFAULT_RATIO, env) \
            if ratio is None else float(ratio)
        self.window = _env_int(WINDOW_ENV, _DEFAULT_WINDOW, env) \
            if window is None else int(window)
        self.min_n = _env_int(MIN_N_ENV, _DEFAULT_MIN_N, env) \
            if min_n is None else int(min_n)
        self._lock = threading.Lock()
        self._baselines: dict[str, RollingBaseline] = {}

    def observe(self, metric: str, value: float):
        with self._lock:
            rb = self._baselines.get(metric)
            if rb is None:
                rb = self._baselines[metric] = RollingBaseline(
                    metric, self.ratio, self.window, self.min_n)
            fired = rb.observe(value)
        if fired is None:
            return
        # Emission OUTSIDE the lock: a tee (the telemetry accountant) may
        # itself take locks, and the hot path must never wait on it.
        events.event("anomaly", **fired)
        telemetry.registry().counter("sentinel_anomalies_total").inc()
        log.warning("sentinel: %s drifted — window p95 %.6f > %.1fx "
                    "baseline p95 %.6f", fired["metric"],
                    fired["window_p95"], fired["ratio"],
                    fired["baseline_p95"])

    def anomaly_counts(self) -> dict[str, int]:
        with self._lock:
            return {m: rb.anomalies
                    for m, rb in sorted(self._baselines.items())
                    if rb.anomalies}

    def stats(self) -> dict:
        with self._lock:
            return {m: rb.summary()
                    for m, rb in sorted(self._baselines.items())}


# -- process-global sentinel --------------------------------------------------
# None == off. observe() below is the ONE hot-path entry point: one module
# global read + return when disarmed (the plane-off pin).

_SENTINEL: Sentinel | None = None
_ARM_LOCK = threading.Lock()


def observe(metric: str, value: float) -> None:
    s = _SENTINEL
    if s is None:
        return
    s.observe(metric, value)


def armed() -> bool:
    return _SENTINEL is not None


def arm(ratio: float | None = None, window: int | None = None,
        min_n: int | None = None, env: dict | None = None) -> Sentinel:
    """Arm the process sentinel (idempotent — an armed sentinel keeps its
    baselines; re-arming must not forget what normal looks like)."""
    global _SENTINEL
    with _ARM_LOCK:
        if _SENTINEL is None:
            _SENTINEL = Sentinel(ratio=ratio, window=window, min_n=min_n,
                                 env=env)
        return _SENTINEL


def disarm() -> None:
    """Back to off (tests; paired with the arming entry points)."""
    global _SENTINEL
    with _ARM_LOCK:
        _SENTINEL = None


def maybe_arm_from_env(env: dict | None = None) -> Sentinel | None:
    """Arm iff ``SPARKDL_SENTINEL`` is truthy — called from the
    serving-engine loop. ≈ free when unset (one dict lookup), and never
    *disarms* an explicitly armed sentinel."""
    if _SENTINEL is not None:
        return _SENTINEL
    raw = (env or {}).get(SENTINEL_ENV) or os.environ.get(SENTINEL_ENV, "")
    if raw.strip().lower() not in _TRUTHY:
        return None
    return arm(env=env)


def anomaly_counts() -> dict[str, int]:
    """metric -> anomaly transitions so far; {} when off or quiet. The
    bench harness folds this into ``failure_stats`` so a drifting run is
    visible in the record even when it completes."""
    s = _SENTINEL
    return s.anomaly_counts() if s is not None else {}


def stats() -> dict:
    s = _SENTINEL
    return s.stats() if s is not None else {}
