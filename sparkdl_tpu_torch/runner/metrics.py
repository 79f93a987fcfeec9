"""Runner metering: step-time statistics, throughput, MFU and a metrics
logger.

The counterpart of ``sparkdl_tpu/runner/metrics.py``, cut to what
``RunnerContext.fit`` reaches: :class:`StepTimeStats`,
:class:`ThroughputMeter` (in a data-parallel gang it counts the gang's
rows, and its per-chip rate divides by the gang's devices, so it reads
BASELINE's img/s/chip), :class:`MetricsLogger` (the text log; the
TensorBoard sink is not ported) and :func:`peak_flops_per_chip`, and the
process-wide failure counters :class:`RunStats` / ``run_stats`` that the
scoring runner's retries, the streaming scorer's quarantine and the
checkpoint rollbacks record into. Heartbeats come with the gang
supervisor (ROADMAP.md, Queue A 7).
"""

from __future__ import annotations

import json
import logging
import math
import os
import random
import time
from dataclasses import dataclass, field

from . import sentinel

log = logging.getLogger("sparkdl_tpu_torch.runner")

@dataclass
class RunStats:
    """Process-wide failure/recovery counters (the JAX package's
    ``RunStats``): the restart machinery, the chaos subsystem and the
    scoring runner record here so the emitted metrics carry ``restarts``,
    ``faults_injected``, quarantined rows and dispatch retries next to the
    throughput numbers. In the port the scoring runner
    (``record_retry``) and the streaming scorer (``record_quarantine``)
    record; the restart and checkpoint fields wait for the launcher.
    Cumulative per process — tests isolate with ``reset()``.
    """
    restarts: int = 0
    faults_injected: int = 0
    last_failure_kind: str | None = None
    last_failure: str | None = None
    fault_sites: list = field(default_factory=list)
    # Data-plane fault tolerance: the streaming scorer and the
    # verified-checkpoint machinery count their degradations here so
    # meter.summary() / bench records carry them next to throughput.
    rows_quarantined: int = 0
    dispatch_retries: int = 0
    dispatch_giveups: int = 0
    checkpoint_rollbacks: int = 0
    last_rollback: str | None = None
    # Training data plane: poison batches the supervisor
    # quarantined onto the dataset skip-list.
    train_batches_quarantined: int = 0
    # Elastic gang supervision: world-size changes the
    # supervisor made around permanently dead ranks.
    resizes: int = 0
    last_resize: str | None = None

    def record_restart(self):
        self.restarts += 1

    def record_resize(self, from_np: int, to_np: int,
                      rank: int | None = None):
        self.resizes += 1
        self.last_resize = (f"np {from_np} -> {to_np}"
                            + (f" (rank {rank} dead)"
                               if rank is not None else ""))[:300]

    def record_failure(self, kind: str, detail: str | None = None):
        self.last_failure_kind = kind
        self.last_failure = (detail or "")[:500] or None

    def record_fault(self, site: str, kind: str):
        self.faults_injected += 1
        self.fault_sites.append(f"{site}:{kind}")

    def record_quarantine(self, rows: int = 1):
        self.rows_quarantined += int(rows)

    def record_retry(self, giveup: bool = False):
        if giveup:
            self.dispatch_giveups += 1
        else:
            self.dispatch_retries += 1

    def record_batch_quarantine(self, n: int = 1):
        self.train_batches_quarantined += int(n)

    def record_rollback(self, from_step, to_step, reason: str | None = None):
        self.checkpoint_rollbacks += 1
        self.last_rollback = (f"step {from_step} -> {to_step}"
                              + (f" ({reason})" if reason else ""))[:300]

    def snapshot(self) -> dict:
        return {"restarts": self.restarts,
                "faults_injected": self.faults_injected,
                "last_failure_kind": self.last_failure_kind,
                "last_failure": self.last_failure,
                "fault_sites": list(self.fault_sites),
                "rows_quarantined": self.rows_quarantined,
                "dispatch_retries": self.dispatch_retries,
                "dispatch_giveups": self.dispatch_giveups,
                "checkpoint_rollbacks": self.checkpoint_rollbacks,
                "last_rollback": self.last_rollback,
                "train_batches_quarantined": self.train_batches_quarantined,
                "resizes": self.resizes,
                "last_resize": self.last_resize}

    def degraded(self) -> bool:
        """True when any fault-tolerance machinery actually engaged —
        the gate bench/summaries use to keep all-zero ledgers out of
        every record."""
        return bool(self.restarts or self.faults_injected
                    or self.rows_quarantined or self.dispatch_retries
                    or self.dispatch_giveups or self.checkpoint_rollbacks
                    or self.train_batches_quarantined or self.resizes)

    def reset(self):
        self.restarts = 0
        self.faults_injected = 0
        self.last_failure_kind = None
        self.last_failure = None
        self.fault_sites = []
        self.rows_quarantined = 0
        self.dispatch_retries = 0
        self.dispatch_giveups = 0
        self.checkpoint_rollbacks = 0
        self.last_rollback = None
        self.train_batches_quarantined = 0
        self.resizes = 0
        self.last_resize = None


run_stats = RunStats()


# Dense bf16 tensor-core peak FLOP/s per card by device-name substring:
# NVIDIA H100 SXM data sheet (989 TFLOP/s bf16 dense, at the 700 W power
# limit). SPARKDL_PEAK_FLOPS overrides (raw FLOP/s, e.g. "989e12").
_PEAK_FLOPS_BY_NAME = (("H100", 989e12),)


def peak_flops_per_chip() -> float | None:
    """Per-card peak FLOP/s for the MFU denominator: the
    ``SPARKDL_PEAK_FLOPS`` override, else the table keyed on
    ``torch.cuda.get_device_name(0)``; None (→ MFU null) when neither
    knows the hardware, as on a machine with no card."""
    env = os.environ.get("SPARKDL_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            log.warning("ignoring unparseable SPARKDL_PEAK_FLOPS=%r", env)
    import torch

    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0)
    for pat, val in _PEAK_FLOPS_BY_NAME:
        if pat in name:
            return val
    return None


class StepTimeStats:
    """Bounded reservoir of per-step wall times → p50/p95/p99/max.

    Reservoir sampling (seeded, deterministic) keeps memory O(capacity)
    over arbitrarily long runs while ``max`` and ``mean`` stay exact over
    ALL recorded steps — a straggler spike is never sampled away from the
    max, only from the quantile sample.
    """

    def __init__(self, capacity: int = 2048):
        self._cap = max(capacity, 1)
        self._sample: list[float] = []
        self._rng = random.Random(0xC0FFEE)
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0

    def record(self, dt_s: float):
        if dt_s < 0:
            return
        self.count += 1
        self.total_s += dt_s
        if dt_s > self.max_s:
            self.max_s = dt_s
        if len(self._sample) < self._cap:
            self._sample.append(dt_s)
        else:
            j = self._rng.randrange(self.count)
            if j < self._cap:
                self._sample[j] = dt_s

    @staticmethod
    def _nearest_rank(sorted_sample: list[float], q: float) -> float:
        idx = max(0, min(len(sorted_sample) - 1,
                         math.ceil(q / 100.0 * len(sorted_sample)) - 1))
        return sorted_sample[idx]

    def summary(self) -> dict:
        if not self.count:
            return {}
        s = sorted(self._sample)
        return {
            "n": self.count,
            "mean_s": round(self.total_s / self.count, 6),
            "p50_s": round(self._nearest_rank(s, 50), 6),
            "p95_s": round(self._nearest_rank(s, 95), 6),
            "p99_s": round(self._nearest_rank(s, 99), 6),
            "max_s": round(self.max_s, 6),
        }


@dataclass
class ThroughputMeter:
    """Tracks examples/s and examples/s/chip over a training run.

    ``update(n)`` once a step, ``n`` the step's rows over the whole gang
    (``fit`` passes each rank's rows times the gang's size), so
    ``examples_per_sec`` is the gang's and ``examples_per_sec_per_chip``
    divides it by ``n_chips``. The step time it records is the host wall
    time between two ``update`` calls; it is the device's step time only
    when each step ends in a wait for the device (``fit`` with
    ``log_every=1`` reads the loss every step, which waits). The first
    ``warmup_steps`` are left out (the first step allocates the
    optimizer state and the caching allocator's blocks).
    """
    n_chips: int = 1
    warmup_steps: int = 1
    flops_per_step: float | None = None  # per-step FLOPs (for MFU)
    peak_flops_per_chip: float | None = None  # default: device table / env
    step_stats: StepTimeStats = field(default_factory=StepTimeStats)
    _t0: float | None = None
    _last_t: float | None = None
    _steps: int = 0
    _examples: int = 0
    _window: list = field(default_factory=list)

    def update(self, n_examples: int):
        now = time.perf_counter()
        self._steps += 1
        if self._steps <= self.warmup_steps:
            self._t0 = now
            self._last_t = now
            return
        self._examples += n_examples
        if self._last_t is not None:
            dt = now - self._last_t
            self.step_stats.record(dt)
            sentinel.observe("step_time", dt)
        self._last_t = now
        self._window.append((now, n_examples))
        if len(self._window) > 50:
            self._window.pop(0)

    @property
    def steps(self) -> int:
        return self._steps

    def examples_per_sec(self) -> float:
        if self._t0 is None or self._steps <= self.warmup_steps:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._examples / dt if dt > 0 else 0.0

    def examples_per_sec_per_chip(self) -> float:
        return self.examples_per_sec() / max(self.n_chips, 1)

    def recent_examples_per_sec(self) -> float:
        if len(self._window) < 2:
            return self.examples_per_sec()
        dt = self._window[-1][0] - self._window[0][0]
        n = sum(n for _, n in self._window[1:])
        return n / dt if dt > 0 else 0.0

    def _mfu_from(self, step_summary: dict) -> float | None:
        if not self.flops_per_step:
            return None
        peak = self.peak_flops_per_chip or peak_flops_per_chip()
        if not peak or not step_summary or step_summary["mean_s"] <= 0:
            return None
        return self.flops_per_step / step_summary["mean_s"] / (
            peak * max(self.n_chips, 1))

    def mfu(self) -> float | None:
        """Model FLOPs utilization: achieved FLOP/s over the card's peak.
        Needs ``flops_per_step`` and a known peak; None otherwise, so
        consumers can tell "unknown" from "terrible"."""
        return self._mfu_from(self.step_stats.summary())

    def summary(self) -> dict:
        st = self.step_stats.summary()
        mfu = self._mfu_from(st)
        return {
            "steps": self._steps,
            "examples": self._examples,
            "examples_per_sec": round(self.examples_per_sec(), 2),
            "examples_per_sec_per_chip":
                round(self.examples_per_sec_per_chip(), 2),
            "n_chips": self.n_chips,
            "step_time": st or None,
            "mfu": round(mfu, 4) if mfu is not None else None,
        }


class MetricsLogger:
    """Scalar metrics sink: the ``sparkdl_tpu_torch.runner`` logger, one
    JSON line a call."""

    def log(self, step: int, metrics: dict):
        """Emit one line. Cadence is the caller's job (fit() gates on
        log_every). Non-numeric values pass through as text."""
        def _fmt(v):
            if isinstance(v, (int, float)) or hasattr(v, "item"):
                try:
                    return round(float(v), 5)
                except (TypeError, ValueError):
                    return str(v)
            return v

        flat = {k: _fmt(v) for k, v in metrics.items()}
        log.info("step %d %s", step, json.dumps(flat, default=str))

    def log_summary(self, step: int, summary: dict):
        """Flatten a ``meter.summary()`` into scalars (nested keys joined
        by ``_``) and emit once."""
        flat: dict = {}

        def _flatten(prefix: str, v):
            if isinstance(v, dict):
                for k2, v2 in v.items():
                    _flatten(f"{prefix}_{k2}" if prefix else str(k2), v2)
            elif v is not None:
                flat[prefix] = v

        _flatten("", summary)
        self.log(step, flat)
