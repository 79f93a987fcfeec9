"""Runner observability: step-time statistics, throughput, MFU, a
metrics logger, heartbeats, profiler traces and a debug mode.

The counterpart of ``sparkdl_tpu/runner/metrics.py``:
:class:`StepTimeStats` (and the process-wide ``global_step_stats``),
:class:`ThroughputMeter` (in a data-parallel gang it counts the gang's
rows, and its per-chip rate divides by the gang's devices, so it reads
BASELINE's img/s/chip; its summary carries the ``compile_cache``,
``fault_tolerance`` and ``stage_utilization`` blocks),
:class:`MetricsLogger` (the text log; the TensorBoard sink is not
ported), :func:`peak_flops_per_chip`, the process-wide failure counters
:class:`RunStats` / ``run_stats``, the liveness beacon
:func:`touch_heartbeat`, ``torch.profiler`` traces
(:func:`start_profiler_trace` / :func:`stop_profiler_trace` /
:func:`trace`, one :func:`step_annotation` range a train step) and
:func:`debug_mode`.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import random
import time
from dataclasses import dataclass, field

from . import events, sentinel, telemetry

log = logging.getLogger("sparkdl_tpu_torch.runner")

@dataclass
class RunStats:
    """Process-wide failure/recovery counters (the JAX package's
    ``RunStats``): the restart machinery, the chaos subsystem and the
    scoring runner record here so the emitted metrics carry ``restarts``,
    ``faults_injected``, quarantined rows and dispatch retries next to the
    throughput numbers: ``run_with_restarts`` records restarts and
    failures, ``chaos.fire`` injections, the checkpoint manager
    rollbacks, the scoring runner retries and the streaming scorer
    quarantined rows. Cumulative per process — tests isolate with
    ``reset()``.
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


def touch_heartbeat(step: int | None = None):
    """Per-rank liveness beacon for a hang watchdog.

    ``fit()`` calls this every step; with ``SPARKDL_HEARTBEAT_DIR`` unset
    it is a no-op. The body is JSON ``{"step": N, "time": <unix>}`` in
    ``rank{i}.hb`` — the step shows where each rank stopped making
    progress, the wall clock lines beats up against the event timeline.
    Written to a tmp file + ``os.replace`` so a reader never sees a torn
    or empty body.
    """
    hb_dir = os.environ.get("SPARKDL_HEARTBEAT_DIR")
    if not hb_dir:
        return
    rank = os.environ.get("SPARKDL_PROCESS_ID", "0")
    try:
        os.makedirs(hb_dir, exist_ok=True)
        events.atomic_write_json(
            os.path.join(hb_dir, f"rank{rank}.hb"),
            {"step": step, "time": round(time.time(), 3)})
    except OSError:  # a torn-down tmpdir must not kill the train loop
        pass


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

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the sample (exact when the run is
        shorter than the reservoir)."""
        if not self._sample:
            return 0.0
        return self._nearest_rank(sorted(self._sample), q)

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

    def reset(self):
        self._sample = []
        self._rng = random.Random(0xC0FFEE)
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0


# Process-wide accumulator (the run_stats pattern): every meter also
# records here, so a caller can read step-time percentiles of whatever
# trained in the process without holding the meter.
global_step_stats = StepTimeStats()


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
            global_step_stats.record(dt)
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
            "compile_cache": compile_cache_summary(),
            "fault_tolerance": fault_tolerance_summary(),
            # The live telemetry plane's per-stage busy fractions and
            # dominant stage; None when the plane is off.
            "stage_utilization": telemetry.stage_utilization_summary(),
        }


def fault_tolerance_summary() -> dict | None:
    """Restart / quarantine / dispatch-retry / checkpoint-rollback
    counters for ``meter.summary()`` — the degradations a job survived,
    next to its throughput. None when nothing engaged, so clean runs stay
    clean."""
    if not run_stats.degraded():
        return None
    snap = run_stats.snapshot()
    return {k: v for k, v in snap.items()
            if k in ("restarts", "faults_injected", "rows_quarantined",
                     "dispatch_retries", "dispatch_giveups",
                     "checkpoint_rollbacks", "last_rollback",
                     "train_batches_quarantined", "resizes", "last_resize")
            and v}


def compile_cache_summary() -> dict | None:
    """Process-wide step-graph visibility for ``meter.summary()``: the
    signature hits and misses, graph captures and replays of
    ``core.runtime.GLOBAL_COMPILE_CACHE`` (every miss is a new capture).
    None when nothing has been recorded, so quiet runs stay quiet. The
    reference's persistent on-disk compile cache has no counterpart in
    the port."""
    from ..core.runtime import GLOBAL_COMPILE_CACHE

    snap = GLOBAL_COMPILE_CACHE.snapshot()
    return snap if snap["hits"] or snap["misses"] else None


_TB_WARNED = []  # one warning a process when no TensorBoard writer imports


def _summary_writer(log_dir: str):
    """A TensorBoard ``SummaryWriter`` over ``log_dir``: tensorboardX's,
    else ``torch.utils.tensorboard``'s (the same event files); None, with
    one warning a process, when neither imports."""
    import importlib

    for name in ("tensorboardX", "torch.utils.tensorboard"):
        try:
            return importlib.import_module(name).SummaryWriter(log_dir)
        except Exception:  # noqa: BLE001 — an optional writer
            continue
    if not _TB_WARNED:
        _TB_WARNED.append(True)
        log.warning("neither tensorboardX nor torch.utils.tensorboard "
                    "imports; metrics to the log only")
    return None


class MetricsLogger:
    """Scalar metrics sink: the ``sparkdl_tpu_torch.runner`` logger, one
    JSON line a call, and TensorBoard event files when a ``log_dir`` is
    given (:func:`_summary_writer`), as the reference's."""

    def __init__(self, log_dir: str | None = None):
        self._tb = _summary_writer(log_dir) if log_dir else None

    def log(self, step: int, metrics: dict):
        """Emit to TensorBoard and the text log. Cadence is the caller's
        job (fit() gates on log_every). Non-numeric values pass through
        to the text line; TensorBoard takes the scalars."""
        if self._tb is not None:
            for k, v in metrics.items():
                try:
                    self._tb.add_scalar(k, float(v), step)
                except (TypeError, ValueError, RuntimeError):
                    pass

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

    def close(self):
        """Idempotent: ``fit()`` closes on the success path and callers
        close again in their own cleanup."""
        tb, self._tb = self._tb, None
        if tb is not None:
            tb.close()


# -- profiler traces ------------------------------------------------------

_PROFILERS: list = []  # the running (profile, log_dir) pair, at most one


def start_profiler_trace(log_dir: str, cuda: bool | None = None):
    """Start a ``torch.profiler`` trace over the CPU and, when ``cuda``
    (default: a card is present), CUDA, plus the flight-recorder event
    linking postmortems to the trace on disk. Pair with
    :func:`stop_profiler_trace` (or use the :func:`trace` context
    manager), which writes ``trace_rank{i}.json`` (Chrome format) into
    ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _PROFILERS:
        raise RuntimeError("a profiler trace is already running")
    if cuda is None:
        cuda = torch.cuda.is_available()
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    events.event("profile_trace", trace_dir=log_dir)
    prof.__enter__()
    _PROFILERS.append((prof, log_dir))


def stop_profiler_trace(failed: bool = False):
    """The one implementation of the guarded profiler stop: stop the
    running trace and write it. If the traced region already ``failed``,
    a stop or export error is logged, not raised — a profiling hiccup
    must never mask the real failure. On a clean region it propagates."""
    try:
        if not _PROFILERS:
            raise RuntimeError("no profiler trace is running")
        prof, log_dir = _PROFILERS.pop()
        prof.__exit__(None, None, None)
        rank = os.environ.get("SPARKDL_PROCESS_ID", "0")
        prof.export_chrome_trace(os.path.join(log_dir,
                                              f"trace_rank{rank}.json"))
    except Exception:
        if not failed:
            raise
        log.warning("profiler stop failed during exception unwind",
                    exc_info=True)


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool | None = None):
    """Profile a region to a Chrome trace:
    ``with metrics.trace("prof"): run_steps()``.

    The profiler is closed even when the region raises, without the stop
    masking the region's own exception (see :func:`stop_profiler_trace`).
    """
    start_profiler_trace(log_dir, cuda=cuda)
    failed = False
    try:
        yield
    except BaseException:
        failed = True
        raise
    finally:
        stop_profiler_trace(failed)


def step_annotation(step: int):
    """One named range a train step (``train_step#<step>``) so a profiler
    trace groups the step's operators and kernels by step. Outside a
    trace the range costs one small host call and records nothing."""
    import torch

    return torch.profiler.record_function(f"train_step#{step}")


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Numeric sanitizer mode: with ``nans``, autograd's anomaly mode
    checks every backward function's output for NaN and raises naming
    the forward operation that made it
    (``torch.autograd.set_detect_anomaly(True, check_nan=True)``). The
    reference's ``jax_debug_nans`` traps every operation, forward ones
    included; this traps the backward's (ROADMAP.md, Queue C 2). The
    previous mode is restored on exit."""
    import torch

    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(nans, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(*prev)
