"""Failure detection & classification.

The port's copy of ``sparkdl_tpu/runner/failures.py``. It distinguishes
*infrastructure* failures (backend unavailable, preempted device,
interconnect flake — worth a retry or a restart) from *program* failures
(user code bugs, shape errors, NaNs — retrying burns the budget and
re-raises anyway).

``classify_exception`` is the policy point; the scoring runner's retry
path (``core.runtime.BatchRunner.run_stream``) routes through it. On the
card, a CUDA out-of-memory error and an illegal memory access are fatal:
the first reproduces on retry with the same batch, and the second leaves
the CUDA context unusable, so nothing in the process can retry.
:func:`diagnose_context` collects thread stack traces around a run with
the standard library's ``faulthandler`` (the JAX package's uses the TPU
diagnostics package).
"""

from __future__ import annotations

import contextlib
import logging
import os
import re

log = logging.getLogger("sparkdl_tpu_torch.runner")

# Elastic gang supervision. Defined HERE (the framework-free policy
# module) because both sides of the contract read it: the supervisor
# (``launcher.supervise`` decides whether a permanently dead rank shrinks
# the gang) and the workers (``CheckpointManager.restore`` decides
# whether a topology-mismatched checkpoint reshards or refuses).
ELASTIC_ENV = "SPARKDL_ELASTIC"
ELASTIC_MIN_ENV = "SPARKDL_ELASTIC_MIN_NP"

_TRUTHY = ("1", "true", "yes", "on")


def elastic_enabled(env: dict | None = None) -> bool:
    """True when elastic resize is armed — the caller's env dict wins
    over the process environment (the launcher's merge order)."""
    raw = (env or {}).get(ELASTIC_ENV) or os.environ.get(ELASTIC_ENV, "")
    return raw.strip().lower() in _TRUTHY


def elastic_min_np(env: dict | None = None) -> int:
    """The world-size floor a shrinking gang must not pass (default 1 —
    a single survivor still finishes the job). Malformed values degrade
    to the default: a bad knob must not kill the supervisor."""
    raw = (env or {}).get(ELASTIC_MIN_ENV) \
        or os.environ.get(ELASTIC_MIN_ENV, "")
    try:
        return max(1, int(raw))
    except (TypeError, ValueError):
        return 1

# The torch.distributed texts a dead peer leaves in a survivor: NCCL's
# watchdog timeout and aborted communicator, the TCPStore's
# ``DistNetworkError`` / ``DistStoreError``, gloo's closed or reset pair.
_PEER_LOST = (r"Watchdog caught collective operation timeout"
              r"|NCCL communicator was aborted|DistNetworkError"
              r"|DistStoreError|Connection (closed|reset) by peer")

# Status words that indicate the *platform* (not the program) broke.
# UNAVAILABLE/ABORTED/CANCELLED: backend or coordination flake.
# DEADLINE_EXCEEDED: rendezvous/collective timeout (peer died).
_RETRYABLE_PATTERNS = re.compile(
    r"(UNAVAILABLE|ABORTED|CANCELLED|DEADLINE_EXCEEDED"
    r"|backend setup|failed to connect|connection (reset|refused)"
    r"|socket closed|preempt|slice .* unhealthy|device or resource busy"
    r"|coordination service|heartbeat|" + _PEER_LOST + ")", re.IGNORECASE)

# A collective that failed because a peer of the gang is gone (the texts
# above and NCCL's backend error): a request did not cause it, so no
# per-request isolation may absorb it.
_PEER_LOSS_PATTERNS = re.compile(
    "(DistBackendError|" + _PEER_LOST + ")", re.IGNORECASE)


def is_peer_loss(exc: BaseException) -> bool:
    """Whether ``exc`` is a collective's failure on a gang whose peer is
    gone (gloo raises on the dead pair; NCCL's watchdog or an aborted
    communicator raises where it does not hang)."""
    return _PEER_LOSS_PATTERNS.search(
        f"{type(exc).__name__}: {exc}") is not None


# Definitely-program failures even if they arrive wrapped in a runtime error.
# The CUDA texts: ``torch.cuda.OutOfMemoryError`` ("CUDA out of memory")
# reproduces with the same batch, and an illegal memory access poisons the
# CUDA context for the rest of the process — neither is worth a retry.
_FATAL_PATTERNS = re.compile(
    r"(INVALID_ARGUMENT|UNIMPLEMENTED|FAILED_PRECONDITION"
    r"|NaN encountered|RESOURCE_EXHAUSTED"
    r"|CUDA out of memory|OutOfMemoryError|illegal memory access)",
    re.IGNORECASE)

_FATAL_TYPES = (TypeError, ValueError, KeyError, IndexError, AttributeError,
                AssertionError, ZeroDivisionError, NotImplementedError)


class TrainingDivergedError(RuntimeError):
    """Fatal: the train loop produced a non-finite loss.

    Raised by ``RunnerContext.fit``'s divergence guard instead of silently
    checkpointing garbage — restarting from the same data/params would
    diverge again, so retrying burns the restart budget for nothing.
    """

    def __init__(self, step: int, value: float | None = None):
        super().__init__(
            f"training diverged: non-finite loss ({value}) at step {step}")
        self.step = step
        self.value = value


class QuarantineOverflowError(RuntimeError):
    """Fatal: the scorer's dead-letter circuit breaker tripped.

    Too large a fraction of rows quarantined — past
    ``SPARKDL_MAX_QUARANTINE_FRAC`` the input is systematically bad
    (wrong schema, wrong decoder), not occasionally corrupt, and silently
    scoring the survivors would hide a data-plane bug. Restarting would
    re-quarantine the same rows, so retrying burns the budget for nothing.
    """

    def __init__(self, quarantined: int, seen: int, max_frac: float):
        super().__init__(
            f"quarantine circuit breaker: {quarantined}/{seen} rows "
            f"dead-lettered (> max fraction {max_frac}); the input is "
            "systematically bad, not occasionally corrupt "
            "(SPARKDL_MAX_QUARANTINE_FRAC raises the threshold)")
        self.quarantined = quarantined
        self.seen = seen
        self.max_frac = max_frac


class PoisonDataError(RuntimeError):
    """Fatal: the supervisor's poison-batch circuit breaker tripped.
    More than ``SPARKDL_MAX_SKIPPED_BATCHES`` training batches
    were quarantined as deterministic gang-killers — past that the
    *dataset* is systematically bad (wrong schema, corrupt shard), not
    occasionally poisoned, and skipping ever more of it would silently
    train on a different distribution. Restarting re-quarantines, so
    retrying burns the budget for nothing.
    """

    def __init__(self, quarantined: list, max_skipped: int,
                 last_failure: str | None = None):
        super().__init__(
            f"poison-batch circuit breaker: {len(quarantined)} training "
            f"batch(es) already quarantined ({sorted(quarantined)}), "
            f"refusing to skip another (max {max_skipped}); the dataset "
            "is systematically bad, not occasionally poisoned "
            "(SPARKDL_MAX_SKIPPED_BATCHES raises the threshold)"
            + (f"; last failure: {last_failure}" if last_failure else ""))
        self.quarantined = list(quarantined)
        self.max_skipped = max_skipped


class ScoringStallError(RuntimeError):
    """The scoring pipeline's in-flight window made no fetch progress for
    ``SPARKDL_DISPATCH_TIMEOUT_S`` — a wedged device/interconnect surfaces
    as a *named, classified* failure (GangFailure-style: which stage, how
    long) instead of a silent hang only a process-level watchdog could
    see. DEADLINE_EXCEEDED-shaped, so the retryable/fatal taxonomy routes
    it to checkpoint-and-restart."""

    def __init__(self, stage: str, timeout_s: float):
        super().__init__(
            f"DEADLINE_EXCEEDED: scoring stage '{stage}' made no progress "
            f"for {timeout_s}s (in-flight window stalled; device or "
            "interconnect wedged)")
        self.stage = stage
        self.timeout_s = timeout_s


class ScoringStageError(RuntimeError):
    """A scoring pipeline stage failed after exhausting its retry budget
    (or immediately, for fatal errors). Names the stage and attempt count;
    classification follows the underlying cause, carried as
    ``__cause__``."""

    def __init__(self, stage: str, attempts: int, cause: BaseException):
        super().__init__(
            f"scoring stage '{stage}' failed after {attempts} attempt(s): "
            f"{type(cause).__name__}: {cause}")
        self.stage = stage
        self.attempts = attempts


# Serving-tier taxonomy: every exception class the serving package can
# surface, by NAME (matched walking ``type(exc).__mro__`` so subclasses
# inherit their base's verdict) — name-keyed because the framework-free
# policy module must not import ``serving.backend``. "retryable" = worth a restart/failover of the *caller*
# (engine died, backend state lost, capacity); "fatal" = the request or
# program is the problem (rejected, quarantined, cancelled, past its
# deadline) and retrying re-fails. The drift-guard test greps
# ``serving/`` for exception classes and asserts each lands a verdict
# here, so routing can never silently default.
SERVING_CLASS_VERDICTS = {
    "ServingError": "fatal",
    "RequestRejected": "fatal",
    "QueueFullError": "retryable",
    "RequestQuarantined": "fatal",
    "ServingStallError": "retryable",
    "EngineStopped": "retryable",
    "RequestCancelled": "fatal",
    "DeadlineExceeded": "fatal",
    "SlotCacheLost": "retryable",
    "BlockError": "fatal",
    "BlockExhausted": "retryable",
    # chaos's serving-fatal stand-in (runner/chaos.py) rides the same
    # lost-backend-state verdict as the organic SlotCacheLost
    "InjectedCacheLost": "retryable",
    # Fleet tier. A stale/foreign resume snapshot is the
    # caller's bug (re-sending it re-fails); a sub-floor fleet or a shed
    # is capacity that can come back; a universal-rejection routing
    # error reproduces on retry by construction. An injected unclean
    # replica death is retryable AT THE FLEET TIER — the router
    # re-admits from shadow state.
    "SnapshotIncompatibleError": "fatal",
    "FleetDegradedError": "retryable",
    "RequestShedError": "retryable",
    "FleetRoutingError": "fatal",
    "InjectedReplicaDead": "retryable",
}


def classify_exception(exc: BaseException) -> str:
    """Return ``"retryable"`` or ``"fatal"`` for a training-run exception.

    Python-level errors (ValueError & co) are always fatal — they are the
    user's bug, and HorovodRunner-era whole-job retries on those were pure
    waste. Runtime errors are classified by status-code text: transport
    and availability codes retry; argument/precondition codes do not.
    Unknown runtime errors default to retryable — the checkpoint-resume path
    makes a wasted restart cheap, while a missed restart loses the job.
    """
    if isinstance(exc, KeyboardInterrupt):
        return "fatal"
    if isinstance(exc, (TrainingDivergedError, QuarantineOverflowError,
                        PoisonDataError)):
        return "fatal"
    if isinstance(exc, ScoringStallError):
        return "retryable"
    if isinstance(exc, ScoringStageError) and exc.__cause__ is not None:
        # The stage wrapper is packaging, not policy: the verdict belongs
        # to the underlying dispatch/fetch error it carries.
        return classify_exception(exc.__cause__)
    for klass in type(exc).__mro__:
        verdict = SERVING_CLASS_VERDICTS.get(klass.__name__)
        if verdict is not None:
            return verdict
    if isinstance(exc, _FATAL_TYPES):
        return "fatal"
    msg = f"{type(exc).__name__}: {exc}"
    if _FATAL_PATTERNS.search(msg):
        return "fatal"
    if _RETRYABLE_PATTERNS.search(msg):
        return "retryable"
    # RuntimeError with no recognized status: assume infra.
    if type(exc).__name__ in ("XlaRuntimeError", "RuntimeError", "OSError",
                              "ConnectionError", "TimeoutError"):
        return "retryable"
    return "fatal"


def is_retryable(exc: BaseException) -> bool:
    return classify_exception(exc) == "retryable"


def exception_summary(exc: BaseException) -> dict:
    """Compact ``{type, kind, message}`` record for postmortems/telemetry —
    the flight recorder (``events.postmortem``) and gang timelines embed
    this so a merged trace carries the retryable/fatal verdict, not just
    the text."""
    return {"type": type(exc).__name__,
            "kind": classify_exception(exc),
            "message": str(exc)[:2000]}


# Traceback tails ending in these are the user's bug even when the captured
# text carries no gRPC status word. The serving names ride the one
# verdict table above, so text and exception classification can't drift.
_FATAL_TRACEBACK_NAMES = ("ValueError", "TypeError", "KeyError",
                          "AssertionError", "AttributeError", "IndexError",
                          "ModuleNotFoundError", "ImportError",
                          "NotImplementedError", "TrainingDivergedError",
                          "QuarantineOverflowError", "PoisonDataError") + \
    tuple(name for name, verdict in SERVING_CLASS_VERDICTS.items()
          if verdict == "fatal")


def classify_text(text: str) -> str:
    """``classify_exception`` for captured *text* (a dead worker's stderr):
    the gang supervisor and bench driver classify children they cannot
    unpickle an exception object from.

    Fatal evidence first (status patterns, then Python traceback names) —
    stderr spew often carries incidental CANCELLED/coordination lines from
    the teardown of a run that actually died on a program error, so the
    retryable patterns must not get first look: a CUDA out-of-memory or a
    ``ValueError`` beside an NCCL abort or watchdog line stays fatal. What
    a dead peer leaves in a survivor (``_RETRYABLE_PATTERNS``) restarts,
    and so does unknown text, same reasoning as ``classify_exception``.
    """
    if _FATAL_PATTERNS.search(text):
        return "fatal"
    for name in _FATAL_TRACEBACK_NAMES:
        if f"{name}:" in text:
            return "fatal"
    # Everything else — recognized retryable patterns and unknown text
    # alike — restarts; a wasted restart is cheap next to a lost job.
    return "retryable"


@contextlib.contextmanager
def diagnose_context(interval_s: int = 10):
    """Collect every thread's stack trace inside the block, for a
    postmortem of what a classified exception cannot show (hangs,
    signals): on a fatal signal (SIGSEGV, SIGFPE, SIGABRT, SIGBUS,
    SIGILL), on SIGTERM (a preemption's or the supervisor's stop; the
    signal's previous handling follows) and every ``interval_s`` seconds,
    appended by ``faulthandler`` to ``stack_traces_rank{i}.txt`` in
    ``SPARKDL_EVENT_DIR`` or, without one, in ``sparkdl_debugging`` under
    the temporary directory. Emits a ``diagnose`` event (``interval_s``,
    ``stack_trace_dir``, ``path``) once armed and yields the file's
    path. On exit the timer is cancelled, SIGTERM's handler restored, and
    the fatal-signal dump disabled or, when it was on before, re-armed on
    stderr."""
    import faulthandler
    import signal
    import sys
    import tempfile

    from . import events
    out_dir = os.environ.get(events.RECORDER_DIR_ENV) or os.path.join(
        tempfile.gettempdir(), "sparkdl_debugging")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"stack_traces_rank{events._rank()}.txt")
    was_enabled = faulthandler.is_enabled()
    with open(path, "a") as f:
        faulthandler.enable(file=f, all_threads=True)
        faulthandler.register(signal.SIGTERM, file=f, all_threads=True,
                              chain=True)
        if interval_s > 0:
            faulthandler.dump_traceback_later(interval_s, repeat=True,
                                              file=f)
        events.event("diagnose", interval_s=interval_s,
                     stack_trace_dir=out_dir, path=path)
        try:
            yield path
        finally:
            faulthandler.cancel_dump_traceback_later()
            faulthandler.unregister(signal.SIGTERM)
            faulthandler.disable()
            if was_enabled and sys.__stderr__ is not None:
                try:
                    faulthandler.enable(file=sys.__stderr__,
                                        all_threads=True)
                except (ValueError, OSError):
                    log.debug("faulthandler not re-armed on stderr",
                              exc_info=True)
