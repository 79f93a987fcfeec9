"""Process launcher and gang supervisor: the ``mpirun`` role of
HorovodRunner for the port, with the failure story the original never had.

The port's copy of ``sparkdl_tpu/runner/launcher.py``. One process drives
one device, and ``torch.distributed`` is the rendezvous MPI was. This
module starts those N processes on one host and supervises them:

- :func:`launch` spawns the gang and waits in a **concurrent poll loop**:
  the first nonzero exit is detected within ``poll_s`` (not after the
  whole ``timeout_s`` a sequential wait would burn while the survivors
  hang on a collective), the rest of the gang is killed, and the captured
  stderr rides in the raised :class:`GangFailure`.
- A **heartbeat watchdog**: ranks touch ``$SPARKDL_HEARTBEAT_DIR/rank{i}.hb``
  from inside ``fit()``'s step loop (``metrics.touch_heartbeat``); a rank
  whose beat goes stale for ``watchdog_s`` marks the gang hung — the
  failure exit codes can never see.
- :func:`supervise` wraps launch in **budgeted checkpoint-restart**: gang
  failures are classified (``failures.classify_text`` on the captured
  stderr); retryable ones relaunch the whole gang with exponential backoff
  under ``max_restarts``, and workers resume from their checkpoint dir via
  ``fit(resume=True)`` — at most ``checkpoint_every`` steps lost per
  failure. A :class:`~sparkdl_tpu_torch.runner.chaos.FaultPlan` passed to
  ``supervise`` is serialized into the workers' env (``SPARKDL_CHAOS``),
  so every one of these paths is testable with no change to the worker.
- **Poison-batch quarantine**: two consecutive gang failures attributed
  by the merged timeline to the same ``(step, batch_index)`` mark that
  batch a deterministic gang-killer; the supervisor appends it to the
  workers' dataset skip-list (``SPARKDL_SKIP_BATCHES`` →
  ``runner/data.py``) and relaunches without burning the restart budget,
  bounded by ``SPARKDL_MAX_SKIPPED_BATCHES`` (fatal ``PoisonDataError``).
- **Elastic resizing** (``SPARKDL_ELASTIC``): the same rank dying in two
  consecutive attempts shrinks the gang by one, free; later budgeted
  restarts probe the original size again.

Contract: ``launch(script, np=N)`` spawns N copies of ``python script``
with the rendezvous env set:

- ``SPARKDL_COORDINATOR``   — host:port of rank 0's ``torch.distributed``
  store
- ``SPARKDL_NUM_PROCESSES`` — N
- ``SPARKDL_PROCESS_ID``    — 0..N-1

``XlaRunner(...)`` in the worker joins the gang from these
(``xla_runner._init_gang``), so a worker script needs no launcher
awareness beyond constructing the runner as usual. Each attempt gets a
fresh rendezvous port: a SIGKILLed rank's store is never reused. A
relaunched rank loads the kernel library already built in
``sparkdl_tpu_torch/_build/`` (``ops/_build.py``), so a restart compiles
nothing; the reference's persistent XLA compilation cache has no
counterpart here.

This module imports the standard library and the runner's stdlib-only
modules (``events``, ``failures``, ``telemetry``, ``chaos``, ``data``),
never torch: the supervisor must not take a card, or a CUDA context on
it, from its workers. ``metrics`` (its counters) is imported lazily.

CLI: ``python -m sparkdl_tpu_torch.runner.launcher --np 2 [--restarts R]
[--watchdog S] train.py [args...]``
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

from . import events as events_lib
from . import failures
from . import telemetry as telemetry_lib
from .chaos import FaultPlan
from .data import SKIP_ENV, env_skip_list
from .failures import PoisonDataError

MAX_SKIP_ENV = "SPARKDL_MAX_SKIPPED_BATCHES"
_DEFAULT_MAX_SKIPPED = 16

__all__ = ["launch", "supervise", "free_port", "GangFailure",
           "SuperviseResult"]

log = logging.getLogger("sparkdl_tpu_torch.runner")

_KILL_GRACE_S = 2.0  # SIGTERM -> SIGKILL escalation window


class GangFailure(RuntimeError):
    """A gang attempt failed. ``kind`` is the restart policy verdict
    ("retryable"/"fatal"), ``hung`` marks watchdog/timeout detections,
    ``results`` holds whatever per-rank output was salvaged (None for ranks
    still running when the gang was killed), and ``timeline`` — when the
    workers streamed flight-recorder events — is the merged gang timeline
    (``events.merge_timeline``) naming the first-failing rank, its last
    step, and the fault site."""

    def __init__(self, message: str, kind: str = "retryable",
                 hung: bool = False, results: list | None = None,
                 timeline: dict | None = None):
        super().__init__(message)
        self.kind = kind
        self.hung = hung
        self.results = results or []
        self.timeline = timeline


@dataclasses.dataclass
class SuperviseResult:
    """What :func:`supervise` returns: the final (successful) gang's
    per-rank results plus the recovery ledger. ``degradations``
    lists the faults the final attempt *survived* — checkpoint rollbacks,
    dispatch retries, quarantined rows — pulled from the ranks' event
    streams: a run that recovered is a success that must not look
    pristine."""
    results: list
    restarts: int
    attempts: int
    failure_kinds: list
    degradations: list = dataclasses.field(default_factory=list)
    # Poison batches appended to the dataset skip-list across restarts:
    # global batch indices the final attempt trained WITHOUT.
    quarantined_batches: list = dataclasses.field(default_factory=list)
    # Gang-level telemetry view: the per-rank live snapshots
    # under SPARKDL_METRICS_DIR aggregated at completion
    # (telemetry.aggregate_snapshots) — per-stage busy-seconds/rows/bytes
    # summed across ranks. None when no rank exported metrics.
    metrics: dict | None = None
    # Elastic gang supervision: world-size changes the
    # supervisor made (shrinks around permanently dead ranks, grow-back
    # probes, probe reverts) and the world size of the attempt that
    # finally succeeded.
    resizes: int = 0
    final_np: int | None = None

    @property
    def last_failure_kind(self) -> str | None:
        return self.failure_kinds[-1] if self.failure_kinds else None

    @property
    def rolled_back(self) -> bool:
        """True when any rank restored from an older checkpoint than the
        newest on disk (corrupt step quarantined + rollback)."""
        return any(d.get("name") == "checkpoint_rollback"
                   for d in self.degradations)


def _batch_signature(err: "GangFailure") -> tuple | None:
    """(step, batch_index) the gang timeline attributes the failure to, or
    None when no batch evidence exists. Two consecutive attempts dying
    with the SAME signature is the poison-batch trigger: a transient
    fault lands elsewhere on the replayed stream, a deterministic poison
    batch kills the gang at the identical position every time."""
    ff = (err.timeline or {}).get("first_failure") or {}
    bi = ff.get("batch_index")
    if bi is None:
        return None
    try:
        return (ff.get("step"), int(bi))
    except (TypeError, ValueError):
        return None


def _record_batch_quarantine():
    """run_stats counter for a quarantined training batch — a lazy
    import, as in ``chaos._record_fault``: the launcher's own imports stay
    the standard library and the runner's stdlib-only modules."""
    try:
        from . import metrics as metrics_lib
        metrics_lib.run_stats.record_batch_quarantine()
    except Exception:
        pass


def _record_resize(from_np: int, to_np: int, rank: int | None = None):
    """run_stats + telemetry counters for an elastic resize.
    run_stats follows the lazy-import rule above; the ``gang_resizes``
    telemetry counter is stdlib (telemetry_lib is already a supervisor
    import) and counts regardless of the exporter being armed."""
    try:
        from . import metrics as metrics_lib
        metrics_lib.run_stats.record_resize(from_np, to_np, rank=rank)
    except Exception:
        pass
    try:
        telemetry_lib.registry().counter("gang_resizes").inc()
    except Exception:
        pass


def _dead_rank_evidence(status: str, info: dict, err: GangFailure) \
        -> int | None:
    """The rank the failure evidence names as (the first) dead, or None
    when the evidence doesn't implicate one specific rank — the elastic
    shrink trigger correlates on this across consecutive attempts, the
    same way poison-batch quarantine correlates on the batch index.

    Only RETRYABLE verdicts qualify: a fatal classification means the
    program is the problem (user bug, poison data) and relaunching
    smaller would just re-run the bug on fewer devices. A ``timeout`` has
    no per-rank attribution (the whole gang missed the deadline)."""
    if err.kind != "retryable":
        return None
    if status == "failed":
        ranks = (info or {}).get("ranks") or []
        return int(ranks[0]) if ranks else None
    if status == "hung":
        rank = (info or {}).get("rank")
        return int(rank) if rank is not None else None
    return None


def free_port() -> int:
    """An OS-assigned free TCP port for the coordination service."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Drain:
    """Background readers for a child's pipes: the poll loop must never
    block on I/O, and a worker must never block on a full pipe while the
    supervisor is polling its siblings.

    Retention is TAIL-bounded (``cap_bytes`` per stream): a multi-day gang
    logging per-step metrics must not grow the supervisor's RSS without
    bound, and classification/postmortems only ever read the tail anyway.
    """

    def __init__(self, proc: subprocess.Popen,
                 cap_bytes: int = 2 * 1024 * 1024):
        self._cap = cap_bytes
        self._out: list[str] = []
        self._err: list[str] = []
        self._truncated = {id(self._out): False, id(self._err): False}
        self._threads = []
        for stream, sink in ((proc.stdout, self._out),
                             (proc.stderr, self._err)):
            if stream is None:
                continue
            t = threading.Thread(target=self._pump, args=(stream, sink),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _pump(self, stream, sink):
        size = 0
        try:
            for line in stream:
                sink.append(line)
                size += len(line)
                while size > self._cap and len(sink) > 1:
                    size -= len(sink.pop(0))
                    self._truncated[id(sink)] = True
        except ValueError:
            pass  # stream closed under us during gang kill
        finally:
            try:
                stream.close()
            except OSError:
                pass

    def join(self, timeout: float = 5.0):
        for t in self._threads:
            t.join(timeout)

    def _text(self, sink) -> str:
        head = "[... earlier output dropped ...]\n" \
            if self._truncated[id(sink)] else ""
        return head + "".join(sink)

    @property
    def stdout(self) -> str:
        return self._text(self._out)

    @property
    def stderr(self) -> str:
        return self._text(self._err)


def _spawn_gang(script: str, np: int, args, env, coordinator: str | None,
                capture: bool, heartbeat_dir: str | None = None,
                event_dir: str | None = None):
    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    procs: list[subprocess.Popen] = []
    drains: list[_Drain] = []
    for rank in range(np):
        penv = dict(os.environ)
        penv.update(env or {})
        penv.update({
            "SPARKDL_COORDINATOR": coordinator,
            "SPARKDL_NUM_PROCESSES": str(np),
            "SPARKDL_PROCESS_ID": str(rank),
        })
        if heartbeat_dir:
            penv["SPARKDL_HEARTBEAT_DIR"] = heartbeat_dir
        if event_dir:
            penv["SPARKDL_EVENT_DIR"] = event_dir
        p = subprocess.Popen(
            [sys.executable, script] + list(args or []),
            env=penv,
            stdout=subprocess.PIPE if capture else None,
            stderr=subprocess.PIPE if capture else None,
            text=True)
        procs.append(p)
        drains.append(_Drain(p))
    return procs, drains


def _kill_gang(procs: list[subprocess.Popen]):
    """Terminate every still-running rank: SIGTERM, a short grace, SIGKILL.
    A dead peer leaves survivors blocked inside a collective — they will
    not exit on their own."""
    running = [p for p in procs if p.poll() is None]
    for p in running:
        try:
            p.terminate()
        except OSError:
            pass
    deadline = time.monotonic() + _KILL_GRACE_S
    for p in running:
        try:
            p.wait(timeout=max(0.05, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
    for p in running:
        try:
            p.wait(timeout=_KILL_GRACE_S)
        except subprocess.TimeoutExpired:
            pass


def _parse_heartbeat_step(body: str) -> str:
    """Heartbeat body → step string (format contract decoded in ONE place:
    ``events.parse_heartbeat_body``)."""
    step = events_lib.parse_heartbeat_body(body).get("step")
    return "" if step is None else str(step)


def _heartbeat_ages(heartbeat_dir: str, np: int,
                    now: float) -> dict[int, tuple[float, str]]:
    """rank -> (seconds since last beat, last step written). Ranks that
    never beat yet are absent — a rank is watchdog-eligible only after its
    first heartbeat (start-up — imports, the CUDA context, the first step's
    allocations and cuDNN plans — must not trip the watchdog; a
    hang *before* the first step is ``timeout_s``'s job)."""
    ages = {}
    for rank in range(np):
        path = os.path.join(heartbeat_dir, f"rank{rank}.hb")
        try:
            st = os.stat(path)
            with open(path) as f:
                step = _parse_heartbeat_step(f.read())
            ages[rank] = (now - st.st_mtime, step)
        except OSError:
            continue
    return ages


def _clear_heartbeats(heartbeat_dir: str, np: int):
    """Remove ALL ``rank*.hb`` files, not just ``range(np)``: after an
    elastic shrink the new, smaller attempt would otherwise
    leave the dead rank's old beat from the larger previous attempt on
    disk — stale liveness evidence the watchdog scan (and any postmortem
    reading the dir) must never see. ``np`` is kept for signature
    stability; the glob covers every rank any previous attempt had."""
    del np  # the glob below is rank-set-agnostic on purpose
    try:
        names = os.listdir(heartbeat_dir)
    except OSError:
        return
    for fn in names:
        if fn.startswith("rank") and fn.endswith(".hb"):
            try:
                os.unlink(os.path.join(heartbeat_dir, fn))
            except OSError:
                pass


def _collect(procs, drains, capture: bool):
    """Per-rank CompletedProcess list; None for ranks with no exit code
    (cannot happen after _kill_gang, but be defensive)."""
    results = []
    for p, d in zip(procs, drains):
        if capture:
            d.join()
        rc = p.poll()
        results.append(None if rc is None else subprocess.CompletedProcess(
            p.args, rc, d.stdout if capture else None,
            d.stderr if capture else None))
    return results


def _rank_tail(results, rank: int, n: int = 2000) -> str:
    r = results[rank] if rank < len(results) else None
    if r is None:
        return ""
    return (r.stderr or r.stdout or "")[-n:]


def _run_gang(script: str, np: int, args, env, timeout_s: float,
              coordinator: str | None, capture: bool, poll_s: float,
              heartbeat_dir: str | None, watchdog_s: float | None,
              event_dir: str | None = None):
    """One gang attempt. Returns (status, results, info):

    - ("ok", results, {})           — every rank exited 0
    - ("failed", results, {ranks})  — first nonzero exit (within poll_s)
    - ("hung", results, {rank, age, step}) — heartbeat went stale
    - ("timeout", results, {running}) — wall deadline hit
    """
    if heartbeat_dir:
        # Stale beats from a previous attempt/run would trip the watchdog
        # on the first poll of a freshly spawned gang.
        _clear_heartbeats(heartbeat_dir, np)
    if event_dir:
        # Same staleness rule for traces: attempt N's timeline must not
        # splice attempt N-1's events.
        events_lib.clear_rank_files(event_dir)
    procs, drains = _spawn_gang(script, np, args, env, coordinator, capture,
                                heartbeat_dir=heartbeat_dir,
                                event_dir=event_dir)
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                _kill_gang(procs)
                return ("failed", _collect(procs, drains, capture),
                        {"ranks": failed,
                         "detect_s": time.monotonic() - t0})
            if all(c == 0 for c in codes):
                return "ok", _collect(procs, drains, capture), {}
            if watchdog_s and heartbeat_dir:
                now = time.time()
                ages = _heartbeat_ages(heartbeat_dir, np, now)
                stale = [(r, a, s) for r, (a, s) in ages.items()
                         if codes[r] is None and a > watchdog_s]
                if stale:
                    rank, age, step = max(stale, key=lambda x: x[1])
                    _kill_gang(procs)
                    return ("hung", _collect(procs, drains, capture),
                            {"rank": rank, "age": age, "step": step,
                             "ages": {r: round(a, 1)
                                      for r, (a, _) in ages.items()}})
            if time.monotonic() > deadline:
                running = [r for r, c in enumerate(codes) if c is None]
                _kill_gang(procs)
                info = {"running": running}
                if heartbeat_dir:
                    info["ages"] = {
                        r: round(a, 1) for r, (a, _) in
                        _heartbeat_ages(heartbeat_dir, np,
                                        time.time()).items()}
                return "timeout", _collect(procs, drains, capture), info
            time.sleep(poll_s)
    finally:
        _kill_gang(procs)


def _gang_event_subdir(env: dict | None) -> str | None:
    """Resolve a gang's event dir from an env-var-sourced parent, or None.

    An env-var-sourced dir (the caller's env= dict or this process's
    environment) may be the dir the caller's OWN recorder is streaming
    into (``enable_flight_recorder`` sets the same var) — give the gang a
    UNIQUE subdir so per-attempt clearing can never unlink the caller's
    live events_rank0.jsonl, and two concurrent gangs sharing the env
    can't clobber each other's traces. An explicit ``event_dir=`` argument
    is the caller's deliberate choice and bypasses this."""
    inherited = (env or {}).get("SPARKDL_EVENT_DIR") or \
        os.environ.get("SPARKDL_EVENT_DIR")
    if not inherited:
        return None
    try:
        os.makedirs(inherited, exist_ok=True)
        return tempfile.mkdtemp(prefix="gang-", dir=inherited)
    except OSError:
        return None


def _prune_empty_gang_dir(adopted_dir: str | None):
    """Drop an adopted gang-* subdir that ended up with no files. A
    NON-empty one is kept even on success: the user exported
    SPARKDL_EVENT_DIR asking for telemetry, and deleting their streams
    would break the README's jq-over-the-dir contract; cleanup of
    accumulated gang-* dirs is the owner's call."""
    if not adopted_dir:
        return
    try:
        # The supervisor's own trace manifest doesn't count as worker
        # telemetry: a gang whose ranks wrote no traces still prunes.
        if os.listdir(adopted_dir) == [events_lib.TRACE_MANIFEST_FILE]:
            os.unlink(os.path.join(adopted_dir,
                                   events_lib.TRACE_MANIFEST_FILE))
    except OSError:
        pass
    try:
        os.rmdir(adopted_dir)  # only succeeds when empty — exactly right
    except OSError:
        pass


def _gang_metrics(metrics_dir: str | None) -> dict | None:
    """Aggregate the ranks' live telemetry snapshots (never raises — a
    telemetry assembly bug must not replace the primary outcome)."""
    if not metrics_dir:
        return None
    try:
        return telemetry_lib.aggregate_snapshots(metrics_dir)
    except Exception:
        log.warning("gang metrics aggregation failed", exc_info=True)
        return None


def _metrics_dir_from(env: dict | None) -> str | None:
    """The metrics dir the workers will export into: the caller's env=
    dict wins over the supervisor's inherited environment (same
    resolution order _spawn_gang's penv merge produces)."""
    return (env or {}).get(telemetry_lib.METRICS_DIR_ENV) or \
        os.environ.get(telemetry_lib.METRICS_DIR_ENV)


def _adopt_gang_metrics_dir(env: dict) -> str | None:
    """Give the gang a fresh ``gang-*`` snapshot subdir under the
    inherited metrics dir and point the workers' exporters at it
    (mutates ``env``). The inherited dir may hold a previous run's
    ``metrics_rank*.json`` — including higher ranks from a larger
    earlier gang — or the CALLER's own live exporter snapshot;
    aggregating those as this gang's books would misattribute stages.
    Returns the adopted subdir, or None when no metrics dir is armed
    (or it cannot be created — telemetry degrades, never kills the
    launch)."""
    metrics_dir = _metrics_dir_from(env)
    if not metrics_dir:
        return None
    try:
        os.makedirs(metrics_dir, exist_ok=True)
        adopted = tempfile.mkdtemp(prefix="gang-", dir=metrics_dir)
        env[telemetry_lib.METRICS_DIR_ENV] = adopted
        return adopted
    except OSError:
        return None


def _gang_timeline(event_dir: str | None, heartbeat_dir: str | None,
                   metrics_dir: str | None = None):
    """Merge the ranks' flight-recorder traces into the gang timeline.
    Returns (timeline_dict | None, message_suffix). Never raises — a
    postmortem assembly bug must not replace the primary failure."""
    if not event_dir:
        return None, ""
    try:
        tl = events_lib.merge_timeline(event_dir,
                                       heartbeat_dir=heartbeat_dir)
        # Workers wrote no traces (scripts without the runner): suppress
        # the empty timeline block. Heartbeat files alone seed rank
        # entries with n_events=0 — those don't count as a trace.
        if not any(d.get("n_events") or d.get("postmortem")
                   for d in tl["ranks"].values()):
            return None, ""
        # Fold the gang's final telemetry view into the timeline: the
        # postmortem then shows which stage was starving when the gang
        # died, next to who died first.
        gm = _gang_metrics(metrics_dir)
        if gm is not None:
            tl["metrics"] = gm
        path = events_lib.write_gang_postmortem(event_dir, tl)
        return tl, "\n" + events_lib.format_timeline(tl) + \
            f"\n(merged gang timeline: {path})"
    except Exception:
        log.warning("gang timeline assembly failed", exc_info=True)
        return None, ""


def _failure(status: str, results, info, timeout_s: float, capture: bool,
             event_dir: str | None = None,
             heartbeat_dir: str | None = None,
             metrics_dir: str | None = None) -> GangFailure:
    """Build the GangFailure for a non-ok attempt: message carries the
    postmortem (which ranks died/stalled + salvaged stderr + the merged
    gang timeline when the workers streamed events), ``kind`` carries the
    restart-policy verdict."""
    timeline, tl_msg = _gang_timeline(event_dir, heartbeat_dir,
                                      metrics_dir=metrics_dir)
    if status == "failed":
        ranks = info["ranks"]
        first = ranks[0]
        tail = _rank_tail(results, first)
        rc = results[first].returncode if results[first] else None
        # Killed-by-signal (negative rc) with no stderr reads like a
        # preemption/OOM-kill — retryable. Otherwise classify the text.
        kind = ("retryable" if (rc is not None and rc < 0 and not tail)
                else failures.classify_text(tail))
        msg = (f"launch: rank(s) {ranks} exited nonzero "
               f"(rank {first} rc={rc}, detected in "
               f"{info.get('detect_s', 0.0):.1f}s, classified {kind})")
        if tail:
            msg += "\n" + tail
        return GangFailure(msg + tl_msg, kind=kind, results=results,
                           timeline=timeline)
    if status == "hung":
        msg = (f"launch: heartbeat watchdog tripped — rank {info['rank']} "
               f"last beat {info['age']:.1f}s ago (at step "
               f"{info['step'] or '?'}); per-rank heartbeat ages: "
               f"{info.get('ages')}")
        return GangFailure(msg + tl_msg, kind="retryable", hung=True,
                           results=results, timeline=timeline)
    # timeout: salvage whatever completed ranks left behind so the
    # postmortem shows WHICH rank stopped making progress.
    running = info.get("running", [])
    done = [r for r, res in enumerate(results)
            if res is not None and r not in running]
    msg = (f"launch: workers did not finish within {timeout_s}s "
           f"(rendezvous hang? a dead peer blocks collectives); "
           f"rank(s) {running} still running, rank(s) {done} had exited")
    if info.get("ages"):
        msg += f"; last heartbeat ages: {info['ages']}"
    if capture:
        for r, res in enumerate(results):
            if res is None:
                continue
            tail = (res.stderr or res.stdout or "")[-800:]
            if tail:
                msg += f"\n--- rank {r} (rc={res.returncode}) ---\n{tail}"
    return GangFailure(msg + tl_msg, kind="retryable", hung=True,
                       results=results, timeline=timeline)


def launch(script: str, np: int = 2, args: list[str] | None = None,
           env: dict | None = None, timeout_s: float = 600.0,
           coordinator: str | None = None,
           capture: bool = False, poll_s: float = 0.5,
           heartbeat_dir: str | None = None,
           watchdog_s: float | None = None,
           event_dir: str | None = None
           ) -> list[subprocess.CompletedProcess]:
    """Spawn ``np`` copies of ``python script`` wired for
    ``torch.distributed``.

    Blocks until all workers exit. The wait is a concurrent poll loop: the
    first nonzero exit is detected within ``poll_s`` and the surviving
    ranks are killed immediately (a dead peer leaves them hung on a
    collective — the old sequential wait burned the full ``timeout_s``
    before noticing). Raises :class:`GangFailure` (a ``RuntimeError``)
    carrying the failed ranks, salvaged stderr, and the retryable/fatal
    classification.

    ``capture=True`` collects each worker's stdout/stderr (drained
    concurrently — a chatty worker can't deadlock the poll loop).
    ``watchdog_s`` + ``heartbeat_dir`` arm the hang watchdog (see module
    docstring). ``event_dir`` arms the flight recorder in every rank
    (``SPARKDL_EVENT_DIR``); on failure the per-rank traces are merged
    into a gang timeline riding the raised :class:`GangFailure`.
    """
    if np < 1:
        raise ValueError(f"np must be >= 1, got {np}")
    adopted_dir = None
    if event_dir is None:
        # Same isolation rule as supervise(): an env-var-sourced dir may
        # be the caller's own live recorder stream — give the gang its
        # own subdir (and by adopting it, a failure here gets a merged
        # timeline instead of silently skipping it).
        event_dir = adopted_dir = _gang_event_subdir(env)
    if event_dir:
        os.makedirs(event_dir, exist_ok=True)
    # Same metrics-dir isolation as supervise() (see
    # _adopt_gang_metrics_dir): a reused dir's stale rank books must not
    # become THIS gang's failure evidence.
    env = dict(env or {})
    metrics_dir = adopted_metrics_dir = _adopt_gang_metrics_dir(env)
    # Trace context: single-attempt twin of supervise()'s
    # per-attempt spans — every rank chains under one launch-root span.
    trace_id = env.get(events_lib.TRACE_ID_ENV) \
        or os.environ.get(events_lib.TRACE_ID_ENV) \
        or events_lib.new_trace_id()
    env[events_lib.TRACE_ID_ENV] = trace_id
    trace_root = events_lib.new_span_id()
    env[events_lib.TRACE_PARENT_ENV] = trace_root
    if event_dir:
        try:
            events_lib.atomic_write_json(
                os.path.join(event_dir, events_lib.TRACE_MANIFEST_FILE),
                {"trace_id": trace_id, "root_span_id": trace_root,
                 "spans": [{"span_id": trace_root, "parent_id": None,
                            "name": "launch", "t": round(time.time(), 6),
                            "np": np,
                            "script": os.path.basename(script)}]})
        except OSError:
            pass
    status, results, info = _run_gang(
        script, np, args, env, timeout_s, coordinator, capture, poll_s,
        heartbeat_dir, watchdog_s, event_dir=event_dir)
    if status == "ok":
        _prune_empty_gang_dir(adopted_dir)
        _prune_empty_gang_dir(adopted_metrics_dir)
        return results
    err = _failure(status, results, info, timeout_s, capture,
                   event_dir=event_dir, heartbeat_dir=heartbeat_dir,
                   metrics_dir=metrics_dir)
    # Workers wrote no traces (scripts without the runner): drop the
    # empty adopted subdir. rmdir-only-when-empty, NOT rmtree keyed on
    # err.timeline — timeline assembly can fail with real evidence on
    # disk, and that evidence must survive.
    _prune_empty_gang_dir(adopted_dir)
    _prune_empty_gang_dir(adopted_metrics_dir)
    raise err


def supervise(script: str, np: int = 2, args: list[str] | None = None,
              env: dict | None = None, timeout_s: float = 600.0,
              max_restarts: int = 2, backoff_s: float = 1.0,
              poll_s: float = 0.5, watchdog_s: float | None = None,
              heartbeat_dir: str | None = None, capture: bool = True,
              plan: FaultPlan | None = None,
              retry_all: bool = False,
              event_dir: str | None = None,
              quarantine_batches: bool = True,
              max_skipped_batches: int | None = None,
              elastic: bool | None = None,
              min_np: int | None = None) -> SuperviseResult:
    """Budgeted checkpoint-restart supervision of a worker gang — the
    multi-process twin of ``XlaRunner.run_with_restarts``.

    Each attempt launches the full gang (fresh coordinator port per
    attempt). On failure the captured stderr is classified
    (``failures.classify_text``): retryable — preemption, crash-by-signal,
    hang (watchdog or timeout) — relaunches after ``backoff_s * 2**n``
    under the ``max_restarts`` budget; fatal re-raises immediately
    (``retry_all=True`` restores indiscriminate retry). Workers that pass
    a ``checkpoint_dir`` to ``fit(resume=True)`` resume from
    ``CheckpointManager.latest_step`` — a restart loses at most
    ``checkpoint_every`` steps.

    ``watchdog_s`` arms the heartbeat hang watchdog (a temp heartbeat dir
    is created when none is given; workers find it via
    ``SPARKDL_HEARTBEAT_DIR``). ``plan`` injects a chaos
    :class:`~sparkdl_tpu_torch.runner.chaos.FaultPlan` into the workers'
    env; a plan without a ``state_dir`` gets a temp one so ``once`` faults
    stay once across relaunches.

    The flight recorder is armed in every supervised rank: ``event_dir``
    (or ``SPARKDL_EVENT_DIR`` in ``env``/the supervisor's environment, or
    a temp dir when neither is given) receives per-rank event streams, and
    every gang failure carries the merged timeline — which rank failed or
    stalled first, at what step, at which site. The temp dir is kept on
    the give-up path for postmortems, removed on success.

    **Poison-batch quarantine** (``quarantine_batches=True``):
    when two *consecutive* failures are attributed by the gang timeline to
    the same ``(step, batch_index)`` — the signature of a deterministic
    poison batch, since a transient fault lands elsewhere on the replayed
    stream — the batch is appended to the workers' dataset skip-list
    (``SPARKDL_SKIP_BATCHES``) and the gang relaunches *without consuming
    the restart budget* (excluding the poison is progress, not a retry).
    A batch-attributed FATAL failure (e.g. ``TrainingDivergedError`` from
    a NaN-producing record) gets one budget-counted probe restart to test
    determinism instead of giving up outright; batch-less failures keep
    the plain restart/fatal policy unchanged. Each quarantine records a
    ``train_batch_quarantined`` degradation (``SuperviseResult``,
    run_stats, flight-recorder event). ``max_skipped_batches`` (default
    ``SPARKDL_MAX_SKIPPED_BATCHES``, 16) bounds the skip-list: past it a
    fatal :class:`~sparkdl_tpu_torch.runner.failures.PoisonDataError`
    stops the supervisor from eating the dataset one batch at a time.

    **Elastic gang supervision** (``elastic=True`` or
    ``SPARKDL_ELASTIC=1``): when the SAME rank dies in two *consecutive*
    attempts at the same world size — the signature of a permanently lost
    machine, since a transient preemption lands elsewhere (or nowhere) on
    the relaunch — the gang **shrinks by one rank and relaunches without
    consuming the restart budget** (losing a machine is the platform's
    doing; the budget is for failures the supervisor can't act on),
    bounded below by ``min_np`` (default ``SPARKDL_ELASTIC_MIN_NP``, 1).
    Every later *budgeted* restart of a shrunken gang **re-probes the
    original world size** (recovered capacity grows the gang back); a
    probe that dies on a rank reverts to the working size as another free
    relaunch. Each resize records a ``gang_resized`` degradation
    (flight-recorder event + ``SuperviseResult.degradations``),
    ``run_stats.resizes``, and the ``gang_resizes`` telemetry counter;
    ``SuperviseResult.final_np`` reports the world size that finished.
    ``SPARKDL_ELASTIC=1`` is propagated to the workers, whose
    ``CheckpointManager.restore`` loads the other world size's
    checkpoint instead of refusing it (the gang's state is replicated, the
    same on every rank) — and a ``shard=True``
    checkpointable dataset replays its cursor correctly at the new world
    size because per-rank slices are cut from the GLOBAL stream at draw
    time (see ``runner/data.py``). Fatal failures never shrink: a user
    bug on 4 ranks is the same bug on 3.
    """
    if np < 1:
        raise ValueError(f"np must be >= 1, got {np}")
    env = dict(env or {})
    tmp_dirs = []  # created-by-us scratch, removed on success only
    if plan is not None:
        if plan.state_dir is None:
            plan = dataclasses.replace(
                plan, faults=list(plan.faults),
                state_dir=tempfile.mkdtemp(prefix="sparkdl-chaos-"))
            tmp_dirs.append(plan.state_dir)
        env.update(plan.to_env())
    if watchdog_s and not heartbeat_dir:
        heartbeat_dir = tempfile.mkdtemp(prefix="sparkdl-hb-")
        tmp_dirs.append(heartbeat_dir)
    if heartbeat_dir:
        os.makedirs(heartbeat_dir, exist_ok=True)
        env["SPARKDL_HEARTBEAT_DIR"] = heartbeat_dir
    adopted_dir = None
    if event_dir is None:
        # KEPT on success (unless empty): an exported SPARKDL_EVENT_DIR is
        # the user asking for telemetry — only the fully auto-created
        # tempdir below is supervisor scratch that vanishes with the run.
        event_dir = adopted_dir = _gang_event_subdir(env)
    if event_dir is None:
        event_dir = tempfile.mkdtemp(prefix="sparkdl-events-")
        tmp_dirs.append(event_dir)
    os.makedirs(event_dir, exist_ok=True)
    env["SPARKDL_EVENT_DIR"] = event_dir

    # Causal trace root: ONE run-level trace id for the whole
    # supervised run (a caller-minted id wins — supervise may be a
    # child of a larger traced pipeline); each attempt mints a fresh span
    # under the run root and ships it as SPARKDL_TRACE_PARENT, so every
    # rank-side span chains to the attempt that launched it. The manifest
    # is the supervisor's half of the tree — trace_export resolves rank
    # parent chains through it even after per-attempt stream clearing.
    trace_id = env.get(events_lib.TRACE_ID_ENV) \
        or os.environ.get(events_lib.TRACE_ID_ENV) \
        or events_lib.new_trace_id()
    env[events_lib.TRACE_ID_ENV] = trace_id
    trace_root = events_lib.new_span_id()
    trace_spans: list[dict] = [
        {"span_id": trace_root, "parent_id": None, "name": "supervise",
         "t": round(time.time(), 6), "np": np,
         "script": os.path.basename(script)}]

    def _trace_span(name: str, ship: bool = False, **attrs) -> str:
        """Record a supervisor-side span in the manifest; ``ship=True``
        also makes it the env-shipped parent for the next gang attempt."""
        sid = events_lib.new_span_id()
        trace_spans.append({"span_id": sid, "parent_id": trace_root,
                            "name": name, "t": round(time.time(), 6),
                            **attrs})
        if ship:
            env[events_lib.TRACE_PARENT_ENV] = sid
        try:
            events_lib.atomic_write_json(
                os.path.join(event_dir, events_lib.TRACE_MANIFEST_FILE),
                {"trace_id": trace_id, "root_span_id": trace_root,
                 "spans": trace_spans})
        except OSError:
            pass
        return sid

    if max_skipped_batches is None:
        try:
            max_skipped_batches = int(
                env.get(MAX_SKIP_ENV)
                or os.environ.get(MAX_SKIP_ENV, _DEFAULT_MAX_SKIPPED))
        except ValueError:
            max_skipped_batches = _DEFAULT_MAX_SKIPPED
    skip_list = sorted(set(env_skip_list(env) if SKIP_ENV in env
                           else env_skip_list()))
    quarantined: list[int] = []
    extra_degradations: list[dict] = []  # supervisor-side (quarantines)
    prev_sig: tuple | None = None  # last failure's (step, batch_index)

    # Elastic resize state. env= wins over the process environment,
    # explicit kwargs win over both (same resolution order as every other
    # supervisor knob).
    elastic_on = failures.elastic_enabled(env) if elastic is None \
        else bool(elastic)
    if elastic_on:
        # The workers must know: their checkpoint restore loads a
        # cross-topology manifest instead of refusing it.
        env.setdefault(failures.ELASTIC_ENV, "1")
    floor_np = failures.elastic_min_np(env) if min_np is None \
        else max(1, int(min_np))
    target_np = np        # the asked-for size; grow-back probe ceiling
    cur_np = np           # the size the next attempt launches at
    probe_from: int | None = None  # size to revert to if a probe fails
    prev_dead: tuple | None = None  # last failure's (np, dead rank)
    resizes = 0

    restarts = 0      # every relaunch, for the recovery ledger
    budget_used = 0   # failure-driven relaunches, checked against budget
    kinds: list[str] = []
    # Live telemetry: when the workers will export snapshots
    # (SPARKDL_METRICS_DIR in env= or the environment), the supervisor
    # aggregates them into the gang-level view at completion — and
    # clears attempt N-1's files first, same staleness rule as traces.
    # The gang gets its own subdir (see _adopt_gang_metrics_dir); kept
    # on completion when non-empty, like gang event dirs.
    metrics_dir = adopted_metrics_dir = _adopt_gang_metrics_dir(env)

    def _resize(to_np: int, reason: str, dead_rank: int | None = None,
                probe: bool = False):
        """World-size change bookkeeping: counters, flight-recorder event,
        supervisor-side degradation record (same shape as the ranks'
        collected events), and the new launch size."""
        nonlocal cur_np, resizes
        _record_resize(cur_np, to_np, rank=dead_rank)
        # The resize gets its own manifest span, and the flight-recorder
        # event carries the ids EXPLICITLY: the supervisor's own process env
        # is not traced (trace id lives in the CHILD env), so emit()'s
        # ambient attachment would leave the resize orphaned.
        resize_span = _trace_span("gang_resize", from_np=cur_np,
                                  to_np=to_np, reason=reason)
        events_lib.event("gang_resized", from_np=cur_np, to_np=to_np,
                         reason=reason, dead_rank=dead_rank, probe=probe,
                         trace_id=trace_id, span_id=resize_span,
                         parent_id=trace_root)
        extra_degradations.append({
            "t": round(time.time(), 6), "rank": None, "name": "gang_resized",
            "from_np": cur_np, "to_np": to_np, "reason": reason,
            "dead_rank": dead_rank})
        resizes += 1
        cur_np = to_np

    while True:
        # (_run_gang clears attempt N-1's heartbeats/traces before spawning)
        _trace_span("gang_attempt", ship=True, attempt=restarts + 1,
                    np=cur_np)
        if metrics_dir:
            telemetry_lib.clear_rank_files(metrics_dir)
        status, results, info = _run_gang(
            script, cur_np, args, env, timeout_s, None, capture, poll_s,
            heartbeat_dir, watchdog_s, event_dir=event_dir)
        if status == "ok":
            # Survived-fault ledger BEFORE cleanup: a gang that recovered
            # by rolling back a corrupt checkpoint / retrying a flaky
            # dispatch / quarantining rows or poison batches reports it
            # (a degradation is recorded, never silently absorbed).
            try:
                degradations = events_lib.collect_degradations(event_dir)
            except Exception:
                degradations = []
            degradations = sorted(degradations + extra_degradations,
                                  key=lambda d: d.get("t", 0))
            if degradations:
                log.warning(
                    "supervise: gang succeeded after surviving %d "
                    "degradation event(s): %s", len(degradations),
                    sorted({d.get("name") for d in degradations}))
            # Gang-level telemetry BEFORE cleanup: the final attempt's
            # per-rank snapshots merge into one stage-utilization view
            # riding the result next to the degradations.
            gang_metrics = _gang_metrics(metrics_dir)
            for d in tmp_dirs:  # kept on failure paths for postmortems
                shutil.rmtree(d, ignore_errors=True)
            _prune_empty_gang_dir(adopted_dir)
            _prune_empty_gang_dir(adopted_metrics_dir)
            return SuperviseResult(results=results, restarts=restarts,
                                   attempts=restarts + 1,
                                   failure_kinds=kinds,
                                   degradations=degradations,
                                   quarantined_batches=list(quarantined),
                                   metrics=gang_metrics,
                                   resizes=resizes, final_np=cur_np)
        err = _failure(status, results, info, timeout_s, capture,
                       event_dir=event_dir, heartbeat_dir=heartbeat_dir,
                       metrics_dir=metrics_dir)
        dead = _dead_rank_evidence(status, info, err) if elastic_on else None
        if elastic_on and probe_from is not None:
            # The attempt that just failed was a grow-back probe at the
            # original world size.
            was_probe_from, probe_from = probe_from, None
            if dead is not None:
                # The probed capacity is still gone (a rank died again).
                # Reverting to the size that worked is a FREE relaunch:
                # the probe answered its question, and burning budget on
                # the answer would punish probing.
                kinds.append("probe_failed")
                restarts += 1
                prev_dead = None
                prev_sig = None
                log.warning(
                    "supervise: grow-back probe at world size %d failed "
                    "(rank %d died); reverting to %d and relaunching "
                    "(restart %d, budget untouched at %d/%d)",
                    cur_np, dead, was_probe_from, restarts, budget_used,
                    max_restarts)
                _resize(was_probe_from, "grow_probe_failed",
                        dead_rank=dead)
                time.sleep(backoff_s)
                continue
            # Inconclusive probe (timeout / fatal / no rank attribution):
            # revert to the working size and fall through to the normal
            # budgeted policy for THIS failure.
            _resize(was_probe_from, "grow_probe_inconclusive")
        sig = _batch_signature(err) if quarantine_batches else None
        # Correlate on the BATCH INDEX: the signature's step component is
        # reported but not compared — evidence sources disagree on it (a
        # data_fetch chaos event's step IS the batch index, a
        # postmortem's is the train step), and a source-selection
        # artifact between two attempts must not hide a genuinely
        # deterministic poison. The batch index is the quarantine key
        # and identical across sources by construction.
        same_batch = (sig is not None and prev_sig is not None
                      and sig[1] == prev_sig[1])
        if same_batch and sig[1] in (skip_list or []):
            # The batch is ALREADY on the skip-list and still killed the
            # gang: the dataset cannot actually skip it (a poison that
            # raises while DRAWING from a non-seekable source dies before
            # the skip check can act — see data.py's skip-list notes).
            # Re-quarantining would alternate budget-restart/free-relaunch
            # forever; fall through to the normal policy and fail fast
            # with the story on record.
            log.error(
                "supervise: batch %s is on the skip-list but still kills "
                "the gang (source cannot skip it — draw-time poison in a "
                "non-seekable source?); not re-quarantining", sig[1])
            sig = None
            same_batch = False
        if same_batch:
            # Two consecutive failures at the SAME (step, batch_index):
            # a deterministic poison batch, not a flake. Quarantine it —
            # append to the workers' skip-list and relaunch WITHOUT
            # consuming the restart budget (excluding the poison is
            # progress; the budget is for failures we can't act on).
            step_, batch_index = sig
            if len(quarantined) >= max_skipped_batches:
                _prune_empty_gang_dir(adopted_dir)
                _prune_empty_gang_dir(adopted_metrics_dir)
                raise PoisonDataError(quarantined, max_skipped_batches,
                                      last_failure=str(err)[:300]) from err
            quarantined.append(batch_index)
            skip_list = sorted(set(skip_list) | {batch_index})
            env[SKIP_ENV] = json.dumps(skip_list)
            kinds.append("quarantined")
            _record_batch_quarantine()
            events_lib.event("train_batch_quarantined",
                             batch_index=batch_index, step=step_,
                             skip_list=skip_list)
            # Same record shape as collect_degradations' raw events
            # ("name" key), so SuperviseResult.degradations is uniform
            # whether a degradation came from a rank's stream or from the
            # supervisor itself.
            extra_degradations.append({
                "t": round(time.time(), 6), "rank": None,
                "name": "train_batch_quarantined",
                "batch_index": batch_index, "step": step_,
                "error": (err.timeline or {}).get(
                    "first_failure", {}).get("error"),
                "skip_list": list(skip_list)})
            prev_sig = None  # correlation window restarts fresh
            prev_dead = None
            restarts += 1
            log.warning(
                "supervise: two consecutive failures attributed to batch "
                "%s (step %s) — quarantined onto the skip-list %s; "
                "relaunching (restart %d, budget untouched at %d/%d)\n%s",
                batch_index, step_, skip_list, restarts, budget_used,
                max_restarts, str(err)[:600])
            time.sleep(backoff_s)
            continue
        if elastic_on and dead is not None and prev_dead == (cur_np, dead):
            # The SAME rank died in two consecutive attempts at the same
            # world size: a permanently lost machine, not a transient
            # flake (which lands elsewhere — or nowhere — on the
            # relaunch). The poison-batch correlation, applied to ranks.
            new_np = cur_np - 1
            if new_np < floor_np:
                err.args = (
                    f"{err}\n(supervise: rank {dead} of {cur_np} is "
                    f"permanently dead, but shrinking to {new_np} would "
                    f"pass the elastic floor ({failures.ELASTIC_MIN_ENV}="
                    f"{floor_np}); giving up after {budget_used} "
                    f"restart(s) of budget {max_restarts}; "
                    f"failure kinds: {kinds})",)
                _prune_empty_gang_dir(adopted_dir)
                _prune_empty_gang_dir(adopted_metrics_dir)
                raise err
            kinds.append("resized")
            restarts += 1
            prev_dead = None   # fresh correlation window at the new size
            prev_sig = None
            log.warning(
                "supervise: rank %d died in two consecutive attempts at "
                "world size %d — permanently dead; shrinking the gang to "
                "%d and relaunching (restart %d, budget untouched at "
                "%d/%d)\n%s", dead, cur_np, new_np, restarts, budget_used,
                max_restarts, str(err)[:600])
            _resize(new_np, "rank_dead", dead_rank=dead)
            time.sleep(backoff_s)
            continue
        kinds.append(err.kind)
        fatal = err.kind == "fatal" and not retry_all
        if fatal and sig is not None and budget_used < max_restarts:
            # Batch-attributed fatal failure (a NaN-producing record
            # raising TrainingDivergedError looks exactly like a user
            # bug): spend ONE budgeted probe restart to test whether it
            # recurs at the same batch before giving up. Recurrence →
            # quarantine above (which is also why reaching here implies
            # sig != prev_sig: a NEW signature always deserves its probe,
            # even right after an unrelated batch-attributed failure);
            # ever-changing fatal signatures stay bounded by the budget.
            prev_sig = sig
            prev_dead = None  # fatal: no rank-death evidence this attempt
            restarts += 1
            budget_used += 1
            backoff = backoff_s * (2 ** (budget_used - 1))
            log.warning(
                "supervise: fatal gang failure attributed to batch %s "
                "(step %s) — probing for a deterministic poison batch "
                "with one restart (%d/%d) in %.1fs\n%s", sig[1], sig[0],
                budget_used, max_restarts, backoff, str(err)[:600])
            time.sleep(backoff)
            continue
        if fatal or budget_used >= max_restarts:
            # budget_used, not restarts: quarantine relaunches were free
            # and must not read as a budget overrun in the postmortem.
            total = (f" ({restarts} relaunches total incl. quarantines)"
                     if restarts != budget_used else "")
            if resizes:
                total += (f"; {resizes} elastic resize(s), last world "
                          f"size {cur_np}")
            err.args = (f"{err}\n(supervise: giving up after {budget_used} "
                        f"restart(s) of budget {max_restarts}{total}; "
                        f"failure kinds: {kinds})",)
            # Same as launch(): an adopted subdir holding no evidence is
            # just clutter in the user's telemetry dir (rmdir-only-when-
            # empty — real traces always survive the give-up path).
            _prune_empty_gang_dir(adopted_dir)
            _prune_empty_gang_dir(adopted_metrics_dir)
            raise err
        prev_sig = sig
        prev_dead = (cur_np, dead) if dead is not None else None
        restarts += 1
        budget_used += 1
        backoff = backoff_s * (2 ** (budget_used - 1))
        if elastic_on and cur_np < target_np:
            # Re-probe the original world size on every budgeted restart:
            # recovered capacity grows the gang back, and a probe that
            # dies on a rank reverts FREE (above) — so probing costs
            # nothing beyond the restart that was happening anyway.
            probe_from = cur_np
            prev_dead = None  # rank identities reshuffle at the new size
            log.warning(
                "supervise: probing recovered capacity — relaunching at "
                "the original world size %d (was %d)", target_np, cur_np)
            _resize(target_np, "grow_probe", probe=True)
        log.warning("supervise: gang attempt %d failed (%s); relaunching "
                    "in %.1fs (restart %d/%d)\n%s", restarts, err.kind,
                    backoff, budget_used, max_restarts, str(err)[:1000])
        time.sleep(backoff)


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Launch and supervise N torch.distributed worker "
                    "processes (HorovodRunner's mpirun role)")
    ap.add_argument("--np", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("--restarts", type=int, default=0,
                    help="restart budget for retryable gang failures")
    ap.add_argument("--watchdog", type=float, default=None,
                    help="heartbeat staleness (s) that marks the gang hung")
    ap.add_argument("--event-dir", default=None,
                    help="flight-recorder dir for per-rank event streams "
                         "and gang-timeline postmortems (supervise mode "
                         "defaults to a temp dir)")
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    ns = ap.parse_args(argv)
    if ns.restarts or ns.watchdog:
        # capture=True: the fatal/retryable verdict classifies the workers'
        # stderr — without pipes every death would look retryable and a
        # user bug would be relaunched until the budget ran out. Output is
        # replayed per rank after the run instead of streaming live.
        res = supervise(ns.script, np=ns.np, args=ns.args,
                        timeout_s=ns.timeout, max_restarts=ns.restarts,
                        watchdog_s=ns.watchdog, capture=True,
                        event_dir=ns.event_dir)
        for rank, r in enumerate(res.results):
            if r is not None and (r.stdout or r.stderr):
                print(f"--- rank {rank} ---\n{r.stdout or ''}", end="")
                if r.stderr:
                    print(r.stderr, end="", file=sys.stderr)
        if res.restarts:
            print(f"launcher: completed after {res.restarts} restart(s)",
                  file=sys.stderr)
    else:
        launch(ns.script, np=ns.np, args=ns.args, timeout_s=ns.timeout,
               event_dir=ns.event_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
