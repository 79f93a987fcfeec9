"""Process launcher: the ``mpirun`` role of HorovodRunner for the port.

The port's copy of the spawn half of ``sparkdl_tpu/runner/launcher.py``.
``launch(script, np=N)`` spawns N copies of ``python script`` on this host
with the rendezvous env set:

- ``SPARKDL_COORDINATOR``   — host:port of rank 0's ``torch.distributed``
  store
- ``SPARKDL_NUM_PROCESSES`` — N
- ``SPARKDL_PROCESS_ID``    — 0..N-1

``XlaRunner(...)`` in the worker joins the gang from these
(``xla_runner._init_gang``), so a worker script needs no launcher
awareness beyond constructing the runner as usual.

The wait is a concurrent poll loop: the first nonzero exit is detected
within ``poll_s`` (not after the whole ``timeout_s`` a sequential wait
would burn while the survivors hang on a collective), the rest of the
gang is killed, and the captured output rides in the raised
:class:`GangFailure`, classified retryable or fatal
(``failures.classify_text``). The supervisor (budgeted restarts,
heartbeats and the watchdog, the event and metrics directories, the gang
timeline) and the CLI are ROADMAP.md's Queue A 7.

This module never touches CUDA: the parent must not take a card from its
workers.
"""

from __future__ import annotations

import logging
import os
import socket
import subprocess
import sys
import threading
import time

from . import failures

__all__ = ["launch", "free_port", "GangFailure"]

log = logging.getLogger("sparkdl_tpu_torch.runner")

_KILL_GRACE_S = 2.0  # SIGTERM -> SIGKILL escalation window


class GangFailure(RuntimeError):
    """A gang failed. ``kind`` is the restart verdict ("retryable" or
    "fatal"), ``hung`` marks a timeout, ``results`` holds what each rank
    left (None for ranks still running when the gang was killed)."""

    def __init__(self, message: str, kind: str = "retryable",
                 hung: bool = False, results: list | None = None):
        super().__init__(message)
        self.kind = kind
        self.hung = hung
        self.results = results or []


def free_port() -> int:
    """An OS-assigned free TCP port for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Drain:
    """Background readers for a child's pipes: the poll loop must never
    block on I/O, and a worker must never block on a full pipe while the
    launcher polls its siblings. Only the tail is kept (``cap_bytes`` a
    stream): classification reads the tail alone."""

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
                capture: bool):
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
    A dead peer leaves survivors blocked inside a collective; they will
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


def _collect(procs, drains, capture: bool):
    """A ``CompletedProcess`` a rank; None for a rank with no exit code."""
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
              coordinator: str | None, capture: bool, poll_s: float):
    """One gang. Returns (status, results, info):

    - ("ok", results, {})           — every rank exited 0
    - ("failed", results, {ranks})  — first nonzero exit (within poll_s)
    - ("timeout", results, {running}) — wall deadline hit
    """
    procs, drains = _spawn_gang(script, np, args, env, coordinator, capture)
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
            if time.monotonic() > deadline:
                running = [r for r, c in enumerate(codes) if c is None]
                _kill_gang(procs)
                return ("timeout", _collect(procs, drains, capture),
                        {"running": running})
            time.sleep(poll_s)
    finally:
        _kill_gang(procs)


def _failure(status: str, results, info, timeout_s: float,
             capture: bool) -> GangFailure:
    """The GangFailure of a gang that did not end ok: which ranks died or
    stalled, their salvaged output, and the restart verdict."""
    if status == "failed":
        ranks = info["ranks"]
        first = ranks[0]
        tail = _rank_tail(results, first)
        rc = results[first].returncode if results[first] else None
        # killed by a signal (negative rc) with no output reads like a
        # preemption or an OOM kill: retryable; otherwise classify the text
        kind = ("retryable" if (rc is not None and rc < 0 and not tail)
                else failures.classify_text(tail))
        msg = (f"launch: rank(s) {ranks} exited nonzero "
               f"(rank {first} rc={rc}, detected in "
               f"{info.get('detect_s', 0.0):.1f}s, classified {kind})")
        if tail:
            msg += "\n" + tail
        return GangFailure(msg, kind=kind, results=results)
    # timeout: salvage what the finished ranks left, so the message says
    # WHICH rank stopped making progress
    running = info.get("running", [])
    done = [r for r, res in enumerate(results)
            if res is not None and r not in running]
    msg = (f"launch: workers did not finish within {timeout_s}s "
           f"(rendezvous hang? a dead peer blocks collectives); "
           f"rank(s) {running} still running, rank(s) {done} had exited")
    if capture:
        for r, res in enumerate(results):
            if res is None:
                continue
            tail = (res.stderr or res.stdout or "")[-800:]
            if tail:
                msg += f"\n--- rank {r} (rc={res.returncode}) ---\n{tail}"
    return GangFailure(msg, kind="retryable", hung=True, results=results)


def launch(script: str, np: int = 2, args: list[str] | None = None,
           env: dict | None = None, timeout_s: float = 600.0,
           coordinator: str | None = None,
           capture: bool = False, poll_s: float = 0.5,
           heartbeat_dir: str | None = None,
           watchdog_s: float | None = None,
           event_dir: str | None = None
           ) -> list[subprocess.CompletedProcess]:
    """Spawn ``np`` copies of ``python script [args]`` wired for
    ``torch.distributed`` and wait for all of them.

    ``env`` is added to this process's environment for every rank.
    ``coordinator`` (``host:port``) defaults to a free port on
    127.0.0.1. The first nonzero exit is detected within ``poll_s`` and
    the surviving ranks are killed at once; a gang still running after
    ``timeout_s`` is killed too. Either raises :class:`GangFailure` (a
    ``RuntimeError``) carrying the failed ranks, their salvaged output
    and the retryable/fatal verdict. Returns a ``CompletedProcess`` a
    rank.

    ``capture=True`` collects each worker's stdout and stderr (drained
    concurrently, so a chatty worker cannot deadlock the poll loop).
    ``heartbeat_dir``, ``watchdog_s`` and ``event_dir`` (the hang
    watchdog and the flight recorder's gang timeline) raise
    ``NotImplementedError``: they are ROADMAP.md's Queue A 7."""
    if np < 1:
        raise ValueError(f"np must be >= 1, got {np}")
    for name, value in (("heartbeat_dir", heartbeat_dir),
                        ("watchdog_s", watchdog_s),
                        ("event_dir", event_dir)):
        if value is not None:
            raise NotImplementedError(
                f"launch({name}=...) is not ported to sparkdl_tpu_torch "
                f"yet (ROADMAP.md, Queue A 7)")
    status, results, info = _run_gang(script, np, args, env, timeout_s,
                                      coordinator, capture, poll_s)
    if status == "ok":
        return results
    raise _failure(status, results, info, timeout_s, capture)
