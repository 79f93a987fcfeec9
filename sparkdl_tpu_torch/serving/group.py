"""One front for a tensor-parallel engine group.

A tensor-parallel engine (``GenerationEngine.from_model(model,
mesh=tp_mesh(n))``) is n processes, one a device, each holding a shard of
the model and of the KV cache. Every decode step issues collectives, so
the ranks' schedulers must make the same decisions in the same order.
Driven inline, every rank makes the same ``submit()`` / ``step()`` calls
and decides alike (the SPMD contract). Started, the scheduler's inputs
come from client threads, a wall clock and a watchdog, each of which
would differ from rank to rank. So the group's rank 0 is its **front**:

- ``submit()`` and ``resume()`` on rank 0, from any thread, put the
  request in an inbox and issue no collective; ``Request.cancel()`` on
  one of its requests is routed into the front. On any other rank they
  raise ``ValueError``.
- At each iteration boundary rank 0's loop sends one message over the
  group's control channel: a header ``[kind, bytes, clock]`` (f64),
  then, when there is one, a JSON payload with the admissions (id,
  prompt, ``max_new_tokens``, bucket, submit time and deadline), the
  ``resume()`` snapshots, the ids of cancelled requests and the stop or
  drain mode. Every rank applies it alike and runs one iteration
  (``GenerationEngine._step_inner``) on rank 0's clock reading. While
  idle, rank 0 sends one idle message a loop tick (0.05 s), so a
  follower never waits long in a collective.
- The header travels in one all-reduce that also carries every rank's
  verdict on its last iteration, so the ranks agree on an error before
  they apply the next message: a serving-fatal error or the stall
  watchdog's verdict (each rank reads its own wall clock) makes every
  rank fail over (``_handle_fatal``); any other makes every rank fail
  closed. One more agreement after a failover makes a rank whose peer
  failed closed fail closed too. The common iteration costs one
  collective, and one more when its message has a payload.
- ``stop()``, ``drain()`` and ``resume()`` on rank 0 reach every rank
  through the message: a drain returns the same snapshots on every rank.
  On a follower ``stop()`` and ``drain()`` wait for the front's stop and
  return what it decided.

The followers name each request by rank 0's id and expose the handles
they mirror through ``start(on_request=...)``, so a caller on any rank
can stream what rank 0 was asked.

The control channel is a gloo group over the tensor-parallel group's
ranks (:func:`control_group`), made next to the mesh
(``serving.backend._tp_setup``), so host messages never pass through the
card's stream, nor into a captured decode step.

A fault on one rank inside a collective (a rank that raised while its
peers wait in the model's all-reduce) is not recoverable here: the
group's collectives hang until the process group's timeout, and the
supervisor (``runner.launcher.supervise``) restarts the gang (ROADMAP.md,
Queue C 2).

The JAX package has no counterpart: one process drives its whole mesh,
so its background loop serves a tensor-parallel engine as it serves one
device.
"""

from __future__ import annotations

import functools
import json
import logging
import threading
import time

import torch
import torch.distributed as dist

from ..runner import events
from ..runner import sentinel as sentinel_lib
from .engine import (_REQUEST_IDS, DONE, FAILED, QUEUED, EngineStopped,
                     QueueFullError, Request, ServingError,
                     ServingStallError)

__all__ = ["control_group", "GroupFront"]

log = logging.getLogger("sparkdl_tpu_torch.serving")

IDLE, STEP, STOP = 0, 1, 2
_IDLE_TICK_S = 0.05

def control_group(mesh):
    """The gloo group over ``mesh``'s ranks: the control channel of a
    tensor-parallel engine on that mesh. Made by the group's ranks alone
    (``use_local_synchronization``), so each rank of the group calls it
    in the same order as its other collectives."""
    ranks = sorted(int(r) for r in mesh.mesh.flatten().tolist())
    return dist.new_group(ranks, backend="gloo",
                          use_local_synchronization=True)


class _PeerFault(ServingError):
    """Another rank of the group hit an error in this iteration; this rank
    fails over (``serving_fatal``) or fails closed alongside it."""

    def __init__(self, msg: str, serving_fatal: bool):
        super().__init__(msg)
        self.serving_fatal = serving_fatal


class _Channel:
    """The control channel over one gloo group. At each iteration
    boundary one all-reduce (a sum) of a float64 header carries rank 0's
    ``[kind, bytes, clock]`` (the other ranks add zeros) and every rank's
    ``[failed over, failed]`` verdict of its last iteration; when the
    header counts payload bytes, rank 0 broadcasts them."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.src = dist.get_global_rank(group, 0)

    def message(self, head: list, payload: bytes = b"") -> tuple:
        """One boundary: ``(kind, clock, ranks failed over, ranks failed,
        payload)``."""
        t = torch.tensor(head, dtype=torch.float64)
        dist.all_reduce(t, group=self.group)
        kind, n, clock, n_over, n_failed = t.tolist()
        if n:
            buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8) \
                if self.rank == 0 else torch.empty(int(n), dtype=torch.uint8)
            dist.broadcast(buf, src=self.src, group=self.group)
            payload = buf.numpy().tobytes()
        return int(kind), clock, int(n_over), int(n_failed), payload

    def agree(self, flag: int) -> int:
        """Whether any rank raised ``flag`` (a max over the group)."""
        t = torch.tensor([flag], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return int(t[0])


class GroupFront:
    """The front of one tensor-parallel engine (module doc): rank 0's
    inbox and loop, a follower's loop, and the stop both share. The
    engine calls it from ``submit``, ``resume``, ``start`` and
    ``_shutdown`` once its loop runs; driven inline, the engine never
    does."""

    def __init__(self, engine, group):
        self.engine = engine
        self.channel = _Channel(group)
        self.leader = self.channel.rank == 0
        self.inbox: list = []      # rank 0: ("s" | "r", Request), in order
        self.cancels: dict = {}    # rank 0: id -> Request asked to cancel
        self.stop_request: str | None = None  # drain | snapshot | now
        self.snapshots: list = []  # what the last stop drained
        self.mirrors: dict = {}    # a follower: id -> its live Request
        self.on_request = None
        self.ran = False
        self.stats = {"messages": 0, "idle_messages": 0, "control_s": 0.0}

    # -- who serves -------------------------------------------------------
    def fronting(self) -> bool:
        """True while rank 0's loop runs (submit and resume go to the
        inbox); raises ``ValueError`` on a follower whose loop runs."""
        if self.engine._thread is None:
            return False
        if not self.leader:
            raise ValueError(
                f"rank {self.channel.rank} of a tensor-parallel group takes "
                f"no request of its own: rank 0 is the group's front")
        return True

    def start(self, on_request=None):
        eng = self.engine
        with eng._lock:
            if eng._thread is not None:
                return eng
            if eng._fatal is not None:
                # every rank knows it (the agreement): none loops again
                raise EngineStopped("engine died") from eng._fatal
            eng._stop_mode = None
            self.stop_request = None
            self.snapshots = []
            self.on_request = on_request
            self.ran = True
            if self.leader:  # requests submitted inline before start
                for r in [*eng._queue, *eng._slots]:
                    if r is not None:
                        self._route(r)
            eng._thread = threading.Thread(
                target=self._serve,
                name="sparkdl-serve-" + ("front" if self.leader
                                         else "follower"), daemon=True)
            eng._thread.start()
        return eng

    # -- rank 0: the inbox --------------------------------------------------
    def _route(self, req: Request):
        """Route ``req.cancel()`` into the front while ``req`` is live here
        (an instance attribute over the method)."""
        req.cancel = functools.partial(self._ask_cancel, req)

    def _unroute(self, req: Request):
        """``req`` leaves the group: its cancel is its own again, and one
        asked after the last message is honoured by whoever serves it
        next."""
        req.__dict__.pop("cancel", None)
        if self.cancels.pop(req.id, None) is not None:
            req._cancel = True

    def _ask_cancel(self, req: Request):
        with self.engine._work:
            if "cancel" in req.__dict__:
                self.cancels[req.id] = req
                return
        req._cancel = True

    def submit(self, prompt, max_new_tokens: int, bucket: int, stream_cb,
               block: bool, timeout: float | None,
               deadline_s: float | None) -> Request:
        """``GenerationEngine.submit`` on rank 0 once validated: queue the
        request in the inbox, with the engine's backpressure over the
        queue and the inbox together. The deadline runs from the submit
        time, rank 0's clock, which the admission carries."""
        eng = self.engine
        deadline = None if timeout is None else time.time() + timeout
        with eng._work:
            while True:
                if eng._stop_mode is not None or eng._fatal is not None \
                        or eng._thread is None:
                    raise EngineStopped("engine is stopped")
                if len(eng._queue) + len(self.inbox) < eng.queue_capacity:
                    break
                if not block:
                    eng._reject_locked("queue_full", QueueFullError)
                remain = None if deadline is None else deadline - time.time()
                if remain is not None and remain <= 0:
                    eng._reject_locked("queue_full_timeout", QueueFullError)
                eng._work.wait(remain if remain is not None else 0.5)
            req = Request(next(_REQUEST_IDS), prompt, max_new_tokens,
                          bucket, stream_cb)
            limit = deadline_s if deadline_s is not None \
                else eng.default_deadline_s
            if limit and limit > 0:
                req.t_deadline = req.t_submit + float(limit)
            self._route(req)
            self.inbox.append(("s", req))
            eng._work.notify_all()
        return req

    def resume(self, req: Request) -> Request:
        """``GenerationEngine.resume`` on rank 0 once re-bucketed."""
        eng = self.engine
        with eng._work:
            if eng._stop_mode is not None or eng._fatal is not None \
                    or eng._thread is None:
                raise EngineStopped("engine is stopped")
            self._route(req)
            self.inbox.append(("r", req))
            eng._work.notify_all()
        return req

    # -- the message ---------------------------------------------------------
    @staticmethod
    def _entry(kind: str, r: Request) -> list:
        if kind == "s":
            return ["s", r.id, r.prompt, r.max_new_tokens, r.bucket,
                    r.t_submit, r.t_deadline]
        return ["r", r.id, r.prompt, r.tokens, r.delivered, r.max_new_tokens,
                r.bucket, r.failovers, r._len_at_failover, r.t_submit,
                r.t_deadline, r._cancel]

    def _mirror(self, e: list) -> Request:
        """A follower's handle for the admission or resume ``e``: the one
        it already holds under rank 0's id, else a new one."""
        req = self.mirrors.get(e[1])
        if req is None:
            req = Request(e[1], e[2], e[5] if e[0] == "r" else e[3],
                          e[6] if e[0] == "r" else e[4])
            req.cancel = self._refuse_cancel
            self.mirrors[req.id] = req
        if e[0] == "s":
            req.t_submit, req.t_deadline = e[5], e[6]
        else:
            (req.tokens[:], req.delivered, req.max_new_tokens, req.bucket,
             req.failovers, req._len_at_failover, req.t_submit,
             req.t_deadline, req._cancel) = e[3:]
        req.t_enqueue = req.t_submit
        return req

    def _refuse_cancel(self):
        raise ValueError("cancel a tensor-parallel group's request on rank "
                         "0, the group's front")

    def _apply(self, kind: int, entries: list, cancels: list,
               mode: str | None) -> bool:
        """Apply one message on this rank: the admissions and resumes in
        order, then the cancels, then the mode. Returns True when the
        message stops the loop."""
        eng = self.engine
        with eng._work:
            for tag, req in entries:
                if tag == "r":
                    req.state = QUEUED
                    req.slot = None
                    req.chunk_plan = None
                    req._block_stalled = False
                    req.t_enqueue = time.time()
                eng._queue.append(req)
                eng.stats["submitted"] += 1
            for req in cancels:
                req._cancel = True
            depth = len(eng._queue)
            if depth > eng.stats["peak_queue_depth"]:
                eng.stats["peak_queue_depth"] = depth
            if mode is not None:
                eng._stop_mode = "drain" if mode == "drain" else "now"
            eng._work.notify_all()
        if entries:
            eng._metric("gauge", "serving_queue_depth", depth)
            sentinel_lib.observe("queue_depth", float(depth))
            if self.on_request is not None:
                for _, req in entries:
                    self.on_request(req)
        if kind != STOP:
            return False
        snaps = []
        if mode == "now":
            eng._fail_pending(EngineStopped("engine stopped"))
        elif mode == "snapshot":
            snaps = eng._detach_all()
            events.event("serve_engine_drain", requests=len(snaps))
        if self.leader:
            with eng._work:
                for r in snaps:
                    self._unroute(r)
        self.snapshots = snaps
        return True

    # -- the loop --------------------------------------------------------------
    def _boundary(self):
        """Rank 0 at a boundary: take the inbox, the cancels and the stop
        into one message. Returns ``(kind, clock, entries, cancels, mode,
        payload)``."""
        eng = self.engine
        with eng._work:
            entries, self.inbox = self.inbox, []
            cancels = list(self.cancels.values())
            self.cancels.clear()
            mode = self.stop_request
            busy = bool(entries or eng._queue) or any(
                r is not None for r in eng._slots)
            if mode in ("now", "snapshot") or (mode == "drain" and not busy):
                kind = STOP
            else:
                kind = STEP if busy else IDLE
            clock = time.time()
        msg = {}
        if entries:
            msg["a"] = [self._entry(t, r) for t, r in entries]
        if cancels:
            msg["c"] = [r.id for r in cancels]
        if mode is not None:
            msg["m"] = mode
        payload = json.dumps(msg, separators=(",", ":")).encode() \
            if msg else b""
        return kind, clock, entries, cancels, mode, payload

    def _serve(self):
        """Every rank's loop (the engine's ``_loop`` with one message at
        each iteration boundary): rank 0 builds the message, every rank
        exchanges it with the verdicts of the last iteration, settles a
        fault, applies the message and runs the iteration."""
        eng = self.engine
        sentinel_lib.maybe_arm_from_env()
        err, verdict = None, [0, 0]
        try:
            while True:
                if self.leader:
                    kind, clock, entries, cancels, mode, payload = \
                        self._boundary()
                    head = [kind, len(payload), clock]
                else:
                    payload, head = b"", [0, 0, 0]
                t0 = time.perf_counter()
                kind, clock, n_over, n_failed, payload = \
                    self.channel.message(head + verdict, payload)
                self._count(kind, time.perf_counter() - t0)
                if not self.leader:
                    msg = json.loads(payload) if payload else {}
                    entries = [(e[0], self._mirror(e))
                               for e in msg.get("a", ())]
                    cancels = [self.mirrors[i] for i in msg.get("c", ())
                               if i in self.mirrors]
                    mode = msg.get("m")
                if (n_over or n_failed) and not self._settle(err, n_failed):
                    with eng._work:  # this message's admissions fail too
                        eng._queue.extend(r for _, r in entries)
                    eng._fail_pending(EngineStopped(
                        f"engine died: {eng._fatal}"))
                    break
                err, verdict = None, [0, 0]
                if self._apply(kind, entries, cancels, mode):
                    break
                eng.t_heartbeat = time.time()
                if kind == IDLE:
                    if self.leader:
                        with eng._work:
                            if not self.inbox and self.stop_request == mode:
                                eng._work.wait(_IDLE_TICK_S)
                    continue
                eng._group_now = clock
                try:
                    eng._step_inner()
                except Exception as e:  # noqa: BLE001 — settled next message
                    err = e
                    verdict = [1, 0] if getattr(e, "serving_fatal", False) \
                        or isinstance(e, ServingStallError) else [0, 1]
                if not self.leader:
                    self.mirrors = {i: r for i, r in self.mirrors.items()
                                    if r.state not in (DONE, FAILED)}
        except Exception as e:  # noqa: BLE001 — a channel error: record, die
            eng._handle_fatal(e)
        finally:
            self._end()

    def _count(self, kind: int, dt: float):
        self.stats["messages"] += 1
        self.stats["idle_messages"] += kind == IDLE
        self.stats["control_s"] += dt

    def _end(self):
        """The loop is over. Rank 0's inbox is empty after a stop (the
        stop message took it); after a failure what it still holds fails
        with the rest."""
        eng = self.engine
        with eng._work:
            left, self.inbox = self.inbox, []
            eng._queue.extend(r for _, r in left)
            if eng._thread is threading.current_thread():
                eng._thread = None
        if left:
            eng._fail_pending(EngineStopped(f"engine died: {eng._fatal}"))

    def _settle(self, err, n_failed: int) -> bool:
        """A rank of the group raised in the last iteration: every rank
        fails over (a serving-fatal error or a stall on every rank that
        raised) or fails closed (any other error), then the ranks agree
        that none failed closed. Returns False once the engine has."""
        eng = self.engine
        close = n_failed > 0
        mine = err is not None and (
            getattr(err, "serving_fatal", False)
            or isinstance(err, ServingStallError)) != close
        exc = err if mine else _PeerFault(
            f"a rank of the tensor-parallel group "
            f"{'failed' if close else 'failed over'} in the last "
            f"iteration", serving_fatal=not close)
        eng._handle_fatal(exc)
        if self.channel.agree(int(eng._fatal is not None)) and \
                eng._fatal is None:
            peer = _PeerFault("a rank of the tensor-parallel group failed "
                              "closed", serving_fatal=False)
            with eng._lock:
                eng._fatal = peer
            eng._fail_pending(EngineStopped(f"engine died: {peer}"))
        return eng._fatal is None

    # -- stopping ------------------------------------------------------------
    def shutdown(self, mode: str, timeout: float | None):
        """``GenerationEngine._shutdown`` once the front runs: on rank 0
        the stop goes to every rank in the next message, and the loop
        takes the snapshots; a follower waits for that stop (``timeout``
        at most) and returns the snapshots of the group's last stop. None
        when the engine's own path stops it: rank 0 with no loop running,
        a follower whose loop never ran."""
        eng = self.engine
        t = eng._thread
        if t is None and not (self.ran and not self.leader):
            return None
        if not self.leader:
            if t is not None:
                t.join(timeout)
                if t.is_alive():
                    return []
            self._close_pool()
            return list(self.snapshots)
        with eng._work:
            eng._stop_mode = "drain" if mode == "drain" else "now"
            self.stop_request = mode
            eng._work.notify_all()
        if mode == "drain":
            budget = timeout
            if eng.stall_s and eng.stall_s > 0:
                budget = eng.stall_s if budget is None \
                    else min(budget, eng.stall_s)
            t.join(budget)
            if t.is_alive():
                log.warning("drain still running after %ss; degrading "
                            "to snapshot-and-stop", budget)
                with eng._work:
                    self.stop_request = mode = "snapshot"
                    eng._work.notify_all()
        t.join(timeout if mode == "now" or timeout is not None
               else (eng.stall_s or 1.0))
        snaps = list(self.snapshots)
        if t.is_alive():
            # the group is wedged inside an iteration: stop this rank as
            # the engine's own path does, and leave the loop's handle set
            log.warning("serve front loop still running after stop("
                        "timeout=%s); not restartable until it exits",
                        timeout)
            if mode == "snapshot":
                snaps = eng._detach_all()
                with eng._work:
                    for r in snaps:
                        self._unroute(r)
        if mode == "now":
            eng._fail_pending(EngineStopped("engine stopped"))
        self._close_pool()
        return snaps if mode == "snapshot" else []

    def _close_pool(self):
        pool, self.engine._watch_pool = self.engine._watch_pool, None
        if pool is not None:
            pool.shutdown(wait=False)
