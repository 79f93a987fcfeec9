"""A fleet replica in another process: a tensor-parallel group's front
served over a host channel, and the proxy :class:`EngineFleet` takes in
its place.

In the JAX package one process drives a tensor-parallel engine's whole
mesh, so one fleet process holds several tp engines on disjoint device
groups. In torch's form a tp group is ``tp`` processes, and rank 0 of each
is its front (``serving.group``). A fleet over several groups therefore
talks to each group's rank 0 over a channel of the host:

- :class:`FrontServer` runs on rank 0 of a started group. It takes
  ``submit``, ``resume`` (a :meth:`Request.snapshot` dict), ``cancel``,
  ``drain`` and ``stop`` from one fleet, and pushes back each request's
  tokens and terminal state (``finish_reason``, the error's type and
  message) and, every 0.05 s, a health message: queue length and busy
  slots, the engine's fatal error and failover record, whether it ran
  an iteration since the last one, and its residency digest when that
  changed. The followers are untouched: ``drain`` is the front's
  ``drain()``, which gives every rank the same snapshots.
- :class:`RemoteEngine` connects to it and stands in for an engine in
  ``EngineFleet``: ``submit`` is a synchronous round trip returning a
  mirrored :class:`Request` (or raising ``QueueFullError``,
  ``RequestRejected``, ``EngineStopped`` here), tokens land on the
  mirror before its ``stream_cb`` runs, ``Request.cancel()`` on a mirror
  reaches the remote request, ``drain()`` returns the mirrors it handed
  out, updated from the remote snapshots.

The channel is ``multiprocessing.connection`` with an ``authkey``
carrying JSON, never ``torch.distributed``: the fleet process stays out
of the groups' process groups and off the card's stream. The front's
``stream_cb`` only wakes a sender thread, which reads each live request's
tokens in order and writes them in batches, so the engine's loop never
waits on the socket.

A replica's requests are named by its front's ids (each process counts
its own from 0, so two groups reuse ids); a resumed snapshot gets a new
id of the group that takes it, so ids stay unique within a group. A lost
channel (end of file, a reset, or no message for ``timeout_s``) makes the
proxy fatal: every outstanding mirror fails with ``EngineStopped``, the
fleet marks the replica DEAD and re-admits its requests from its shadow
state. Nothing in the fleet's process serves a remote request itself.
Inline ``EngineFleet.step()`` does not drive a remote replica (its own
group's loop does): ``RemoteEngine.step()`` raises (ROADMAP.md, Queue C
2). Traces of a remote request stay in its group's process.
"""

from __future__ import annotations

import collections
import functools
import itertools
import json
import logging
import os
import queue
import socket
import threading
import time
from multiprocessing.connection import Client, Listener

from .engine import (_REQUEST_IDS, FAILED, QUEUED, DeadlineExceeded,
                     EngineStopped, QueueFullError, Request, RequestCancelled,
                     RequestQuarantined, RequestRejected, ServingError,
                     ServingStallError, SnapshotIncompatibleError)

__all__ = ["FrontServer", "RemoteEngine"]

log = logging.getLogger("sparkdl_tpu_torch.serving")

_TICK_S = 0.05    # the health message's period (the front's idle tick)
_POLL_S = 0.002   # the sender's wait while requests are live: how soon
                  # a request's end is seen after its last token
_ERRORS = {c.__name__: c for c in (
    ServingError, RequestRejected, QueueFullError, RequestQuarantined,
    ServingStallError, EngineStopped, RequestCancelled, DeadlineExceeded,
    SnapshotIncompatibleError, ValueError)}


def _error_of(exc) -> list | None:
    return None if exc is None else [type(exc).__name__, str(exc)[:2000]]


def _exception(wire: list) -> BaseException:
    """The exception a ``[type name, message]`` pair names: the engine's
    own classes by name, anything else a ``ServingError``."""
    name, msg = wire
    cls = _ERRORS.get(name)
    return cls(msg) if cls is not None else ServingError(f"{name}: {msg}")


def _within(fn, timeout: float, what: str):
    """``fn()`` on a daemon thread, waited for at most ``timeout`` s (a
    connect or an accept and its authentication, which have no timeout
    of their own)."""
    box: list = []

    def run():
        try:
            box.append((True, fn()))
        except BaseException as e:  # noqa: BLE001 — handed to the caller
            box.append((False, e))
    t = threading.Thread(target=run, daemon=True,
                         name="sparkdl-remote-" + what)
    t.start()
    t.join(timeout)
    if not box:
        raise TimeoutError(f"{what} did not finish in {timeout}s")
    ok, value = box[0]
    if not ok:
        raise value
    return value


def _no_delay(conn):
    """Send each frame at once (TCP_NODELAY): small frames both ways
    would otherwise wait on Nagle's algorithm for the peer's delayed
    acknowledgement, ~40 ms a round trip. A socket of another family
    is left as it is."""
    s = socket.socket(fileno=os.dup(conn.fileno()))
    try:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass
    finally:
        s.close()
    return conn


def _shut(conn) -> None:
    """Shut the connection's socket down both ways: a thread blocked
    reading it wakes, and the peer reads end of file."""
    try:
        s = socket.socket(fileno=os.dup(conn.fileno()))
    except OSError:
        return
    try:
        s.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    finally:
        s.close()


class FrontServer:
    """Rank 0's side of the channel (module doc). ``address`` is where it
    listens (``("127.0.0.1", 0)`` picks a free port: read
    :attr:`address` after construction); ``authkey`` the bytes a fleet
    must present. :meth:`serve` starts the engine's loop (every rank of
    a tp group calls ``start()``; this is rank 0's), accepts one fleet
    within ``accept_timeout_s`` and serves it."""

    def __init__(self, engine, address=("127.0.0.1", 0),
                 authkey: bytes | None = None, *,
                 accept_timeout_s: float = 120.0):
        self.engine = engine
        self.accept_timeout_s = accept_timeout_s
        self._listener = Listener(address, authkey=authkey)
        self.address = self._listener.address
        self._conn = None
        self._lock = threading.Lock()    # _out, _live
        self._wake = threading.Event()
        self._out: list = []             # events for the sender, in order
        self._live: dict = {}            # key -> [Request, tokens sent]
        self._keys = itertools.count()
        self._ending = False             # the last reply is queued
        self._beat = None                # the engine heartbeat last told
        self._digest = None              # the digest last told

    # -- the loop -----------------------------------------------------------
    def serve(self) -> list:
        """Serve one fleet until it drains or stops the engine, or the
        channel is lost (then the engine is stopped, failing what it
        holds). Returns the drained :class:`Request` snapshots ([] after
        a stop or a lost channel)."""
        self.engine.start()
        try:
            self._conn = _no_delay(_within(self._listener.accept,
                                           self.accept_timeout_s, "accept"))
        except BaseException:
            self.engine.stop(drain=False, timeout=5.0)  # frees the followers
            raise
        finally:
            self._listener.close()
        sender = threading.Thread(target=self._send_loop, daemon=True,
                                  name="sparkdl-front-sender")
        sender.start()
        snaps = None
        try:
            while snaps is None:
                if not self._conn.poll(_TICK_S):
                    continue
                snaps = self._handle(json.loads(self._conn.recv_bytes()))
        except (EOFError, OSError, ValueError) as e:
            log.warning("fleet channel lost (%s: %s); stopping the engine",
                        type(e).__name__, e)
            self.engine.stop(drain=False, timeout=5.0)
            snaps = []
        finally:
            with self._lock:
                self._ending = True
            self._wake.set()
            sender.join(30.0)
            self._conn.close()
        return snaps

    def close(self) -> None:
        """Drop the channel without a drain (the fleet sees the replica
        lost); :meth:`serve` then stops the engine and returns."""
        if self._conn is not None:
            _shut(self._conn)

    # -- requests from the fleet --------------------------------------------
    def _handle(self, msg: dict):
        """One message. Returns the snapshots once it drained or stopped
        the engine, else None."""
        op, eng = msg["op"], self.engine
        if op == "cancel":
            with self._lock:
                rec = self._live.get(msg["key"])
            if rec is not None:
                rec[0].cancel()
            return None
        seq = msg["seq"]
        if op in ("drain", "stop"):
            snaps = eng.drain(msg.get("timeout")) if op == "drain" else \
                eng.stop(drain=msg["drain"], timeout=msg.get("timeout"))
            with self._lock:
                self._collect_locked()
                keys = {id(r[0]): k for k, r in self._live.items()}
                for r in snaps:
                    self._live.pop(keys.get(id(r)), None)
                self._out.append(["reply", seq, {"snaps": [
                    [keys.get(id(r)), r.snapshot()] for r in snaps]}])
                self._ending = True
            self._wake.set()
            return snaps
        try:
            if op == "submit":
                req = eng.submit(msg["prompt"], msg["max_new_tokens"],
                                 stream_cb=self._poke, block=False,
                                 deadline_s=msg.get("deadline_s"))
                sent = 0
            else:  # resume: a new id of this group, unique within it
                snap = dict(msg["snap"], id=next(_REQUEST_IDS))
                req = eng.resume(snap, stream_cb=self._poke)
                sent = int(snap["delivered"])
        except (ServingError, ValueError) as e:
            self._push(["reply", seq, {"error": _error_of(e)}])
            return None
        with self._lock:
            key = next(self._keys)
            self._live[key] = [req, sent]
            self._out.append(["reply", seq, {"key": key, "id": req.id}])
        self._wake.set()
        return None

    def _poke(self, req, tok):
        """Every request's ``stream_cb`` on the engine's loop: wake the
        sender, which reads the tokens off the request."""
        self._wake.set()

    def _push(self, event: list):
        with self._lock:
            self._out.append(event)
        self._wake.set()

    # -- to the fleet --------------------------------------------------------
    def _collect_locked(self):
        """Each live request's new tokens and, once it is done, its end,
        into the outbox (lock held)."""
        for key, rec in list(self._live.items()):
            req, sent = rec
            done = req.done  # read first: an end follows its last token
            n = len(req.tokens)
            if n > sent:
                self._out.append(["tok", key, req.tokens[sent:n]])
                rec[1] = n
            if done:
                self._out.append(["end", key, req.state, req.finish_reason,
                                  _error_of(req.error)])
                del self._live[key]

    def _health(self) -> dict:
        eng = self.engine
        front = getattr(eng, "_front", None)
        inbox = len(front.inbox) if front is not None else 0
        beat, self._beat = eng.t_heartbeat != self._beat, eng.t_heartbeat
        h = {"queue": len(eng._queue) + inbox,
             "busy": sum(r is not None for r in eng._slots),
             "fatal": _error_of(eng._fatal),
             "failover": dict(eng._failover_info), "beat": beat}
        try:
            dig = eng.residency_digest()
        except Exception:  # noqa: BLE001 — a routing hint, never fatal
            dig = None
        if dig is not None:
            dig = {"granule": int(dig["granule"]),
                   "heads": sorted([int(k), int(v)]
                                   for k, v in dig["heads"].items())}
            if dig != self._digest:
                h["digest"] = self._digest = dig
        return h

    def _send_loop(self):
        next_health = 0.0
        try:
            while True:
                with self._lock:
                    live, ending = bool(self._live), self._ending
                if not ending:
                    self._wake.wait(_POLL_S if live else _TICK_S)
                    self._wake.clear()
                now = time.time()
                health = self._health() if now >= next_health or ending \
                    else None
                with self._lock:
                    self._collect_locked()
                    if health is not None:
                        self._out.append(["health", health])
                        next_health = now + _TICK_S
                    batch, self._out = self._out, []
                    ending = self._ending
                if batch:
                    self._conn.send_bytes(json.dumps(
                        {"t": now, "ev": batch}, default=str).encode())
                if ending:
                    return
        except (OSError, ValueError):
            return  # the reader sees the channel lost too


class _Waiter:
    __slots__ = ("op", "event", "value", "context")

    def __init__(self, op: str, context):
        self.op, self.context = op, context
        self.event = threading.Event()
        self.value = None


class RemoteEngine:
    """An engine in another process, as :class:`EngineFleet` sees it
    (module doc). Connects to a :class:`FrontServer` at ``address``
    within ``timeout_s``; a read that waits longer than ``timeout_s``
    for any message (the front sends one every 0.05 s) loses the
    channel.

    Besides the engine's calls it carries the attributes the router
    reads of an engine: ``_queue`` and ``_slots`` (sized as the last
    health message says), ``_fatal``, ``_failover_info``, ``_thread`` and
    ``t_heartbeat`` — the time THIS process received the last health
    message that followed an iteration of the group, so no clock crosses
    processes."""

    def __init__(self, address, authkey: bytes | None = None, *,
                 timeout_s: float = 10.0):
        self.address = tuple(address) if isinstance(address, list) \
            else address
        self.timeout_s = timeout_s
        self._conn = _no_delay(_within(
            lambda: Client(self.address, authkey=authkey), timeout_s,
            "connect"))
        self._lock = threading.Lock()       # _mirrors, _waiters, _lost
        self._send_lock = threading.Lock()
        self._mirrors: dict[int, Request] = {}
        self._waiters: dict[int, _Waiter] = {}
        self._seq = itertools.count()
        self._events: queue.SimpleQueue = queue.SimpleQueue()
        self._lost: BaseException | None = None
        self._stopped = False
        self._closed = threading.Event()    # every mirror settled
        self._fatal: BaseException | None = None
        self._failover_info: dict = {}
        self._load = (0, 0)
        self._digest: dict | None = None
        self.t_heartbeat = time.time()
        self.t_lost: float | None = None
        # the channel's own times: each submit's round trip, and each
        # token batch's lag from its send (both ends read one host's
        # clock when they share a host)
        self.stats = {"submit_rtt_s": collections.deque(maxlen=4096),
                      "batch_lag_s": collections.deque(maxlen=4096)}
        self._thread = threading.Thread(target=self._read_loop, daemon=True,
                                        name="sparkdl-remote-reader")
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="sparkdl-remote-dispatch")
        self._thread.start()
        self._dispatcher.start()

    # -- what the router reads ---------------------------------------------
    @property
    def _queue(self):
        return range(self._load[0])

    @property
    def _slots(self):
        return range(self._load[1])

    def residency_digest(self) -> dict | None:
        return self._digest

    # -- the engine's calls ---------------------------------------------------
    def start(self, on_request=None) -> "RemoteEngine":
        """The group runs its own loop: nothing to start here."""
        if on_request is not None:
            raise ValueError("on_request= serves a tensor-parallel group's "
                             "ranks, not a fleet's proxy")
        return self

    def step(self) -> bool:
        raise NotImplementedError(
            f"a remote replica ({self.address}) is driven by its own "
            f"group's loop, not inline: drive the fleet with "
            f"fleet.start() (ROADMAP.md, Queue C 2)")

    def submit(self, prompt_ids, max_new_tokens: int = 16, *,
               stream_cb=None, block: bool = True,
               timeout: float | None = None,
               deadline_s: float | None = None) -> Request:
        """One round trip: the mirrored :class:`Request`, or the remote
        engine's ``RequestRejected`` / ``QueueFullError`` /
        ``EngineStopped`` raised here. ``block=True`` retries a full
        queue until ``timeout``."""
        prompt = [int(t) for t in prompt_ids]
        limit = None if timeout is None else time.time() + timeout
        while True:
            t0 = time.perf_counter()
            try:
                m = self._call("submit", (prompt, int(max_new_tokens),
                                          stream_cb),
                               prompt=prompt,
                               max_new_tokens=int(max_new_tokens),
                               deadline_s=deadline_s)
            except QueueFullError:
                if not block or (limit is not None and time.time() >= limit):
                    raise
                time.sleep(_TICK_S)
                continue
            self.stats["submit_rtt_s"].append(time.perf_counter() - t0)
            return m

    def resume(self, req, *, stream_cb=None) -> Request:
        """Re-admit a drained handle or a :meth:`Request.snapshot` dict
        on the remote engine. Returns a NEW mirror (the snapshot crosses
        a process; the handle passed stays as it was)."""
        if isinstance(req, Request):
            stream_cb = stream_cb if stream_cb is not None else req.stream_cb
            snap = req.snapshot()
        else:
            snap = dict(req)
        return self._call("resume", (snap, stream_cb), snap=snap)

    def drain(self, timeout: float | None = None) -> list[Request]:
        """The remote front's ``drain()``: the mirrors still live there,
        updated from its snapshots (state QUEUED), in its order."""
        return self._stop_call("drain", timeout)

    def stop(self, drain: bool = True, timeout: float | None = None
             ) -> list[Request]:
        """The remote engine's ``stop()``; a lost channel only settles
        the mirrors (every one fails with ``EngineStopped``)."""
        return self._stop_call("stop", timeout, drain=drain)

    # -- the channel ----------------------------------------------------------
    def _send(self, msg: dict):
        try:
            with self._send_lock:
                self._conn.send_bytes(json.dumps(msg).encode())
        except (OSError, ValueError) as e:
            self._lose(e)
            raise EngineStopped(f"replica channel {self.address} lost: "
                                f"{e}") from e

    def _call(self, op: str, context, wait_s: float | None = -1.0, **kw):
        """Send ``op`` and wait for its reply (``wait_s`` -1: the proxy's
        ``timeout_s``; None: until the reply or a lost channel). A wait
        past its limit loses the channel."""
        w = _Waiter(op, context)
        with self._lock:
            if self._lost is not None or self._stopped:
                raise EngineStopped(f"replica {self.address} is stopped")
            seq = next(self._seq)
            self._waiters[seq] = w
        self._send({"op": op, "seq": seq, **kw})
        if wait_s == -1.0:
            wait_s = self.timeout_s
        if not w.event.wait(wait_s):
            self._lose(TimeoutError(f"no reply to {op} in {wait_s}s"))
            raise EngineStopped(f"replica {self.address}: no reply to {op}")
        if isinstance(w.value, BaseException):
            raise w.value
        return w.value

    def _stop_call(self, op: str, timeout: float | None, **kw) -> list:
        if self._lost is None and not self._stopped:
            try:
                return self._call(
                    op, None, None if timeout is None
                    else timeout + self.timeout_s, timeout=timeout, **kw)
            except EngineStopped:
                pass
        self._closed.wait(self.timeout_s)
        return []

    def _read_loop(self):
        try:
            while True:
                if not self._conn.poll(self.timeout_s):
                    raise TimeoutError(f"no message from {self.address} in "
                                       f"{self.timeout_s}s")
                frame = json.loads(self._conn.recv_bytes())
                if self._on_frame(frame, time.time()):
                    return
        except Exception as e:  # noqa: BLE001 — any read fault loses it
            self._lose(e)
        finally:
            self._conn.close()

    def _on_frame(self, frame: dict, now: float) -> bool:
        """Apply one frame: replies wake their callers (a submit's or a
        resume's mirror is made here, before any of its tokens reach the
        dispatcher), health updates the router's reads, tokens and ends
        go to the dispatcher in order. True after the last reply."""
        last = False
        for ev in frame["ev"]:
            kind = ev[0]
            if kind == "health":
                self._on_health(ev[1], now)
            elif kind == "reply":
                last = self._on_reply(ev[1], ev[2]) or last
            else:
                if kind == "tok":
                    self.stats["batch_lag_s"].append(now - frame["t"])
                self._events.put(ev)
        return last

    def _on_health(self, h: dict, now: float):
        self._load = (int(h["queue"]), int(h["busy"]))
        self._failover_info = h["failover"]
        if h.get("digest") is not None:
            d = h["digest"]
            self._digest = {"granule": d["granule"],
                            "heads": {k: v for k, v in d["heads"]}}
        if h["beat"]:
            self.t_heartbeat = now
        if h["fatal"] is not None and self._fatal is None:
            self._fatal = EngineStopped(
                f"replica {self.address} died: {h['fatal'][0]}: "
                f"{h['fatal'][1]}")

    def _on_reply(self, seq: int, body: dict) -> bool:
        with self._lock:
            w = self._waiters.pop(seq, None)
        if w is None:
            return False
        if "error" in body:
            w.value = _exception(body["error"])
        elif w.op in ("drain", "stop"):
            # after every stream event before it: the dispatcher settles
            self._stopped = True
            self._events.put(["closed", w, body["snaps"]])
            return True
        else:
            w.value = self._mirror(w.op, w.context, body)
        w.event.set()
        return False

    def _mirror(self, op: str, context, body: dict) -> Request:
        """The mirror of an admitted request. The load the router reads
        counts it at once, as an engine's queue does, until the next
        health message says where it is."""
        key, rid = body["key"], body["id"]
        q, busy = self._load
        self._load = (q + 1, busy)
        if op == "submit":
            prompt, max_new, cb = context
            m = Request(rid, prompt, max_new, 0, cb)
        else:
            snap, cb = context
            m = Request(rid, snap["prompt"], int(snap["max_new_tokens"]),
                        0, cb)
            m.tokens = [int(t) for t in snap["tokens"][:snap["delivered"]]]
            m.delivered = len(m.tokens)
            m.failovers = int(snap.get("failovers", 0) or 0)
        m.cancel = functools.partial(self._ask_cancel, key)
        with self._lock:
            self._mirrors[key] = m
        return m

    def _ask_cancel(self, key: int):
        try:
            self._send({"op": "cancel", "key": key})
        except EngineStopped:
            pass  # the replica is gone: its requests fail anyway

    def _lose(self, cause: BaseException):
        """The channel is gone: fatal, every waiting call fails, the
        dispatcher fails every mirror once the events before are
        applied."""
        with self._lock:
            if self._lost is not None or self._stopped:
                return
            self._lost = cause
            waiters = list(self._waiters.values())
            self._waiters.clear()
        self.t_lost = time.time()
        err = EngineStopped(f"replica channel {self.address} lost: "
                            f"{type(cause).__name__}: {cause}")
        self._fatal = err
        for w in waiters:
            w.value = err
            w.event.set()
        _shut(self._conn)
        self._events.put(["closed", None, None])

    # -- the dispatcher: stream events in order -----------------------------
    def _dispatch_loop(self):
        while True:
            ev = self._events.get()
            try:
                if ev[0] == "tok":
                    self._on_tokens(ev[1], ev[2])
                elif ev[0] == "end":
                    self._on_end(*ev[1:])
                else:
                    self._on_closed(ev[1], ev[2])
                    return
            except Exception:  # noqa: BLE001 — one bad event never stops it
                log.exception("remote replica %s: event %s failed",
                              self.address, ev[0])

    def _on_tokens(self, key: int, toks: list):
        with self._lock:
            m = self._mirrors.get(key)
        if m is None:
            return  # drained or failed here already
        for t in toks:
            m.tokens.append(int(t))
            if m.t_first_token is None:
                m.t_first_token = time.time()
            if m.stream_cb is not None:
                try:
                    m.stream_cb(m, int(t))
                except Exception:  # noqa: BLE001 — a client callback
                    log.exception("stream callback failed (remote request "
                                  "%s)", m.id)
            m.delivered = len(m.tokens)

    def _on_end(self, key: int, state: str, finish: str | None, err):
        with self._lock:
            m = self._mirrors.pop(key, None)
        if m is None:
            return
        m.__dict__.pop("cancel", None)
        m.state = state
        m.finish_reason = finish
        m.error = None if err is None else _exception(err)
        m.t_done = time.time()
        m._done.set()

    def _on_closed(self, w: _Waiter | None, snaps: list | None):
        """The channel's last event: a drain's or a stop's snapshots
        applied to their mirrors (returned to the waiting call), every
        other mirror failed with ``EngineStopped``."""
        drained = []
        with self._lock:
            for key, snap in snaps or ():
                m = self._mirrors.pop(key, None)
                if m is None:
                    continue
                m.__dict__.pop("cancel", None)
                m.tokens[:] = [int(t) for t in
                               snap["tokens"][:snap["delivered"]]]
                m.delivered = len(m.tokens)
                m.failovers = int(snap.get("failovers", 0) or 0)
                m.state = QUEUED
                drained.append(m)
            left, self._mirrors = list(self._mirrors.values()), {}
        err = self._fatal or EngineStopped(f"replica {self.address} stopped")
        for m in left:
            m.__dict__.pop("cancel", None)
            m.state = FAILED
            m.finish_reason = "error"
            m.error = err
            m.t_done = time.time()
            m._done.set()
        self._closed.set()
        if w is not None:
            w.value = drained
            w.event.set()
