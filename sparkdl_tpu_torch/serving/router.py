"""Serving fleet front door: health-gated replica routing over N
:class:`~sparkdl_tpu_torch.serving.engine.GenerationEngine` replicas.

The port's copy of ``sparkdl_tpu/serving/router.py``, whole. It imports
no torch: the router never touches device state and speaks only the
engine's public seams.

The engine is survivable on its own (failover, exactly-once resume,
``drain()`` returning resumable snapshots); this tier makes the FLEET
survivable: a replica that exhausts its failover budget — or dies
without so much as a drain — takes nobody with it. Three planes:

**Survivability.** Each replica carries a health state::

    HEALTHY ──burn/failover──▶ DEGRADED ──breaker/streak/stale──▶ DOOMED
       ▲                          │                                  │
       └──────────cooldown────────┘                       drain + re-admit
                                                                     │
    DEAD ◀──engine fatal / budget exhausted / unclean chaos kill─────┘

driven by per-replica SLO burn (``runner.slo.ReplicaBurnTracker`` fed
with router-observed TTFT/latency/outcomes), the engine's failover
ledger, a router-side heartbeat (``engine.t_heartbeat``), and a
per-replica circuit breaker over consecutive request failures. A
DOOMED replica is drained via ``engine.drain()`` and its snapshots
re-admitted on survivors through ``resume()`` — the per-request
delivery cursor survives the hop, so the greedy stream continues
bit-identical with zero duplicated and zero lost tokens. A DEAD
replica (no drain possible) falls back to ROUTER-SIDE SHADOW STATE:
the router keeps every in-flight request's prompt + fleet-level
delivery cursor, rebuilds a version-tagged resume snapshot
(:meth:`Request.snapshot` shape) host-side, and re-admits it on a
survivor — even an unclean death loses nothing. When routable
replicas fall below ``SPARKDL_FLEET_MIN_REPLICAS`` the fleet FAILS
CLOSED with one classified :class:`FleetDegradedError`.

**Routing.** Radix-AWARE placement (the default; round-robin is the
comparator, ``SPARKDL_FLEET_ROUTING=round_robin``): the router keeps a
shadow of each replica's prefix residency — the compact
``residency_digest()`` both cache families export, refreshed each tick
and updated optimistically at placement — and sends a request to the
replica holding its longest cached head (ties: least loaded). Session
affinity (``SPARKDL_FLEET_AFFINITY``) pins a session id to its last
replica while that replica stays routable. Under overload the router
sheds: a request whose chosen replica is past
``SPARKDL_FLEET_SHED_QUEUE`` queued requests WHILE its SLO burn is at
or past threshold is refused with a classified
:class:`RequestShedError` (retryable — back off and come back) rather
than deepening the queue it would time out in.

**Tail robustness.** Optional hedged requests
(``SPARKDL_FLEET_HEDGE_TTFT_S``): a request still waiting for its
first token past the threshold on a DEGRADED replica is speculatively
re-admitted on the healthiest other replica; first token wins, the
loser is cancelled via ``Request.cancel()`` (counted ``cancelled``,
never quarantined), and the fleet-level delivery cursor makes
duplicate emission impossible by construction — a token is forwarded
to the client only from the CURRENT primary and only when its absolute
stream position advances the cursor.

Chaos: the router consults ``fleet_route`` per client routing decision
and ``fleet_drain`` at drain entry; the ``replica_dead`` kind kills
the chosen replica UNCLEANLY (no drain) and exercises the shadow
re-admission path end to end (``chip_smoke.py`` phase o drives it on the
card).
"""

from __future__ import annotations

import itertools
import os
import threading
import time

from ..runner import chaos as chaos_lib
from ..runner import events
from ..runner import slo as slo_lib
from ..runner import telemetry
from .engine import (DONE, FAILED, EngineStopped, QueueFullError, Request,
                     RequestCancelled, RequestRejected, ServingError,
                     SNAPSHOT_VERSION, _env_num)
from .introspect import register_fleet
from .prefix import prompt_digest_chain

__all__ = [
    "EngineFleet", "FleetRequest", "FleetDegradedError",
    "RequestShedError", "FleetRoutingError",
    "HEALTHY", "DEGRADED", "DOOMED", "DEAD",
    "FLEET_REPLICAS_ENV", "FLEET_MIN_REPLICAS_ENV", "FLEET_HEDGE_ENV",
    "FLEET_HEARTBEAT_ENV", "FLEET_SHED_ENV", "FLEET_AFFINITY_ENV",
    "FLEET_ROUTING_ENV", "FLEET_BREAKER_ENV",
]

# Fleet knobs. Same _env_num plumbing as the engine's.
FLEET_REPLICAS_ENV = "SPARKDL_FLEET_REPLICAS"
FLEET_MIN_REPLICAS_ENV = "SPARKDL_FLEET_MIN_REPLICAS"
FLEET_HEDGE_ENV = "SPARKDL_FLEET_HEDGE_TTFT_S"
FLEET_HEARTBEAT_ENV = "SPARKDL_FLEET_HEARTBEAT_S"
FLEET_SHED_ENV = "SPARKDL_FLEET_SHED_QUEUE"
FLEET_AFFINITY_ENV = "SPARKDL_FLEET_AFFINITY"
FLEET_ROUTING_ENV = "SPARKDL_FLEET_ROUTING"
FLEET_BREAKER_ENV = "SPARKDL_FLEET_BREAKER_FAILURES"

# Replica health states (plain strings — they serialize into events,
# introspection and bench records as-is).
HEALTHY = "healthy"
DEGRADED = "degraded"
DOOMED = "doomed"
DEAD = "dead"

# A DEGRADED verdict with no fresh signal decays back to HEALTHY after
# this long — reversibility is what separates DEGRADED from DOOMED.
_DEGRADE_COOLDOWN_S = 5.0


def _burn_objectives():
    """The per-replica burn objectives: the env-armed ``SPARKDL_SLO_*``
    set when present, else a 1%-error-budget fallback — error burn must
    drive DEGRADED even on an unconfigured fleet, while latency/TTFT
    objectives stay opt-in (the router cannot guess a threshold)."""
    objs = slo_lib.objectives_from_env()
    if objs:
        return objs
    return [slo_lib.Objective("errors", "error_rate", "fleet", 0.01,
                              0.99)]


class FleetDegradedError(ServingError):
    """The fleet is below its ``SPARKDL_FLEET_MIN_REPLICAS`` floor (or
    has no routable replica at all) and FAILS CLOSED: admitting more
    work onto a sub-minimum fleet converts an availability incident
    into a correctness one. Retryable — capacity can come back."""


class RequestShedError(ServingError):
    """Load shedding refused this request: the chosen replica is past
    the ``SPARKDL_FLEET_SHED_QUEUE`` depth while its SLO burn is at or
    past threshold. Retryable — back off and resubmit."""


class FleetRoutingError(ServingError):
    """No replica can EVER serve this request (every routable replica
    rejected it at admission). Fatal — resubmitting the same request
    reproduces the same rejections."""


class FleetRequest:
    """One client request, fleet edition: the handle
    :meth:`EngineFleet.submit` returns. Outlives any single engine
    request — across drains, unclean replica deaths and hedge races the
    handle, its ``tokens`` and its fleet-level exactly-once ``delivered``
    cursor are the client-facing truth."""

    def __init__(self, fid: int, prompt, max_new_tokens: int,
                 stream_cb=None, session=None):
        self.id = fid
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.stream_cb = stream_cb
        self.session = session
        self.tokens: list[int] = []
        self.delivered = 0          # == len(tokens): the fleet cursor
        self.state = "queued"       # queued | running | done | failed
        self.finish_reason: str | None = None
        self.error: BaseException | None = None
        self.replica: str | None = None   # current primary's name
        self.hops = 0               # re-admissions survived
        self.hedges = 0             # speculative twins fired
        self.t_submit = time.time()
        self.t_routed = self.t_submit
        self.t_first_token: float | None = None
        self.t_done: float | None = None
        self._primary: Request | None = None  # sole delivery authority
        self._hedge: Request | None = None
        self._hedge_replica: str | None = None
        self._cancel = False
        self._lock = threading.Lock()
        self._done_evt = threading.Event()

    @property
    def done(self) -> bool:
        return self._done_evt.is_set()

    def cancel(self):
        """Client-side abort: forwarded to the live engine request(s),
        honored at their next iteration boundary. Idempotent."""
        with self._lock:
            self._cancel = True
            victims = [r for r in (self._primary, self._hedge)
                       if r is not None]
        for r in victims:
            r.cancel()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done_evt.wait(timeout)

    def result(self, timeout: float | None = None) -> list[int]:
        if not self._done_evt.wait(timeout):
            raise TimeoutError(f"fleet request {self.id} not done after "
                               f"{timeout}s")
        if self.state != "done":
            raise self.error if self.error is not None else \
                ServingError(f"fleet request {self.id} ended in state "
                             f"{self.state}")
        return list(self.tokens)

    def snapshot_dict(self) -> dict:
        """The router-side shadow snapshot: the :meth:`Request.snapshot`
        shape rebuilt from FLEET state, so even a replica that died
        without draining re-admits from the delivery cursor (tokens the
        client never saw are simply regrown by greedy determinism)."""
        with self._lock:
            return {
                "version": SNAPSHOT_VERSION,
                "id": self.id,
                "prompt": list(self.prompt),
                "tokens": list(self.tokens[:self.delivered]),
                "delivered": self.delivered,
                "max_new_tokens": self.max_new_tokens,
                "failovers": self.hops,
            }

    def __repr__(self):
        return (f"FleetRequest(id={self.id}, state={self.state}, "
                f"replica={self.replica}, n_out={len(self.tokens)}, "
                f"hops={self.hops})")


class _Replica:
    """Router-side view of one engine replica: health state, the
    residency shadow, the burn tracker and the breaker ledger."""

    def __init__(self, name: str, engine):
        self.name = name
        self.engine = engine
        self.state = HEALTHY
        self.t_state = time.time()
        self.state_reason = ""
        self.burn = slo_lib.ReplicaBurnTracker(_burn_objectives())
        self.consecutive_failures = 0
        self.failovers_seen = 0
        self.routed = 0
        self.drained = False
        # residency shadow: {chained head hash -> head length in
        # tokens}; granule from the engine's digest (None = replica has
        # no prefix cache — radix routing degrades to least-loaded)
        self.shadow: dict[int, int] = {}
        self.granule: int | None = None
        self.refresh_shadow()

    def refresh_shadow(self):
        try:
            dig = self.engine.residency_digest()
        except Exception:  # noqa: BLE001 — routing hint, never fatal
            dig = None
        if dig is None:
            return
        self.granule = int(dig["granule"])
        # merge: keep optimistic inserts for prompts still in flight
        # (their commit lands in a later digest), let the authoritative
        # digest win on collisions
        merged = dict(self.shadow)
        merged.update(dig["heads"])
        self.shadow = merged

    def note_shadow(self, prompt):
        """Optimistic placement update: the routed prompt's heads are
        ABOUT to become resident here — recording them now is what
        co-locates a prefix family before the first commit lands."""
        if self.granule is None:
            return
        for n, h in prompt_digest_chain(prompt, self.granule):
            if self.shadow.get(h, 0) < n:
                self.shadow[h] = n

    def match_depth(self, prompt) -> int:
        """Tokens of ``prompt``'s head this replica (probably) holds."""
        if not self.shadow or self.granule is None:
            return 0
        best = 0
        for n, h in prompt_digest_chain(prompt, self.granule):
            if h in self.shadow:
                best = n
            else:
                break
        return best

    def load(self) -> int:
        eng = self.engine
        return len(eng._queue) + sum(r is not None for r in eng._slots)

    def routable(self) -> bool:
        return self.state in (HEALTHY, DEGRADED)


class EngineFleet:
    """N engine replicas behind one ``submit()`` (see module doc).

    Drive it like the engine: inline (``step()`` /
    ``run_until_idle()`` — each live replica steps once, then the fleet
    supervisor ticks) or threaded (``start()`` runs every engine's own
    loop plus a supervisor thread; ``stop()`` tears all of it down).
    """

    def __init__(self, engines, *, names=None,
                 min_replicas: int | None = None,
                 routing: str | None = None,
                 hedge_ttft_s: float | None = None,
                 heartbeat_s: float | None = None,
                 shed_queue: int | None = None,
                 affinity: bool | None = None,
                 breaker_failures: int | None = None):
        engines = list(engines)
        names = list(names) if names is not None else \
            [f"replica{i}" for i in range(len(engines))]
        if len(names) != len(engines):
            raise ValueError(f"{len(engines)} engines but {len(names)} "
                             f"names")
        self._replicas: dict[str, _Replica] = {
            n: _Replica(n, e) for n, e in zip(names, engines)}
        self.min_replicas = max(0, min_replicas
                                if min_replicas is not None
                                else _env_num(FLEET_MIN_REPLICAS_ENV, 1))
        self.routing = (routing if routing is not None
                        else os.environ.get(FLEET_ROUTING_ENV,
                                            "radix")).lower()
        if self.routing not in ("radix", "round_robin"):
            raise ValueError(f"unknown routing policy {self.routing!r}; "
                             f"use 'radix' or 'round_robin'")
        self.hedge_ttft_s = max(0.0, hedge_ttft_s
                                if hedge_ttft_s is not None
                                else _env_num(FLEET_HEDGE_ENV, 0.0, float))
        self.heartbeat_s = max(0.0, heartbeat_s
                               if heartbeat_s is not None
                               else _env_num(FLEET_HEARTBEAT_ENV, 10.0,
                                             float))
        self.shed_queue = max(0, shed_queue if shed_queue is not None
                              else _env_num(FLEET_SHED_ENV, 0))
        self.affinity = (os.environ.get(FLEET_AFFINITY_ENV, "1").lower()
                         not in ("0", "false")) if affinity is None \
            else bool(affinity)
        self.breaker_failures = max(0, breaker_failures
                                    if breaker_failures is not None
                                    else _env_num(FLEET_BREAKER_ENV, 3))
        self._ids = itertools.count()
        self._route_count = 0
        self._rr_next = 0
        self._inflight: list[FleetRequest] = []
        self._sessions: dict[object, str] = {}
        self._lock = threading.Lock()
        self._threaded = False
        self._supervisor: threading.Thread | None = None
        self._stop_supervisor = threading.Event()
        self.stats = {
            "submitted": 0, "completed": 0, "failed": 0, "shed": 0,
            "hedges_fired": 0, "hedges_won": 0, "readmissions": 0,
            "drains": 0, "replica_deaths": 0, "cancelled": 0,
        }
        register_fleet(self)

    @classmethod
    def from_factory(cls, make_engine, n: int | None = None,
                     **kw) -> "EngineFleet":
        """Build ``n`` replicas (default ``SPARKDL_FLEET_REPLICAS``,
        floor 1) from a zero-arg engine factory."""
        n = max(1, n if n is not None
                else _env_num(FLEET_REPLICAS_ENV, 1))
        return cls([make_engine() for _ in range(n)], **kw)

    # -- introspection ----------------------------------------------------
    @property
    def replicas_healthy(self) -> int:
        return sum(1 for r in self._replicas.values() if r.routable())

    def replica_names(self):
        return list(self._replicas)

    def replica_state(self, name: str) -> str:
        return self._replicas[name].state

    def engine(self, name: str):
        return self._replicas[name].engine

    def debug_state(self) -> dict:
        reps = {}
        for name, rep in self._replicas.items():
            info = getattr(rep.engine, "_failover_info", {}) or {}
            reps[name] = {
                "state": rep.state,
                "state_reason": rep.state_reason,
                "routed": rep.routed,
                "load": rep.load(),
                "shadow_heads": len(rep.shadow),
                "shadow_granule": rep.granule,
                "burn": rep.burn.max_burn(),
                "engine_failovers": info.get("count", 0),
                "consecutive_failures": rep.consecutive_failures,
            }
        return {
            "replicas": reps,
            "replicas_healthy": self.replicas_healthy,
            "min_replicas": self.min_replicas,
            "routing": self.routing,
            "hedge_ttft_s": self.hedge_ttft_s,
            "inflight": len(self._inflight),
            "stats": dict(self.stats),
        }

    def snapshot(self) -> dict:
        return self.debug_state()

    # -- submission + routing ---------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 16, *,
               stream_cb=None, session=None) -> FleetRequest:
        """Route one request onto a replica and return its fleet
        handle. Raises :class:`FleetDegradedError` below the replica
        floor (fail closed), :class:`RequestShedError` under overload
        shedding, :class:`FleetRoutingError` when every routable
        replica rejects it, :class:`QueueFullError` when every
        routable replica is backpressuring."""
        prompt = [int(t) for t in prompt_ids]
        fr = FleetRequest(next(self._ids), prompt, max_new_tokens,
                          stream_cb, session)
        with self._lock:
            self._route_fire(fr)
            self._place(fr, shed_ok=True)
            self.stats["submitted"] += 1
            self._inflight.append(fr)
        fr.state = "running"
        return fr

    def _route_fire(self, fr: FleetRequest):
        """The ``fleet_route`` chaos site: one consult per CLIENT
        routing decision (re-admissions do not re-fire — a cascade of
        injected deaths chasing its own recovery would never
        converge). ``replica_dead`` here kills the replica the router
        WOULD have chosen, then routing proceeds over the survivors."""
        self._route_count += 1
        try:
            chaos_lib.fire("fleet_route", step=self._route_count)
        except chaos_lib.InjectedReplicaDead as e:
            victim = self._choose(fr.prompt, fr.session, set(),
                                  required=False)
            if victim is not None:
                self._replica_dead_locked(victim, e)

    def _choose(self, prompt, session, exclude: set,
                required: bool = True) -> "_Replica | None":
        """Pick the target replica (caller holds the fleet lock).
        Health gate → affinity → radix-aware deepest-resident-head (or
        round-robin comparator) with least-loaded tie-break."""
        routable = [r for r in self._replicas.values() if r.routable()]
        if len(routable) < self.min_replicas or not routable:
            if not required:
                return None
            raise FleetDegradedError(
                f"fleet has {len(routable)} routable replica(s), below "
                f"the {FLEET_MIN_REPLICAS_ENV}={self.min_replicas} "
                f"floor — failing closed")
        cands = [r for r in routable if r.name not in exclude]
        if not cands:
            if not required:
                return None
            raise FleetDegradedError(
                f"no routable replica remains for this request "
                f"(excluded: {sorted(exclude)}; floor "
                f"{FLEET_MIN_REPLICAS_ENV}={self.min_replicas})")
        if self.affinity and session is not None:
            pinned = self._sessions.get(session)
            if pinned is not None:
                rep = self._replicas.get(pinned)
                if rep is not None and rep in cands:
                    return rep
        if self.routing == "round_robin":
            order = sorted(cands, key=lambda r: r.name)
            rep = order[self._rr_next % len(order)]
            self._rr_next += 1
            return rep
        best, best_key = None, None
        for rep in cands:
            key = (-rep.match_depth(prompt), rep.load(), rep.name)
            if best_key is None or key < best_key:
                best, best_key = rep, key
        return best

    def _place(self, fr: FleetRequest, *, exclude: set | None = None,
               shed_ok: bool = False, resume_from=None):
        """Admit ``fr`` onto a chosen replica (caller holds the fleet
        lock). ``resume_from``: a drained engine :class:`Request`
        handle (DOOMED path) or a snapshot dict (DEAD/shadow path);
        None = fresh submit. Walks the candidate order on
        backpressure; every-replica rejection raises
        :class:`FleetRoutingError`."""
        exclude = set(exclude or ())
        rejected: list[str] = []
        while True:
            rep = self._choose(fr.prompt, fr.session, exclude)
            if shed_ok and self.shed_queue > 0 \
                    and len(rep.engine._queue) >= self.shed_queue:
                burn = rep.burn.max_burn()
                if burn is not None and burn >= 1.0:
                    self.stats["shed"] += 1
                    telemetry.fleet_metric("shed")
                    events.event("fleet_request_shed", request=fr.id,
                                 replica=rep.name, burn=burn)
                    raise RequestShedError(
                        f"request shed: replica {rep.name} is past "
                        f"{FLEET_SHED_ENV}={self.shed_queue} queued "
                        f"requests while burning at {burn:.2f}x — back "
                        f"off and resubmit")
            try:
                with fr._lock:
                    shim = self._make_shim(fr)
                    if resume_from is None:
                        ereq = rep.engine.submit(
                            fr.prompt, fr.max_new_tokens,
                            stream_cb=shim, block=False)
                    else:
                        ereq = rep.engine.resume(resume_from,
                                                 stream_cb=shim)
                    fr._primary = ereq
                    fr.replica = rep.name
                    fr.t_routed = time.time()
            except QueueFullError:
                exclude.add(rep.name)
                continue
            except RequestRejected:
                rejected.append(rep.name)
                exclude.add(rep.name)
                if len(exclude) >= len(self._replicas):
                    raise FleetRoutingError(
                        f"no replica can serve request {fr.id}: "
                        f"rejected by {sorted(rejected)}") from None
                continue
            except EngineStopped as e:
                # the replica died between health check and admission
                self._replica_dead_locked(rep, e)
                exclude.add(rep.name)
                continue
            rep.routed += 1
            rep.note_shadow(fr.prompt + fr.tokens[:fr.delivered])
            if self.affinity and fr.session is not None:
                self._sessions[fr.session] = rep.name
            return

    # -- exactly-once delivery --------------------------------------------
    def _make_shim(self, fr: FleetRequest):
        """The per-fleet-request stream shim, bound to whichever engine
        request currently serves it. THE exactly-once mechanism: an
        engine request's ``tokens`` list holds the ABSOLUTE stream
        (resume rehydrates the delivered prefix), so
        ``len(ereq.tokens)`` at callback time is the absolute position
        of the token just emitted — it is forwarded iff the emitter is
        the current primary AND the position advances the fleet
        cursor. Hedge twins, superseded primaries and replayed tokens
        all fall out as silent drops of the same two checks."""
        def shim(ereq: Request, tok: int):
            emit: list[int] = []
            loser: Request | None = None
            first = False
            with fr._lock:
                if fr.state in ("done", "failed"):
                    return
                if ereq is not fr._primary:
                    if ereq is fr._hedge \
                            and len(ereq.tokens) > fr.delivered:
                        # hedge wins the first-token race: it becomes
                        # the primary, the old primary is cancelled
                        loser = fr._primary
                        fr._primary = ereq
                        fr.replica = fr._hedge_replica
                        fr._hedge = None
                        fr._hedge_replica = None
                        self.stats["hedges_won"] += 1
                        telemetry.fleet_metric("hedge_won")
                        events.event("fleet_hedge_won", request=fr.id,
                                     replica=fr.replica)
                    else:
                        return  # superseded emitter: drop silently
                elif fr._hedge is not None \
                        and len(ereq.tokens) > fr.delivered:
                    # primary wins: the speculative twin is the loser
                    loser = fr._hedge
                    fr._hedge = None
                    fr._hedge_replica = None
                pos = len(ereq.tokens)
                if pos <= fr.delivered:
                    return  # replay below the cursor: drop silently
                emit = list(ereq.tokens[fr.delivered:pos])
                del fr.tokens[fr.delivered:]
                fr.tokens.extend(emit)
                fr.delivered = len(fr.tokens)
                if fr.t_first_token is None:
                    fr.t_first_token = time.time()
                    first = True
            if loser is not None:
                loser.cancel()
            if first:
                rep = self._replicas.get(fr.replica or "")
                if rep is not None:
                    rep.burn.record_ttft(fr.t_first_token - fr.t_submit)
            if fr.stream_cb is not None:
                for t in emit:
                    try:
                        fr.stream_cb(fr, t)
                    except Exception:  # noqa: BLE001 — client bug
                        pass           # never kills the stream
        return shim

    # -- drive ------------------------------------------------------------
    def step(self) -> bool:
        """One inline fleet iteration: every live replica's engine
        steps once, then the supervisor tick runs (health, hedging,
        completion, re-admission). Returns True while anything is in
        flight or any engine worked."""
        worked = False
        for rep in list(self._replicas.values()):
            if rep.state == DEAD or rep.drained:
                continue
            try:
                worked = rep.engine.step() or worked
            except EngineStopped as e:
                with self._lock:
                    self._replica_dead_locked(rep, e)
        worked = self._tick() or worked
        with self._lock:
            pending = bool(self._inflight)
        return worked or pending

    def run_until_idle(self):
        while self.step():
            pass

    def start(self) -> "EngineFleet":
        """Threaded drive: each engine's own loop plus one supervisor
        thread ticking health/hedging/re-admission."""
        self._threaded = True
        for rep in self._replicas.values():
            if rep.state != DEAD and not rep.drained:
                rep.engine.start()
        if self._supervisor is None:
            self._stop_supervisor.clear()
            self._supervisor = threading.Thread(
                target=self._supervise, name="sparkdl-fleet-supervisor",
                daemon=True)
            self._supervisor.start()
        return self

    def _supervise(self):
        try:
            while not self._stop_supervisor.wait(0.005):
                self._tick()
        finally:
            self._supervisor = None

    def stop(self, drain: bool = True, timeout: float | None = None):
        """Tear the fleet down. ``drain=True`` finishes in-flight work
        first (per engine); ``drain=False`` fails it."""
        self._stop_supervisor.set()
        sup = self._supervisor
        if sup is not None:
            sup.join(timeout if timeout is not None else 5.0)
        for rep in self._replicas.values():
            if rep.state != DEAD and not rep.drained:
                try:
                    rep.engine.stop(drain=drain, timeout=timeout)
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
        self._threaded = False
        self._tick()

    # -- supervisor tick ---------------------------------------------------
    def _tick(self) -> bool:
        now = time.time()
        worked = False
        with self._lock:
            for rep in self._replicas.values():
                self._assess_locked(rep, now)
                if rep.routable():
                    rep.refresh_shadow()
            for rep in [r for r in self._replicas.values()
                        if r.state == DOOMED and not r.drained]:
                self._drain_replica_locked(rep)
                worked = True
            worked = self._scan_inflight_locked(now) or worked
            healthy = self.replicas_healthy
        telemetry.fleet_metric("healthy", healthy)
        return worked

    def _assess_locked(self, rep: _Replica, now: float):
        """One replica's health transition (fleet lock held)."""
        if rep.state in (DOOMED, DEAD):
            return
        eng = rep.engine
        if eng._fatal is not None:
            self._replica_dead_locked(rep, eng._fatal)
            return
        info = getattr(eng, "_failover_info", {}) or {}
        if info.get("state") == "exhausted":
            self._replica_dead_locked(
                rep, EngineStopped("replica failover budget exhausted"))
            return
        if self.breaker_failures > 0 \
                and rep.consecutive_failures >= self.breaker_failures:
            self._doom_locked(rep, "circuit breaker: "
                              f"{rep.consecutive_failures} consecutive "
                              f"request failures")
            return
        if self._threaded and self.heartbeat_s > 0 \
                and eng._thread is not None:
            busy = bool(eng._queue) or any(r is not None
                                           for r in eng._slots)
            if busy and now - eng.t_heartbeat > self.heartbeat_s:
                self._doom_locked(
                    rep, f"heartbeat stale "
                    f"{now - eng.t_heartbeat:.1f}s > "
                    f"{FLEET_HEARTBEAT_ENV}={self.heartbeat_s}")
                return
        burn = rep.burn.max_burn(now)
        failovers = int(info.get("count", 0))
        signal = None
        if failovers > rep.failovers_seen:
            rep.failovers_seen = failovers
            signal = f"engine failover #{failovers}"
        elif burn is not None and burn >= 1.0:
            signal = f"SLO burn {burn:.2f}x"
        if signal is not None:
            if rep.state == HEALTHY:
                events.event("fleet_replica_degraded", replica=rep.name,
                             reason=signal)
            rep.state = DEGRADED
            rep.t_state = now
            rep.state_reason = signal
        elif rep.state == DEGRADED \
                and now - rep.t_state > _DEGRADE_COOLDOWN_S:
            rep.state = HEALTHY
            rep.t_state = now
            rep.state_reason = "recovered"

    def _doom_locked(self, rep: _Replica, reason: str):
        rep.state = DOOMED
        rep.t_state = time.time()
        rep.state_reason = reason
        events.event("fleet_replica_doomed", replica=rep.name,
                     reason=reason[:200])

    # -- DOOMED: drain + re-admit ------------------------------------------
    def doom_replica(self, name: str, reason: str = "operator"):
        """Mark a replica DOOMED; the next tick (or this call, inline)
        drains it and re-admits its requests on survivors."""
        with self._lock:
            rep = self._replicas[name]
            if rep.state in (DOOMED, DEAD):
                return
            self._doom_locked(rep, reason)
            self._drain_replica_locked(rep)

    def _drain_replica_locked(self, rep: _Replica):
        """Drain a DOOMED replica and re-admit its snapshots on
        survivors — cross-engine exactly-once: the drained handles keep
        their delivery cursors, ``resume()`` re-buckets them for the
        survivor, and the shim keeps forwarding from the same cursor.
        Idempotent (``rep.drained`` latch). A ``replica_dead`` fault at
        the ``fleet_drain`` site — or any drain failure — escalates to
        DEAD, which falls back to shadow re-admission."""
        if rep.drained or rep.state == DEAD:
            return
        rep.drained = True
        self.stats["drains"] += 1
        try:
            chaos_lib.fire("fleet_drain", step=self.stats["drains"])
            snaps = rep.engine.drain(timeout=5.0)
        except Exception as e:  # noqa: BLE001 — escalate, never wedge
            self._replica_dead_locked(rep, e)
            return
        events.event("fleet_replica_drained", replica=rep.name,
                     requests=len(snaps))
        for ereq in snaps:
            fr = self._fr_for(ereq)
            if fr is None:
                continue
            if ereq is fr._hedge:
                with fr._lock:
                    fr._hedge = None
                    fr._hedge_replica = None
                continue
            self._readmit_locked(fr, resume_from=ereq,
                                 exclude={rep.name})

    # -- DEAD: shadow re-admission -----------------------------------------
    def kill_replica(self, name: str, cause: BaseException | None = None):
        """Unclean replica death (tests/chaos): no drain, engine
        stopped hard; in-flight requests re-admit from router shadow
        state at the next tick."""
        with self._lock:
            self._replica_dead_locked(
                self._replicas[name],
                cause or RuntimeError("replica killed"))

    def _replica_dead_locked(self, rep: _Replica, cause):
        if rep.state == DEAD:
            return
        rep.state = DEAD
        rep.t_state = time.time()
        rep.state_reason = f"{type(cause).__name__}: {cause}"[:200]
        rep.drained = True
        self.stats["replica_deaths"] += 1
        events.event("fleet_replica_dead", replica=rep.name,
                     cause=rep.state_reason)
        for session, pinned in list(self._sessions.items()):
            if pinned == rep.name:
                del self._sessions[session]
        try:
            # fail the engine's pending work NOW (EngineStopped) so the
            # inflight scan can re-admit it; an engine already fatal has
            # done this itself
            rep.engine.stop(drain=False, timeout=0.5)
        except Exception:  # noqa: BLE001 — it is already dead
            pass

    def _fr_for(self, ereq: Request) -> FleetRequest | None:
        for fr in self._inflight:
            if fr._primary is ereq or fr._hedge is ereq:
                return fr
        return None

    def _readmit_locked(self, fr: FleetRequest, *, resume_from,
                        exclude: set):
        """Move one in-flight request to a survivor (fleet lock held).
        ``resume_from``: drained engine handle or shadow snapshot
        dict. A floor breach fails the REQUEST closed with the
        classified :class:`FleetDegradedError` instead of retrying
        into a dead fleet."""
        try:
            self._place(fr, exclude=exclude, resume_from=resume_from)
        except ServingError as e:
            self._finish_failed_locked(fr, e)
            return
        fr.hops += 1
        self.stats["readmissions"] += 1
        telemetry.fleet_metric("readmitted")
        events.event("fleet_request_readmitted", request=fr.id,
                     replica=fr.replica, delivered=fr.delivered)

    # -- in-flight scan: completion, failure, hedging ----------------------
    def _scan_inflight_locked(self, now: float) -> bool:
        worked = False
        for fr in list(self._inflight):
            with fr._lock:
                p, h = fr._primary, fr._hedge
            if h is not None and h.state == FAILED:
                # a hedge dying (its replica vanished, it was
                # cancelled as loser, ...) never fails the request
                with fr._lock:
                    if fr._hedge is h:
                        fr._hedge = None
                        fr._hedge_replica = None
            if p is None:
                continue
            if p.state == DONE:
                self._finish_done_locked(fr, p)
                worked = True
            elif p.state == FAILED:
                worked = self._primary_failed_locked(fr, p) or worked
            else:
                self._maybe_hedge_locked(fr, now)
        return worked

    def _finish_done_locked(self, fr: FleetRequest, p: Request):
        with fr._lock:
            hedge = fr._hedge
            fr._hedge = None
            fr._hedge_replica = None
            # sync any tokens emitted after the last callback (the
            # cursor advances only through the shim, which p's final
            # _deliver already ran — this is belt and braces)
            fr.state = "done"
            fr.finish_reason = p.finish_reason
            fr.t_done = time.time()
        if hedge is not None:
            hedge.cancel()
        rep = self._replicas.get(fr.replica or "")
        if rep is not None:
            rep.burn.record_latency(fr.t_done - fr.t_submit)
            rep.burn.record_outcome(True)
            rep.consecutive_failures = 0
        self.stats["completed"] += 1
        self._inflight.remove(fr)
        fr._done_evt.set()

    def _primary_failed_locked(self, fr: FleetRequest, p: Request) -> bool:
        err = p.error
        if isinstance(err, EngineStopped) and not fr._cancel:
            # the replica died under this request: re-admit from
            # router shadow state (zero-dup/zero-loss by cursor)
            dead = fr.replica
            self._readmit_locked(fr, resume_from=fr.snapshot_dict(),
                                 exclude={dead} if dead else set())
            return True
        self._finish_failed_locked(fr, err or ServingError(
            f"request {fr.id} failed without an error"))
        return True

    def _finish_failed_locked(self, fr: FleetRequest, err):
        with fr._lock:
            hedge = fr._hedge
            fr._hedge = None
            fr._hedge_replica = None
            fr.state = "failed"
            fr.error = err
            fr.finish_reason = "error"
            fr.t_done = time.time()
        if hedge is not None:
            hedge.cancel()
        rep = self._replicas.get(fr.replica or "")
        cancelled = isinstance(err, RequestCancelled)
        if rep is not None and not cancelled:
            rep.burn.record_outcome(False)
            rep.consecutive_failures += 1
        self.stats["cancelled" if cancelled else "failed"] += 1
        if fr in self._inflight:
            self._inflight.remove(fr)
        fr._done_evt.set()

    def _maybe_hedge_locked(self, fr: FleetRequest, now: float):
        """Fire the speculative twin for a first-token-starved request
        on a DEGRADED replica (see module doc)."""
        if self.hedge_ttft_s <= 0 or fr.t_first_token is not None:
            return
        with fr._lock:
            if fr._hedge is not None or fr._cancel:
                return
        if now - fr.t_routed < self.hedge_ttft_s:
            return
        rep = self._replicas.get(fr.replica or "")
        if rep is None or rep.state != DEGRADED:
            return
        target = self._choose(fr.prompt, None,
                              {fr.replica} if fr.replica else set(),
                              required=False)
        if target is None:
            return
        shim = self._make_shim(fr)
        try:
            with fr._lock:
                ereq = target.engine.submit(fr.prompt, fr.max_new_tokens,
                                            stream_cb=shim, block=False)
                fr._hedge = ereq
                fr._hedge_replica = target.name
        except ServingError:
            return
        fr.hedges += 1
        self.stats["hedges_fired"] += 1
        telemetry.fleet_metric("hedge_fired")
        events.event("fleet_hedge_fired", request=fr.id,
                     primary=fr.replica, hedge=target.name)

    # -- fleet-wide drain (tests / rolling restart) ------------------------
    def drain(self, timeout: float | None = None) -> int:
        """Drain every live replica (each one's snapshots re-admit on
        the remaining survivors while any exist). Idempotent — a
        drained/dead fleet drains to 0 again. Returns the number of
        replicas drained by THIS call."""
        drained = 0
        with self._lock:
            for rep in self._replicas.values():
                if rep.state in (DOOMED, DEAD) or rep.drained:
                    continue
                self._doom_locked(rep, "fleet drain")
                self._drain_replica_locked(rep)
                drained += 1
            self._scan_inflight_locked(time.time())
        return drained
