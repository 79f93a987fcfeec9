"""Deterministic fault injection at the serving engine's and the image
scorer's sites.

The port's copy of ``sparkdl_tpu/runner/chaos.py``, cut to what the
serving engine and the image scorer reach: their six sites and the kinds
that make sense there. The training and fleet sites (and their kinds:
``nan``, ``poison``, ``sigkill``, ``decimate``, ``corrupt``,
``replica_dead``) return with the slices that port their callers
(ROADMAP.md). Every fired fault counts into ``runner.metrics.run_stats``.

A seeded :class:`FaultPlan` injects faults at named **sites**; plans
serialize to one env var (``SPARKDL_CHAOS``), so a serving process picks a
plan up with no change to its code.

Sites (where the engine and the scorer consult the plan):

- ``decode``           — one host decode attempt of the image scorer's
  chunk (or of one row in the quarantine fallback; ``core/ingest.py``)
- ``dispatch``         — one batch's dispatch in ``BatchRunner.run_stream``
  (exercises the dispatch retry path, ``core/runtime.py``)

- ``serve_prefill``    — a serving backend's prefill / prefill-chunk call
  (``serving/backend.py``; exercises prefill retry → quarantine and, for
  ``cache_lost``, the engine failover supervisor)
- ``serve_decode``     — a serving backend's decode / verify step
  (exercises step retry → evict-newest and failover)
- ``serve_alloc``      — a paged block reservation (``begin_prefill`` /
  ``ensure_block_for``; exercises exhaustion-as-backpressure vs failover
  routing)
- ``serve_commit``     — a prefix-cache / radix commit at prefill end
  (commit failures must degrade, never kill the request)

Kinds (what happens when a fault fires):

- ``preempt`` — raise a retryable ``UNAVAILABLE``/preemption-shaped error
- ``fatal``   — raise an ``INVALID_ARGUMENT``-shaped program error (no retry)
- ``hang``    — sleep ``hang_s`` (exercises the stall watchdog)
- ``cache_lost`` — raise a serving-fatal ``InjectedCacheLost`` shaped like
  the slot-cache loss ``serving/backend.py`` converts real device
  failures into (``SlotCacheLost``): the slot KV cache is gone, retrying
  the call cannot help, and the engine must fail over (snapshot live
  requests, rebuild the backend, re-admit). This is how the failover path
  is exercised on the CPU, where no device call fails.

Triggers are deterministic: ``at_step=N`` fires when the hook's step equals
N; ``prob=p`` draws from a per-fault ``RandomState`` seeded from
``(plan.seed, fault index)`` so two identically-seeded plans fire
identically. ``once=True`` (default) fires at most once — and when the plan
carries a ``state_dir``, "once" persists across process restarts via marker
files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

__all__ = ["Fault", "FaultPlan", "InjectedFault", "InjectedPreemption",
           "InjectedFatal", "InjectedCacheLost", "SITES", "KINDS",
           "CHAOS_ENV", "fire", "install", "uninstall", "active_plan"]

CHAOS_ENV = "SPARKDL_CHAOS"

SITES = ("decode", "dispatch", "serve_prefill", "serve_decode",
         "serve_alloc", "serve_commit")
KINDS = ("preempt", "fatal", "hang", "cache_lost")


class InjectedFault(RuntimeError):
    """Base of all chaos-raised errors (lets tests/telemetry tell injected
    failures from organic ones; classification ignores this and goes by
    message text, exactly as it would for the real error)."""


class InjectedPreemption(InjectedFault):
    """Retryable: shaped like the error a lost device connection produces."""


class InjectedFatal(InjectedFault):
    """Fatal: shaped like an INVALID_ARGUMENT program error."""


class InjectedCacheLost(InjectedFault):
    """Serving-fatal: shaped like ``serving.backend.SlotCacheLost`` — a
    slot call failed on the device, so the backend's device state is
    unrecoverable and the engine must fail over rather than retry. The
    engine routes on the ``serving_fatal`` class attribute, exactly as it
    does for the organic error."""
    serving_fatal = True


def _this_rank() -> int:
    return int(os.environ.get("SPARKDL_PROCESS_ID", "0"))


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injection: fire ``kind`` at ``site`` when the trigger matches.

    Exactly one trigger: ``at_step`` (fire when the hook's step == N) or
    ``prob`` (seeded coin per eligible call). ``rank`` restricts to one
    process (``SPARKDL_PROCESS_ID``); ``once`` caps total fires at one
    (per process, or globally with a plan ``state_dir``).
    """
    site: str
    kind: str
    at_step: int | None = None
    prob: float = 0.0
    rank: int | None = None
    once: bool = True
    hang_s: float = 3600.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown chaos site {self.site!r}; "
                             f"sites: {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; "
                             f"kinds: {KINDS}")
        if self.at_step is None and not (0.0 < self.prob <= 1.0):
            raise ValueError(f"fault needs a trigger: at_step=N or "
                             f"0 < prob <= 1 (got at_step=None, "
                             f"prob={self.prob})")


@dataclasses.dataclass
class FaultPlan:
    """A seeded set of :class:`Fault`\\ s plus the firing state machine.

    ``state_dir``: when set, ``once`` faults leave a marker file there on
    firing, making "once" hold across process restarts.
    """
    faults: list[Fault]
    seed: int = 0
    state_dir: str | None = None

    def __post_init__(self):
        self.faults = [f if isinstance(f, Fault) else Fault(**f)
                       for f in self.faults]
        self._fired = [0] * len(self.faults)
        self._rngs = None  # built lazily; numpy not needed for serialization

    # -- serialization (env-var transport) --------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed, "state_dir": self.state_dir,
            "faults": [dataclasses.asdict(f) for f in self.faults]})

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls(faults=[Fault(**f) for f in d.get("faults", [])],
                   seed=int(d.get("seed", 0)),
                   state_dir=d.get("state_dir"))

    def to_env(self) -> dict[str, str]:
        """Env fragment for a child process: its first ``fire()``
        installs the plan."""
        return {CHAOS_ENV: self.to_json()}

    @classmethod
    def from_env(cls, environ=None) -> "FaultPlan | None":
        text = (environ if environ is not None else os.environ).get(CHAOS_ENV)
        return cls.from_json(text) if text else None

    # -- firing -----------------------------------------------------------
    def _rng(self, idx: int):
        if self._rngs is None:
            self._rngs = {}
        if idx not in self._rngs:
            import numpy as np
            self._rngs[idx] = np.random.RandomState(
                (self.seed * 1000003 + idx) % (2 ** 32))
        return self._rngs[idx]

    def _marker(self, idx: int) -> str | None:
        if not self.state_dir:
            return None
        return os.path.join(self.state_dir, f"chaos_fault{idx}.fired")

    def _already_fired(self, idx: int) -> bool:
        if self._fired[idx]:
            return True
        marker = self._marker(idx)
        return bool(marker and os.path.exists(marker))

    def _mark_fired(self, idx: int):
        self._fired[idx] += 1
        marker = self._marker(idx)
        if marker:
            try:
                os.makedirs(self.state_dir, exist_ok=True)
                with open(marker, "w") as f:
                    f.write(str(time.time()))
            except OSError:
                pass  # losing the marker degrades to per-process "once"

    def fire(self, site: str, step: int | None = None, batch=None):
        """Consult the plan at ``site``; returns ``batch`` unchanged.
        Raising kinds raise."""
        for idx, f in enumerate(self.faults):
            if f.site != site:
                continue
            if f.rank is not None and f.rank != _this_rank():
                continue
            if f.once and self._already_fired(idx):
                continue
            if f.at_step is not None:
                if step is None or int(step) != f.at_step:
                    continue
            elif self._rng(idx).random_sample() >= f.prob:
                continue
            self._mark_fired(idx)
            _record_fault(site, f.kind, step)
            _execute(f, site, step)
        return batch


def _record_fault(site: str, kind: str, step=None):
    """Emit a flight-recorder event, then count into
    ``metrics.run_stats`` (lazy imports keep the fire() hot path
    import-free)."""
    try:
        from . import events
        events.event("chaos", site=site, kind=kind, step=step)
    except Exception:
        pass
    from .metrics import run_stats
    run_stats.record_fault(site, kind)


def _execute(f: Fault, site: str, step):
    where = f"chaos site={site}" + (f" step={step}" if step is not None
                                    else "")
    if f.kind == "preempt":
        raise InjectedPreemption(
            f"UNAVAILABLE: injected preemption ({where}): device "
            "connection lost")
    if f.kind == "fatal":
        raise InjectedFatal(
            f"INVALID_ARGUMENT: injected program error ({where})")
    if f.kind == "cache_lost":
        raise InjectedCacheLost(
            f"injected slot-cache loss ({where}): KV cache lost to a "
            "failed device call; backend state unrecoverable — engine "
            "must fail over")
    if f.kind == "hang":
        time.sleep(f.hang_s)


# -- process-global active plan ---------------------------------------------
# Hooks call the module-level fire(); the plan comes from an explicit
# install() (in-process tests) or, lazily on first fire, from SPARKDL_CHAOS.
# No plan anywhere = every hook is a cheap no-op.

_ACTIVE: FaultPlan | None = None
_ENV_CHECKED = False


def install(plan: FaultPlan) -> FaultPlan:
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE, _ENV_CHECKED = plan, True
    return plan


def uninstall():
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE, _ENV_CHECKED = None, False


def active_plan() -> FaultPlan | None:
    global _ACTIVE, _ENV_CHECKED
    if _ACTIVE is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        _ACTIVE = FaultPlan.from_env()
    return _ACTIVE


def fire(site: str, step: int | None = None, batch=None):
    """The hook the engine calls at each site; no-op without a plan."""
    plan = active_plan()
    if plan is None:
        return batch
    return plan.fire(site, step=step, batch=batch)
