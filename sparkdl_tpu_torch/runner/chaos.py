"""Deterministic fault injection at the runner's, the data plane's, the
serving engine's, the fleet router's and the image scorer's sites.

The port's copy of ``sparkdl_tpu/runner/chaos.py``. A seeded
:class:`FaultPlan` injects faults at named **sites**; plans serialize to
one env var (``SPARKDL_CHAOS``), so a process launched with the plan in
its environment picks it up with no change to its code. Every fired fault
lands in the flight recorder (a ``chaos`` event, before the fault acts)
and counts into ``runner.metrics.run_stats``.

Sites (where the code consults the plan):

- ``step_start``       — the top of each step of ``RunnerContext.fit``
  (exercises ``run_with_restarts`` and checkpoint resume)
- ``batch_fetch``      — after ``fit`` draws a host batch (``nan`` poisons
  it); the hook's step is the TRAIN step
- ``data_fetch``       — inside ``CheckpointableDataset.indexed()``
  (``runner/data.py``) as each batch is drawn; the hook's step is the
  dataset's BATCH INDEX, so a fault can target one batch across restarts
- ``checkpoint_save``  — inside ``CheckpointManager.save``
- ``checkpoint_restore`` — the entry of ``CheckpointManager.restore``
  (``corrupt`` damages the newest step on disk here)
- ``collective``       — the entry of the hvd-compat ``allreduce`` /
  ``broadcast`` (``runner/api.py``)
- ``worker``           — the entry of ``XlaRunner.run``
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
- ``fleet_route``      — one client routing decision of
  ``serving.router.EngineFleet.submit``
- ``fleet_drain``      — the entry of a DOOMED replica's drain

Kinds (what happens when a fault fires):

- ``preempt`` — raise a retryable ``UNAVAILABLE``/preemption-shaped error
- ``fatal``   — raise an ``INVALID_ARGUMENT``-shaped program error (no retry)
- ``nan``     — fill the batch's float leaves (numpy arrays or tensors,
  on the host or the card) with NaN (``batch_fetch`` only; exercises the
  train loop's divergence guard); integer leaves (ids, labels) pass
- ``poison``  — the deterministic poison record: NaN the batch's float
  leaves, or raise ``InjectedFatal`` when it has none to poison
  (``data_fetch`` / ``batch_fetch``). With ``once=False`` the same batch
  re-poisons on every restart; ``nan`` + ``once`` models a one-off flake
- ``hang``    — sleep ``hang_s`` (exercises a stall watchdog)
- ``sigkill`` — ``SIGKILL`` the calling process
- ``corrupt`` — truncate and bit-flip the newest checkpoint under the
  site's ``path`` (``checkpoint_restore`` only; exercises manifest
  verification and the rollback to the newest verified step)
- ``decimate`` — ``SIGKILL`` the calling process AND leave a persistent
  per-``(rank, world size)`` death marker in the plan's ``state_dir``:
  the rank's slot stays dead, so every later attempt at the same world
  size re-kills it at its first ``fire()`` (a machine that does not come
  back). A relaunch at another world size is a fresh allocation, to which
  the marker does not apply; without a ``state_dir`` it is a plain
  ``sigkill``
- ``cache_lost`` — raise a serving-fatal ``InjectedCacheLost`` shaped like
  the slot-cache loss ``serving/backend.py`` converts real device
  failures into (``SlotCacheLost``): the slot KV cache is gone, retrying
  the call cannot help, and the engine must fail over (snapshot live
  requests, rebuild the backend, re-admit). This is how the failover path
  is exercised on the CPU, where no device call fails.
- ``replica_dead`` — raise ``InjectedReplicaDead`` at a fleet site: the
  fleet router kills the replica uncleanly (no drain) and re-admits its
  in-flight requests from its own shadow state on the survivors.

Triggers are deterministic: ``at_step=N`` fires when the hook's step equals
N; ``prob=p`` draws from a per-fault ``RandomState`` seeded from
``(plan.seed, fault index)`` so two identically-seeded plans fire
identically. ``once=True`` (default) fires at most once — and when the plan
carries a ``state_dir``, "once" persists across process restarts via marker
files. ``decimate`` inverts that: its marker makes the fault KEEP firing.

Import surface: stdlib (numpy for the ``prob`` coin and numpy batches,
torch only to poison a tensor batch, both imported when used).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import time

__all__ = ["Fault", "FaultPlan", "InjectedFault", "InjectedPreemption",
           "InjectedFatal", "InjectedCacheLost", "InjectedReplicaDead",
           "SITES", "SERVING_SITES", "FLEET_SITES", "KINDS",
           "CHAOS_ENV", "CHAOS_INJECTED_MARKER", "fire", "install",
           "uninstall", "active_plan", "announce_injection",
           "corrupt_latest_checkpoint"]

CHAOS_ENV = "SPARKDL_CHAOS"

SERVING_SITES = ("serve_prefill", "serve_decode", "serve_alloc",
                 "serve_commit")
FLEET_SITES = ("fleet_route", "fleet_drain")
SITES = ("step_start", "checkpoint_save", "batch_fetch", "collective",
         "worker", "decode", "dispatch", "checkpoint_restore",
         "data_fetch") + SERVING_SITES + FLEET_SITES
KINDS = ("preempt", "fatal", "nan", "hang", "sigkill", "corrupt", "poison",
         "decimate", "cache_lost", "replica_dead")


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


class InjectedReplicaDead(InjectedFault):
    """A whole serving replica died UNCLEANLY: no drain, no snapshots,
    engine unusable. Retryable AT THE FLEET TIER only — the router
    re-admits the replica's in-flight requests from its shadow state on
    the survivors; nothing below the router can recover from this."""


# The one announcement string for DELIBERATE fault injection in a
# measurement or dry-run leg: a reader of the captured output separates
# injected faults from real failures by it (announce_injection is the
# single definition).
CHAOS_INJECTED_MARKER = "[chaos-injected]"


def announce_injection(what: str = "a deliberate retryable failure"):
    """Print the standard fault-injection announcement to stderr — call
    it just before raising an injected failure in a measurement leg, so
    the captured tail never reads the restart as a real regression."""
    print(f"{CHAOS_INJECTED_MARKER} raising {what} (fault-injection "
          f"leg — the restart below is EXPECTED)", file=sys.stderr)


def _this_rank() -> int:
    return int(os.environ.get("SPARKDL_PROCESS_ID", "0"))


def _this_world() -> int:
    try:
        return int(os.environ.get("SPARKDL_NUM_PROCESSES", "1"))
    except ValueError:
        return 1


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injection: fire ``kind`` at ``site`` when the trigger matches.

    Exactly one trigger: ``at_step`` (fire when the hook's step == N; for
    stepless sites like ``worker``/``collective`` use ``prob=1.0``) or
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
        if self.kind == "nan" and self.site != "batch_fetch":
            raise ValueError("kind='nan' only poisons batches — use "
                             "site='batch_fetch'")
        if self.kind == "poison" and self.site not in ("data_fetch",
                                                       "batch_fetch"):
            raise ValueError("kind='poison' poisons drawn batches — use "
                             "site='data_fetch' (batch-index targeted) or "
                             "'batch_fetch'")
        if self.kind == "corrupt" and self.site != "checkpoint_restore":
            raise ValueError("kind='corrupt' damages on-disk checkpoints — "
                             "use site='checkpoint_restore'")
        if self.kind == "cache_lost" and self.site not in SERVING_SITES:
            raise ValueError("kind='cache_lost' models a lost slot cache "
                             "— use a serving site: "
                             f"{SERVING_SITES}")
        if self.kind == "replica_dead" and self.site not in FLEET_SITES:
            raise ValueError("kind='replica_dead' kills a whole serving "
                             "replica — only the fleet router can "
                             f"survive it; use a fleet site: {FLEET_SITES}")
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

    # -- decimate: persistent dead-slot markers ---------------------------
    def decimate_marker(self, rank: int,
                        world: int | None = None) -> str | None:
        """Path of the dead-slot marker for ``rank`` within a ``world``-
        sized allocation (None without a ``state_dir``). Scoped to the
        world size, not just the rank: a relaunch at another size is a
        fresh allocation, whose rank of the same number is a different,
        healthy slot. Deleting the file models recovered capacity."""
        if not self.state_dir:
            return None
        world = _this_world() if world is None else int(world)
        return os.path.join(self.state_dir,
                            f"chaos_decimated_rank{rank}_np{world}")

    def _slot_decimated(self) -> bool:
        marker = self.decimate_marker(_this_rank())
        return bool(marker and os.path.exists(marker))

    def _mark_decimated(self):
        marker = self.decimate_marker(_this_rank())
        if marker:
            try:
                os.makedirs(self.state_dir, exist_ok=True)
                with open(marker, "w") as f:
                    f.write(str(time.time()))
            except OSError:
                pass  # no marker: decimate degrades to a one-off sigkill

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

    def fire(self, site: str, step: int | None = None, batch=None,
             path: str | None = None):
        """Consult the plan at ``site``; returns ``batch`` (poisoned by
        ``nan`` / ``poison``). Raising kinds raise; ``sigkill`` and
        ``decimate`` do not return. ``path``: the site's directory (the
        checkpoint directory at ``checkpoint_restore``, where ``corrupt``
        damages the newest step).

        A ``decimate`` dead-slot marker makes the kill RECUR: any
        ``fire()`` (whatever its site or trigger) from a rank whose slot
        is marked dead at the current world size kills the process at
        once."""
        if any(f.kind == "decimate" for f in self.faults) \
                and self._slot_decimated():
            # this slot died at this world size and never came back: the
            # process must not run even one step
            _record_fault(site, "decimate", step)
            sys.stdout.flush()
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        out = batch
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
            if f.kind == "decimate":
                # marker BEFORE the kill: the slot must read as dead to
                # every later attempt though SIGKILL never returns
                self._mark_decimated()
            _record_fault(site, f.kind, step)
            out = _execute(f, site, step, out, path=path)
        return out


def _record_fault(site: str, kind: str, step=None):
    """Emit a flight-recorder event, then count into
    ``metrics.run_stats`` (lazy imports keep the fire() hot path
    import-free). The event goes FIRST: with ``SPARKDL_EVENT_DIR`` set
    its line is on disk (line-buffered) before ``_execute`` can kill the
    process."""
    try:
        from . import events
        events.event("chaos", site=site, kind=kind, step=step)
    except Exception:
        pass
    try:
        from .metrics import run_stats
        run_stats.record_fault(site, kind)
    except Exception:
        pass


def _execute(f: Fault, site: str, step, batch, path: str | None = None):
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
    if f.kind == "replica_dead":
        raise InjectedReplicaDead(
            f"injected replica death ({where}): the replica is gone "
            "uncleanly — no drain possible; the fleet router must "
            "re-admit its in-flight requests from shadow state")
    if f.kind == "nan":
        return _poison(batch)
    if f.kind == "poison":
        poisoned = _poison(batch)
        if batch is None or poisoned is batch:
            # nothing to NaN (no batch / no float leaves): the poison
            # record must still kill the step deterministically
            raise InjectedFatal(
                f"INVALID_ARGUMENT: injected poison batch ({where})")
        return poisoned
    if f.kind == "hang":
        time.sleep(f.hang_s)
        return batch
    if f.kind in ("sigkill", "decimate"):
        sys.stdout.flush()
        sys.stderr.flush()
        os.kill(os.getpid(), signal.SIGKILL)
    if f.kind == "corrupt":
        corrupt_latest_checkpoint(path)
    return batch


def corrupt_latest_checkpoint(directory: str | None) -> list[str]:
    """Damage the newest step under ``directory`` as a kill in the middle
    of a write or bit rot would: the largest file bit-flipped at its middle
    and truncated to 3/4 of its length. Returns the damaged paths (empty
    when there is nothing to damage — a ``corrupt`` fault firing before
    the first save must not crash the restore it exercises).
    ``checkpoint.corrupt_latest_checkpoint`` is this function."""
    if not directory:
        return []
    try:
        steps = [d for d in os.listdir(directory)
                 if d.isdigit() and os.path.isdir(os.path.join(directory, d))]
    except OSError:
        return []
    if not steps:
        return []
    step_dir = os.path.join(directory, max(steps, key=int))
    files = []
    for root, _, names in os.walk(step_dir):
        for name in names:
            p = os.path.join(root, name)
            try:
                files.append((os.path.getsize(p), p))
            except OSError:
                continue
    files = [(s, p) for s, p in files if s > 0]
    if not files:
        return []
    size, victim = max(files)
    try:
        with open(victim, "r+b") as fh:
            fh.seek(size // 2)
            b = fh.read(1)
            fh.seek(size // 2)
            fh.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
            fh.truncate(max(1, size * 3 // 4))
    except OSError:
        return []
    return [victim]


def _poison(batch):
    """NaN every float leaf of a batch (a dict/list/tuple tree of numpy
    arrays or tensors, wherever the tensors lie); integer leaves (labels,
    ids) pass through untouched. Returns ``batch`` itself (same identity)
    when there was no float leaf to poison, so the ``poison`` kind can
    tell "nothing happened" and raise instead."""
    import numpy as np
    changed = False

    def rec(x):
        nonlocal changed
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: rec(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rec(v) for v in x)
        if type(x).__module__.startswith("torch"):
            import torch
            if torch.is_tensor(x) and x.is_floating_point():
                changed = True
                return torch.full_like(x, float("nan"))
            return x
        arr = np.asarray(x)
        if np.issubdtype(arr.dtype, np.floating):
            changed = True
            return np.full_like(arr, np.nan)
        return x

    out = rec(batch)
    return out if changed else batch


# -- process-global active plan ---------------------------------------------
# Hooks call the module-level fire(); the plan comes from an explicit
# install() (in-process tests) or, lazily on first fire, from SPARKDL_CHAOS
# (launched workers).
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


def fire(site: str, step: int | None = None, batch=None,
         path: str | None = None):
    """The hook the code calls at each site; no-op without a plan."""
    plan = active_plan()
    if plan is None:
        return batch
    return plan.fire(site, step=step, batch=batch, path=path)
