"""The port's serving fleet (``sparkdl_tpu_torch.serving.router``) held
against the JAX package's.

Three parts, all on the CPU:

- twins of ``tests/test_fleet.py``: each mechanism (radix and round-robin
  placement, affinity, shedding, drain and re-admission, unclean death
  from shadow state, the replica floor, hedging, health states, the fleet
  chaos sites, residency digests, the fleet metrics and the ``/serving``
  view) on the port's ``StubBackend`` replicas, with the reference's
  assertions;
- side by side: one seeded workload through both packages' fleets of
  ``StubBackend`` replicas, with an injected unclean death
  (``replica_dead`` at ``fleet_route``), a doom and either routing
  policy. Tokens, the replica each request was placed on, the health
  transitions (the ``fleet_replica_*`` events, in order) and
  ``fleet.stats`` must be equal;
- a tiny-Llama fleet (``LlamaConfig.tiny()``, f32, the same weights in
  both packages through ``load_flax_params``), paged and unpaged, with one
  unclean death and one doom: the port's streams must equal the
  reference fleet's and a clean single engine's, token for token.

And the import guard: the router, the SLO module and the telemetry plane
import no torch, and loading them initialises no CUDA and loads no jax.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import ast
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash
from sparkdl_tpu.runner import chaos as jchaos
from sparkdl_tpu.runner import events as jevents
from sparkdl_tpu.serving import EngineFleet as JFleet
from sparkdl_tpu.serving import GenerationEngine as JEngine
from sparkdl_tpu.serving import StubBackend as JStub
from sparkdl_tpu_torch.models import llama as L
from sparkdl_tpu_torch.ops import flash_attention as fa
from sparkdl_tpu_torch.runner import chaos, events, failures, telemetry
from sparkdl_tpu_torch.serving import (DEAD, DEGRADED, DOOMED, HEALTHY,
                                       SNAPSHOT_VERSION, EngineFleet,
                                       FleetDegradedError, FleetRequest,
                                       FleetRoutingError, GenerationEngine,
                                       RequestShedError,
                                       SnapshotIncompatibleError,
                                       StubBackend, fleet_debug_state,
                                       serving_snapshot)
from sparkdl_tpu_torch.serving.prefix import (DIGEST_GRANULE, PrefixCache,
                                              RadixPrefixCache,
                                              prompt_digest_chain)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_plans():
    """No chaos plan or armed plane leaks between tests, in either
    package."""
    yield
    chaos.uninstall()
    jchaos.uninstall()
    telemetry.reset()


def _mk(slots=2, max_len=128, *, paged=False, pool_blocks=80, **kw):
    if paged:
        kw.setdefault("block_size", 4)
        kw.setdefault("pool_blocks", pool_blocks)
    be = StubBackend(slots, max_len, vocab_size=997, **kw)
    return GenerationEngine(be, queue_capacity=32)


def _reference(prompt, max_new):
    eng = _mk()
    r = eng.submit(prompt, max_new_tokens=max_new, block=False)
    eng.run_until_idle()
    return r.tokens


# ---------------------------------------------------------------------------
# twins of tests/test_fleet.py
# ---------------------------------------------------------------------------

class TestFleetRouting:
    def test_radix_routes_prefix_family_to_resident_replica(self):
        fleet = EngineFleet([_mk() for _ in range(3)], routing="radix")
        head = list(range(1, 1 + 2 * DIGEST_GRANULE))
        a1 = fleet.submit(head + [500], max_new_tokens=2)
        home = a1.replica
        a2 = fleet.submit(head + [600, 601], max_new_tokens=2)
        assert a2.replica == home
        fleet.run_until_idle()
        assert a1.result(1) and a2.result(1)

    def test_round_robin_comparator_rotates(self):
        fleet = EngineFleet([_mk() for _ in range(2)],
                            routing="round_robin")
        seen = [fleet.submit([i + 1] * 4, max_new_tokens=1).replica
                for i in range(4)]
        fleet.run_until_idle()
        assert seen[0] != seen[1] and seen[:2] == seen[2:]

    def test_session_affinity_pins_replica(self):
        fleet = EngineFleet([_mk() for _ in range(3)])
        first = fleet.submit([1, 2, 3], max_new_tokens=1, session="s1")
        for prompt in ([50, 60], [70, 80, 90]):
            fr = fleet.submit(prompt, max_new_tokens=1, session="s1")
            assert fr.replica == first.replica
        fleet.run_until_idle()

    def test_shed_past_queue_depth_under_burn_is_classified(self):
        fleet = EngineFleet([_mk(slots=1)], shed_queue=1, min_replicas=1)
        for i in range(3):  # 1 in slot, 2 queued — past the depth
            fleet.submit([i + 1, 2], max_new_tokens=4)
        rep = fleet._replicas["replica0"]
        rep.burn.record_outcome(False)  # error budget torched → burn >> 1
        with pytest.raises(RequestShedError) as ei:
            fleet.submit([9, 9], max_new_tokens=2)
        assert failures.classify_exception(ei.value) == "retryable"
        assert fleet.stats["shed"] == 1
        fleet.run_until_idle()
        assert fleet.stats["completed"] == 3

    def test_unknown_routing_policy_rejected(self):
        with pytest.raises(ValueError):
            EngineFleet([_mk()], routing="random")


class TestFleetFailover:
    @pytest.mark.parametrize("paged", [False, True])
    def test_doom_drain_readmits_token_identical(self, paged):
        fleet = EngineFleet([_mk(paged=paged) for _ in range(2)],
                            min_replicas=1)
        prompt = list(range(1, 20))
        streamed = []
        fr = fleet.submit(prompt, max_new_tokens=12,
                          stream_cb=lambda fr, t: streamed.append(t))
        for _ in range(3):
            fleet.step()
        pre = list(streamed)
        assert pre, "expected tokens streamed before the drain"
        victim = fr.replica
        fleet.doom_replica(victim, "test")
        fleet.run_until_idle()
        assert fr.result(1) == _reference(prompt, 12)
        assert streamed == fr.tokens  # zero dup, zero loss
        assert streamed[:len(pre)] == pre
        assert fr.hops == 1 and fr.replica != victim
        assert fleet.replica_state(victim) in (DOOMED, DEAD)
        assert fleet.stats["readmissions"] == 1

    def test_unclean_death_readmits_from_shadow_state(self):
        fleet = EngineFleet([_mk() for _ in range(3)])
        prompt = list(range(5, 40))
        streamed = []
        fr = fleet.submit(prompt, max_new_tokens=10,
                          stream_cb=lambda fr, t: streamed.append(t))
        for _ in range(4):
            fleet.step()
        assert streamed
        victim = fr.replica
        fleet.kill_replica(victim)
        fleet.run_until_idle()
        assert fr.result(1) == _reference(prompt, 10)
        assert streamed == fr.tokens
        assert fleet.replica_state(victim) == DEAD
        assert fleet.stats["replica_deaths"] == 1
        assert fleet.stats["readmissions"] == 1

    def test_min_replicas_floor_fails_closed_classified(self):
        fleet = EngineFleet([_mk() for _ in range(2)], min_replicas=2)
        fleet.kill_replica("replica0")
        with pytest.raises(FleetDegradedError) as ei:
            fleet.submit([1, 2], max_new_tokens=2)
        assert "SPARKDL_FLEET_MIN_REPLICAS" in str(ei.value)
        assert failures.classify_exception(ei.value) == "retryable"
        assert failures.classify_text(
            f"FleetDegradedError: {ei.value}") == "retryable"

    def test_double_drain_and_empty_fleet_idempotent(self):
        fleet = EngineFleet([_mk() for _ in range(2)], min_replicas=0)
        fr = fleet.submit([1, 2, 3], max_new_tokens=4)
        assert fleet.drain() == 2
        assert fleet.drain() == 0  # second drain: nothing left to drain
        fleet.doom_replica("replica0")  # doom-after-drain: no-op
        assert fr.state == "failed"  # no survivor existed to re-admit on
        assert isinstance(fr.error, FleetDegradedError)
        empty = EngineFleet([], min_replicas=0)
        assert empty.drain() == 0 and empty.drain() == 0

    def test_readmission_cascade_respects_floor(self):
        fleet = EngineFleet([_mk(slots=1) for _ in range(2)],
                            min_replicas=1)
        frs = [fleet.submit([i + 1, 3], max_new_tokens=64)
               for i in range(3)]
        fleet.step()
        fleet.doom_replica("replica0")
        fleet.doom_replica("replica1")
        fleet.run_until_idle()
        for fr in frs:
            assert fr.done and fr.state == "failed"
            assert isinstance(fr.error, FleetDegradedError)


class TestSnapshotPortability:
    def test_snapshot_dict_resumes_on_foreign_engine(self):
        eng = _mk()
        r = eng.submit([3, 1, 4, 1, 5], max_new_tokens=10, block=False)
        eng.run_until_idle()
        half = r.snapshot()
        half["tokens"] = half["tokens"][:4]
        half["delivered"] = 4
        other = _mk()
        r2 = other.resume(half)
        other.run_until_idle()
        assert r2.tokens == r.tokens  # regrown tail identical
        assert r2.delivered == 10

    def test_stale_version_rejected_classified(self):
        eng = _mk()
        r = eng.submit([1, 2], max_new_tokens=2, block=False)
        eng.run_until_idle()
        snap = r.snapshot()
        snap["version"] = SNAPSHOT_VERSION + 1
        other = _mk()
        with pytest.raises(SnapshotIncompatibleError) as ei:
            other.resume(snap)
        assert failures.classify_exception(ei.value) == "fatal"

    @pytest.mark.parametrize("mutate", [
        lambda s: s.pop("prompt"),
        lambda s: s.update(prompt=[]),
        lambda s: s.update(delivered=10 ** 6),
        lambda s: s.update(delivered=-1),
    ])
    def test_foreign_or_corrupt_snapshot_rejected(self, mutate):
        eng = _mk()
        r = eng.submit([1, 2], max_new_tokens=2, block=False)
        eng.run_until_idle()
        snap = r.snapshot()
        mutate(snap)
        with pytest.raises(SnapshotIncompatibleError):
            _mk().resume(snap)

    def test_resume_onto_small_pool_waits_fifo_not_reject(self):
        src = _mk(paged=True)
        r = src.submit(list(range(1, 10)), max_new_tokens=8, block=False)
        for _ in range(4):
            src.step()
        snaps = src.drain(timeout=5)
        assert any(s is r for s in snaps)
        dst = GenerationEngine(StubBackend(2, 64, vocab_size=997,
                                           block_size=4, pool_blocks=10),
                               queue_capacity=8)
        hog = dst.submit(list(range(40, 57)), max_new_tokens=6,
                         block=False)
        dst.step()
        r2 = dst.resume(r)
        assert r2.state == "queued"  # admitted, not RequestRejected
        dst.run_until_idle()
        assert hog.result(1)
        assert r2.result(1) == _reference(list(range(1, 10)), 8)


class TestHedging:
    def test_hedge_fires_on_degraded_primary_loser_cancelled(self):
        fleet = EngineFleet([_mk() for _ in range(2)],
                            hedge_ttft_s=0.01)
        prompt = [7, 7, 7]
        fr = fleet.submit(prompt, max_new_tokens=6)
        primary = fr.replica
        fleet._replicas[primary].burn.record_outcome(False)  # DEGRADED
        time.sleep(0.03)
        fleet._tick()  # health transition + hedge arm
        assert fleet.stats["hedges_fired"] == 1
        assert fr.hedges == 1
        fleet.run_until_idle()
        assert fr.result(1) == _reference(prompt, 6)
        assert fr.delivered == len(fr.tokens) == 6  # cursor audit
        stats = [fleet.engine(n).stats for n in fleet.replica_names()]
        assert sum(s["quarantined"] for s in stats) == 0
        assert sum(s["cancelled"] for s in stats) == 1  # the loser
        assert fleet.stats["failed"] == 0

    def test_no_hedge_when_disabled_or_healthy(self):
        fleet = EngineFleet([_mk() for _ in range(2)], hedge_ttft_s=0.0)
        fr = fleet.submit([1, 2], max_new_tokens=4)
        time.sleep(0.02)
        fleet._tick()
        assert fleet.stats["hedges_fired"] == 0
        fleet.run_until_idle()
        assert fr.result(1)


class TestHealthStates:
    def test_burn_degrades_then_cooldown_recovers(self):
        fleet = EngineFleet([_mk() for _ in range(2)])
        rep = fleet._replicas["replica0"]
        rep.burn.record_outcome(False)
        fleet._tick()
        assert rep.state == DEGRADED
        rep.burn.window_s = 0.001
        rep.t_state -= 10.0
        time.sleep(0.005)
        fleet._tick()
        assert rep.state == HEALTHY

    def test_circuit_breaker_dooms_after_consecutive_failures(self):
        fleet = EngineFleet([_mk() for _ in range(2)],
                            breaker_failures=2, min_replicas=1)
        rep = fleet._replicas["replica0"]
        rep.consecutive_failures = 2
        fleet._tick()
        assert rep.state in (DOOMED, DEAD) or rep.drained
        assert fleet.replicas_healthy == 1

    def test_fatal_engine_goes_dead(self):
        fleet = EngineFleet([_mk() for _ in range(2)])
        fleet.engine("replica1")._fatal = RuntimeError("device gone")
        fleet._tick()
        assert fleet.replica_state("replica1") == DEAD
        assert fleet.replicas_healthy == 1


class TestFleetChaos:
    def test_replica_dead_requires_fleet_site(self):
        with pytest.raises(ValueError):
            chaos.Fault(site="serve_prefill", kind="replica_dead",
                        at_step=1)
        f = chaos.Fault(site="fleet_route", kind="replica_dead",
                        at_step=1)
        assert f.site in chaos.FLEET_SITES

    def test_injected_replica_dead_at_route_kills_chosen_replica(self):
        chaos.install(chaos.FaultPlan([
            chaos.Fault(site="fleet_route", kind="replica_dead",
                        at_step=2)]))
        fleet = EngineFleet([_mk() for _ in range(3)])
        a = fleet.submit([1, 2], max_new_tokens=2)
        b = fleet.submit([3, 4], max_new_tokens=2)  # fires here
        fleet.run_until_idle()
        assert a.result(1) and b.result(1)
        assert fleet.stats["replica_deaths"] == 1
        assert fleet.replicas_healthy == 2
        assert failures.classify_exception(
            chaos.InjectedReplicaDead("x")) == "retryable"


class TestResidencyDigest:
    def test_lru_cache_digest_matches_prompt_chain(self):
        pc = PrefixCache(budget_bytes=1 << 20)
        prompt = list(range(1, 50))
        pc.put(tuple(prompt[:32]), payload=None, nbytes=64)
        dig = pc.residency_digest()
        assert dig["granule"] == DIGEST_GRANULE
        chain = prompt_digest_chain(prompt, dig["granule"])
        hits = [n for n, h in chain if h in dig["heads"]]
        assert hits == [16, 32]  # both whole granules of the entry

    def test_radix_digest_walks_trie(self):
        from sparkdl_tpu_torch.serving import BlockAllocator
        alloc = BlockAllocator(64)
        rx = RadixPrefixCache(alloc, block_size=4)
        toks = tuple(range(1, 13))
        blocks = alloc.allocate(3)
        rx.insert(toks, blocks)
        dig = rx.residency_digest()
        assert dig["granule"] == 4
        chain = prompt_digest_chain(list(toks) + [99], 4)
        assert [n for n, h in chain if h in dig["heads"]] == [4, 8, 12]

    def test_engine_exposes_backend_digest(self):
        eng = _mk()  # unpaged stub carries a PrefixCache
        r = eng.submit(list(range(1, 40)), max_new_tokens=2, block=False)
        eng.run_until_idle()
        assert r.result(1)
        dig = eng.residency_digest()
        assert dig is not None and dig["heads"]


class TestFleetObservability:
    def test_fleet_metrics_reach_registry(self):
        telemetry.reset()
        telemetry.start()
        fleet = EngineFleet([_mk() for _ in range(2)])
        fr = fleet.submit(list(range(1, 12)), max_new_tokens=8)
        fleet.step()
        fleet.kill_replica(fr.replica)
        fleet.run_until_idle()
        assert fr.result(1)
        snap = telemetry.registry().snapshot()
        assert snap["gauges"]["fleet_replicas_healthy"]["value"] >= 1
        assert snap["counters"]["fleet_readmissions_total"] >= 1

    def test_serving_snapshot_carries_fleet_view(self):
        fleet = EngineFleet([_mk() for _ in range(2)])
        fr = fleet.submit([1, 2, 3], max_new_tokens=2)
        fleet.run_until_idle()
        assert fr.result(1)
        state = fleet_debug_state(fleet)
        assert set(state["replicas"]) == {"replica0", "replica1"}
        for row in state["replicas"].values():
            assert row["state"] == HEALTHY
            assert "shadow_heads" in row and "burn" in row
        snap = serving_snapshot()
        assert snap["n_fleets"] >= 1
        assert any(f.get("stats", {}).get("completed", 0) >= 1
                   for f in snap["fleets"] if "error" not in f)

    def test_fleet_request_repr_and_cancel(self):
        fleet = EngineFleet([_mk()], min_replicas=1)
        fr = fleet.submit([1, 2, 3], max_new_tokens=50)
        assert isinstance(fr, FleetRequest)
        assert "FleetRequest" in repr(fr)
        fr.cancel()
        fleet.run_until_idle()
        assert fr.done and fr.state == "failed"
        assert fleet.stats["cancelled"] == 1
        assert fleet.stats["failed"] == 0
        assert fleet.engine("replica0").stats["quarantined"] == 0

    def test_routing_error_when_every_replica_rejects(self):
        """A request no replica can ever hold (longer than every
        ``max_len``) fails with the classified, fatal routing error."""
        fleet = EngineFleet([_mk(max_len=16) for _ in range(2)])
        with pytest.raises(FleetRoutingError) as ei:
            fleet.submit(list(range(1, 40)), max_new_tokens=4)
        assert failures.classify_exception(ei.value) == "fatal"


# ---------------------------------------------------------------------------
# side by side: the same seeded workload through both packages' fleets
# ---------------------------------------------------------------------------

def _workload(seed=15, n=12, families=3):
    """Prompts in prefix families of 32-token heads, tails drawn from
    ``seed``."""
    rng = np.random.RandomState(seed)
    heads = [rng.randint(1, 900, 2 * DIGEST_GRANULE).tolist()
             for _ in range(families)]
    return [heads[i % families]
            + rng.randint(1, 900, rng.randint(1, 20)).tolist()
            for i in range(n)]


def _drive(fleet_cls, engine_cls, stub_cls, chaos_mod, events_mod, *,
           routing, paged, kill_at, doom_after, n_replicas=3):
    """Submit half the workload, step, submit the rest (the ``kill_at``-th
    routing decision kills, uncleanly, the replica it would have chosen,
    mid-stream), step, doom the busiest replica, run to idle; return
    (tokens, placements, final replicas, hops, transitions, stats)."""
    seen = []

    def tee(rec):
        if str(rec.get("name", "")).startswith("fleet_"):
            seen.append((rec["name"], rec.get("replica"),
                         rec.get("request")))

    kw = dict(block_size=4, pool_blocks=120) if paged else {}
    engines = [engine_cls(stub_cls(3, 160, vocab_size=997, **kw),
                          queue_capacity=32) for _ in range(n_replicas)]
    chaos_mod.install(chaos_mod.FaultPlan([chaos_mod.Fault(
        site="fleet_route", kind="replica_dead", at_step=kill_at)]))
    events_mod.add_tee(tee)
    try:
        fleet = fleet_cls(engines, routing=routing, min_replicas=1)
        prompts = _workload()
        half = len(prompts) // 2
        frs = [fleet.submit(p, max_new_tokens=10) for p in prompts[:half]]
        for _ in range(doom_after):
            fleet.step()
        frs += [fleet.submit(p, max_new_tokens=10) for p in prompts[half:]]
        placed = [fr.replica for fr in frs]
        for _ in range(doom_after):
            fleet.step()
        live = [n for n in fleet.replica_names()
                if fleet.replica_state(n) == HEALTHY]
        busiest = max(live, key=lambda n: (fleet._replicas[n].load(), n))
        fleet.doom_replica(busiest, "test")
        fleet.run_until_idle()
        out = ([fr.result(1) for fr in frs], placed,
               [fr.replica for fr in frs], [fr.hops for fr in frs],
               seen, dict(fleet.stats))
    finally:
        events_mod.remove_tee(tee)
        chaos_mod.uninstall()
    return out


@pytest.mark.parametrize("routing,paged", [
    ("radix", False), ("radix", True), ("round_robin", False)])
def test_stub_fleet_matches_reference_fleet(routing, paged):
    """Kill (injected at the 8th routing decision), doom, and the same
    workload: the port's fleet makes the reference fleet's decisions,
    request by request, and its streams equal a clean engine's."""
    kw = dict(routing=routing, paged=paged, kill_at=8, doom_after=3)
    got = _drive(EngineFleet, GenerationEngine, StubBackend, chaos, events,
                 **kw)
    want = _drive(JFleet, JEngine, JStub, jchaos, jevents, **kw)
    tokens, placed, final, hops, transitions, stats = got
    assert tokens == want[0]
    assert placed == want[1]
    assert final == want[2]
    assert hops == want[3]
    assert transitions == want[4]
    assert stats == want[5]
    assert stats["replica_deaths"] == 1 and stats["drains"] == 1
    assert stats["readmissions"] >= 1
    assert stats["completed"] == len(_workload())
    names = [t[0] for t in transitions]
    assert "fleet_replica_dead" in names and \
        "fleet_replica_doomed" in names
    for p, toks in zip(_workload(), tokens):
        assert toks == _reference(p, 10)


def test_radix_reuse_beats_round_robin_in_both_packages():
    """The reference's own check (radix placement keeps each family's
    head resident on one replica): fleet-wide prefix hits under radix
    routing exceed round-robin's, by the same counts in both packages."""
    def hits(fleet_cls, engine_cls, stub_cls, routing):
        engines = [engine_cls(stub_cls(3, 160, vocab_size=997),
                              queue_capacity=32) for _ in range(3)]
        fleet = fleet_cls(engines, routing=routing)
        frs = []
        for p in _workload(n=16, families=4):
            frs.append(fleet.submit(p, max_new_tokens=2))
            fleet.step()
        fleet.run_until_idle()
        assert all(fr.result(1) for fr in frs)
        return sum(e.snapshot()["prefix_cache"]["hits"] for e in engines)

    ours = {r: hits(EngineFleet, GenerationEngine, StubBackend, r)
            for r in ("radix", "round_robin")}
    ref = {r: hits(JFleet, JEngine, JStub, r)
           for r in ("radix", "round_robin")}
    assert ours == ref
    assert ours["radix"] > ours["round_robin"]


# ---------------------------------------------------------------------------
# tiny Llama: the port's fleet against the reference fleet and one engine
# ---------------------------------------------------------------------------

MAX_LEN, NEW = 128, 8


@pytest.fixture(scope="module")
def models():
    jm = JL.LlamaModel(JL.LlamaConfig.tiny(), attn_fn=jax_flash)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    tm = L.load_flax_params(L.LlamaModel(L.LlamaConfig.tiny(),
                                         attn_fn=fa.flash_attention,
                                         device="cpu"), params)
    return jm, params, tm


def _llama_prompts():
    """A family of four prompts on one 16-token head, and two others."""
    rng = np.random.RandomState(15)
    head = rng.randint(1, 512, 16).tolist()
    return [head + rng.randint(1, 512, n).tolist() for n in (3, 9, 5, 4)] \
        + [rng.randint(1, 512, n).tolist() for n in (7, 12)]


def _llama_fleet(make, fleet_cls, chaos_mod):
    """Three replicas. The family's first three requests stream for four
    steps on their home replica; then the family's fourth routing
    decision kills that replica uncleanly (its requests re-admit from the
    router's shadow state, mid-stream), and two steps later the busiest
    survivor is doomed (drained and re-admitted)."""
    chaos_mod.install(chaos_mod.FaultPlan([chaos_mod.Fault(
        site="fleet_route", kind="replica_dead", at_step=4)]))
    try:
        fleet = fleet_cls([make() for _ in range(3)], min_replicas=1)
        prompts = _llama_prompts()
        frs = [fleet.submit(p, max_new_tokens=NEW) for p in prompts[:3]]
        for _ in range(4):
            fleet.step()
        streamed = [fr.delivered for fr in frs]
        frs += [fleet.submit(p, max_new_tokens=NEW) for p in prompts[3:]]
        fleet.step()
        fleet.step()
        live = [n for n in fleet.replica_names()
                if fleet.replica_state(n) == HEALTHY]
        fleet.doom_replica(max(live, key=lambda n: (
            fleet._replicas[n].load(), n)), "test")
        fleet.run_until_idle()
        return ([fr.result(1) for fr in frs], dict(fleet.stats),
                streamed, [fr.hops for fr in frs])
    finally:
        chaos_mod.uninstall()


@pytest.mark.parametrize("paged", [False, True])
def test_llama_fleet_matches_reference_and_clean_engine(models, paged):
    jm, params, tm = models
    kw = dict(num_slots=3, max_len=MAX_LEN)
    if paged:
        kw.update(block_size=8, prefill_chunk=8)
    got, stats, streamed, hops = _llama_fleet(
        lambda: GenerationEngine.from_model(tm, device="cpu", **kw),
        EngineFleet, chaos)
    want, jstats, jstreamed, jhops = _llama_fleet(
        lambda: JEngine.from_model(jm, {"params": params}, **kw),
        JFleet, jchaos)
    clean = GenerationEngine.from_model(tm, device="cpu", **kw)
    hs = [clean.submit(p, max_new_tokens=NEW) for p in _llama_prompts()]
    clean.run_until_idle()
    assert got == want
    assert got == [h.result(1) for h in hs]
    assert (stats, streamed, hops) == (jstats, jstreamed, jhops)
    assert stats["replica_deaths"] == 1 and stats["drains"] == 1
    # the family's home replica died mid-stream: its requests hopped
    assert max(streamed) > 0 and min(hops[:3]) >= 1, (streamed, hops)


# ---------------------------------------------------------------------------
# import guards
# ---------------------------------------------------------------------------

def test_fleet_modules_import_no_torch():
    """router.py, slo.py and telemetry.py are stdlib copies: no torch, no
    jax, nothing of the JAX package among their imports."""
    for rel in ("serving/router.py", "runner/slo.py", "runner/telemetry.py"):
        tree = ast.parse((ROOT / "sparkdl_tpu_torch" / rel).read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.add(node.module.split(".")[0])
        assert not names & {"torch", "jax", "jaxlib", "flax",
                            "sparkdl_tpu"}, (rel, names)


def test_fleet_modules_load_no_cuda_and_no_jax():
    """In a fresh interpreter, importing the router, the SLO module and
    the telemetry plane (and driving a Stub fleet through them) neither
    initialises CUDA nor loads jax."""
    code = (
        "import sys\n"
        "import sparkdl_tpu_torch.serving.router as R\n"
        "import sparkdl_tpu_torch.runner.slo, "
        "sparkdl_tpu_torch.runner.telemetry as T\n"
        "from sparkdl_tpu_torch.serving import GenerationEngine, "
        "StubBackend\n"
        "T.start()\n"
        "f = R.EngineFleet([GenerationEngine(StubBackend(2, 64)) "
        "for _ in range(2)])\n"
        "h = f.submit([1, 2, 3], max_new_tokens=4)\n"
        "f.run_until_idle()\n"
        "assert h.result(1)\n"
        "T.stop()\n"
        "torch = sys.modules.get('torch')\n"
        "print(torch is not None and torch.cuda.is_initialized(), "
        "sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'sparkdl_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False []", out.stdout
