"""A fleet whose replicas are tensor-parallel groups in other processes
(``serving.remote``), on the CPU.

One gang of 4 gloo ranks (``tests/torch_tp_worker.py``, mode ``fleet``,
``OMP_NUM_THREADS=1``, launched from a thread of this process, started
once for the module) forms two tp = 2 groups of consecutive ranks. Rank
0 of each group serves this process's ``EngineFleet`` over a host channel
(``FrontServer``), round after round, a fresh engine each round: a clean
round with a cancel, a round whose group ``a`` is drained mid-stream, a
round whose group ``b`` drops its channel mid-stream. The tiny Llama's
flax variables are the reference tests' (``_tiny_model``), carried across.
The reference is the JAX package's ``EngineFleet`` over two
``GenerationEngine.from_model(tp=2)`` engines on the conftest's virtual
devices [0, 1] and [2, 3], started the same way, and its static
``generate()``.

Tolerances: none — greedy tokens are compared for equality.

Beside the gang, fast tests hold the proxy over a real loopback channel
to a one-process engine (``StubBackend``): backpressure and rejections
reach the router's placement, a silent channel makes the replica DEAD,
cancels and drains cross the channel, and inline drive is refused.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json
import os
import threading
import time
from multiprocessing.connection import Listener
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import llama as JL
from sparkdl_tpu.serving import EngineFleet as JFleet
from sparkdl_tpu.serving import GenerationEngine as JEngine
from sparkdl_tpu.serving.backend import tp_mesh as jtp_mesh
from sparkdl_tpu_torch.runner import launcher
from sparkdl_tpu_torch.serving import (DEAD, EngineFleet, EngineStopped,
                                       FleetDegradedError, FleetRoutingError,
                                       GenerationEngine, QueueFullError,
                                       RequestCancelled, RequestRejected,
                                       StubBackend)
from sparkdl_tpu_torch.serving.remote import FrontServer, RemoteEngine

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_tp_worker.py")
NEW, LONG = 16, 40
ROUNDS = ("clean", "drain", "lost")
ENGINE = dict(num_slots=2, max_len=64, prefill_chunk=8, block_size=8)
WAIT_S = 60.0


def _tiny_model():
    """The reference's ``_tiny_model``: GQA 4:2, an exact split at tp 2."""
    cfg = JL.LlamaConfig.tiny()
    model = JL.LlamaModel(cfg)
    variables = model.init(jax.random.PRNGKey(0),
                           np.zeros((1, 4), np.int32))
    return cfg, model, variables


def _static_refs(model, variables, prompts, new, max_len=64):
    ids, lens = JL.left_pad_prompts(prompts)
    out = np.asarray(JL.generate(model, variables, np.asarray(ids), new,
                                 pad_lens=np.asarray(lens), pad_to=max_len))
    return [out[i][int(lens[i]) + len(p):].tolist()
            for i, p in enumerate(prompts)]


def _until(pred, timeout=WAIT_S, what="condition"):
    t_end = time.time() + timeout
    while not pred():
        assert time.time() < t_end, f"timed out waiting for {what}"
        time.sleep(0.001)


def _reference_fleet(model, variables, prompts) -> list:
    """The JAX package's fleet over two tp = 2 engines on devices [0, 1]
    and [2, 3], started; the streams in prompt order."""
    devs = jax.devices()
    engines = [JEngine.from_model(model, variables, tp=2,
                                  mesh=jtp_mesh(2, devices=devs[i:i + 2]),
                                  **ENGINE) for i in (0, 2)]
    fleet = JFleet(engines, names=["a", "b"], routing="round_robin")
    fleet.start()
    try:
        frs = [fleet.submit(p, NEW) for p in prompts]
        assert all(fr.wait(WAIT_S) for fr in frs)
    finally:
        fleet.stop()
    return [fr.result(1) for fr in frs]


def _addr(path: Path):
    _until(path.exists, what=str(path))
    return tuple(json.loads(path.read_text()))


class _Run:
    """One round's fleet over the two groups' proxies, its streams
    recorded token by token (the exactly-once audit's left side)."""

    def __init__(self, d: Path, rnd: str, authkey: bytes):
        self.proxies = [RemoteEngine(_addr(d / f"{rnd}_{g}.addr"), authkey,
                                     timeout_s=30.0) for g in (0, 1)]
        self.fleet = EngineFleet(self.proxies, names=["a", "b"],
                                 routing="round_robin")
        self.fleet.start()
        self.streams: dict = {}

    def submit(self, prompt, new):
        return self.fleet.submit(prompt, new, stream_cb=lambda fr, t:
                                 self.streams.setdefault(fr.id, []).append(t))

    def finish(self, frs) -> dict:
        assert all(fr.wait(WAIT_S) for fr in frs), frs
        audit = all(self.streams.get(fr.id, []) == fr.tokens
                    and fr.delivered == len(fr.tokens) for fr in frs)
        self.fleet.stop(timeout=WAIT_S)
        return dict(audit=audit, stats=dict(self.fleet.stats),
                    states={n: self.fleet.replica_state(n)
                            for n in ("a", "b")})


def _clean_round(d, authkey, prompts) -> dict:
    run = _Run(d, "clean", authkey)
    frs = [run.submit(p, NEW) for p in prompts]
    long_ = run.submit(prompts[0], LONG)
    _until(lambda: len(long_.tokens) >= 2, what="the long request's tokens")
    long_.cancel()
    ids = {n: sorted(fr._primary.id for fr in frs if fr.replica == n)
           for n in ("a", "b")}
    out = run.finish(frs)
    assert long_.wait(WAIT_S)
    out.update(streams=[list(fr.tokens) for fr in frs], ids=ids,
               cancelled=[long_.state, type(long_.error).__name__,
                          len(long_.tokens)],
               rtt=len(run.proxies[0].stats["submit_rtt_s"]))
    return out


def _drain_round(d, authkey, prompts) -> dict:
    run = _Run(d, "drain", authkey)
    frs = [run.submit(p, NEW) for p in prompts]
    _until(lambda: any(len(fr.tokens) >= 2 and fr.replica == "a"
                       for fr in frs), what="tokens on group a")
    home = [fr.replica for fr in frs]
    run.fleet.doom_replica("a", "test drain")
    out = run.finish(frs)
    out.update(streams=[list(fr.tokens) for fr in frs], home=home,
               replicas=[fr.replica for fr in frs])
    return out


def _lost_round(d, authkey, prompts) -> dict:
    run = _Run(d, "lost", authkey)
    frs = [run.submit(p, NEW) for p in prompts]
    _until(lambda: any(len(fr.tokens) >= 2 and fr.replica == "b"
                       for fr in frs), what="tokens on group b")
    home = [fr.replica for fr in frs]
    (d / "lost_1.close").touch()
    _until(lambda: run.fleet.replica_state("b") == DEAD, what="b DEAD")
    out = run.finish(frs)
    out.update(streams=[list(fr.tokens) for fr in frs], home=home,
               replicas=[fr.replica for fr in frs],
               fatal=type(run.proxies[1]._fatal).__name__)
    return out


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """The gang's rounds driven from this process, every rank's record,
    the reference fleet's streams and the static references."""
    d = tmp_path_factory.mktemp("remote_fleet")
    cfg, model, variables = _tiny_model()
    torch.save(jax.tree_util.tree_map(np.asarray, variables["params"]),
               d / "tiny.pt")
    rng = np.random.RandomState(43)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in (5, 11, 8, 14, 3, 9)]
    authkey = os.urandom(16)
    torch.save({"fleet": dict(rounds=list(ROUNDS), authkey=authkey.hex(),
                              engine=ENGINE)}, d / "cases.pt")
    box: dict = {}

    def gang():
        try:
            launcher.launch(str(WORKER), np=4, args=["fleet", str(d), str(d)],
                            env={"OMP_NUM_THREADS": "1",
                                 "PYTHONPATH": f"{ROOT}:{ROOT / 'tests'}"},
                            timeout_s=240.0, capture=True)
        except BaseException as e:  # noqa: BLE001 — raised in the test
            box["error"] = e
    thread = threading.Thread(target=gang, daemon=True)
    thread.start()
    ref_fleet = _reference_fleet(model, variables, prompts)
    rounds = {}
    try:
        for rnd, drive in zip(ROUNDS, (_clean_round, _drain_round,
                                       _lost_round)):
            rounds[rnd] = drive(d, authkey, prompts)
    finally:
        thread.join(240.0)
    assert not thread.is_alive(), "the gang did not end"
    if "error" in box:
        raise box["error"]
    outs = [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(4)]
    return dict(rounds=rounds, outs=outs, ref_fleet=ref_fleet,
                refs=_static_refs(model, variables, prompts, NEW))


class TestRemoteFleetGang:
    """Two tp = 2 groups in a 4-rank gang behind this process's fleet."""

    def test_streams_equal_the_reference_fleet_and_generate(self, fleet_run):
        """Every round's streams equal the JAX fleet's and the static
        ``generate()``'s, and the exactly-once audit holds."""
        refs = fleet_run["refs"]
        assert fleet_run["ref_fleet"] == refs
        for rnd, r in fleet_run["rounds"].items():
            assert r["streams"] == refs, rnd
            assert r["audit"], rnd

    def test_clean_round_spreads_over_both_groups(self, fleet_run):
        r = fleet_run["rounds"]["clean"]
        assert r["states"] == {"a": "healthy", "b": "healthy"}
        assert r["ids"]["a"] and r["ids"]["b"]
        assert r["stats"]["completed"] == 6 and r["stats"]["cancelled"] == 1
        assert r["rtt"] == 4  # three prompts and the long request on a
        for o in fleet_run["outs"]:
            assert o["clean_end"][4], "a group's engine died"

    def test_same_remote_ids_in_two_groups_keep_apart(self, fleet_run):
        """Each group numbers its requests from the same start, so the
        two groups' ids collide; the streams are still each prompt's."""
        ids = fleet_run["rounds"]["clean"]["ids"]
        assert set(ids["a"]) & set(ids["b"]), ids

    def test_cancel_ends_the_remote_request(self, fleet_run):
        """The long request cancelled through the fleet ends on its group
        (``RequestCancelled`` here, counted there on both ranks) and
        leaves no slot busy and nothing queued."""
        state, err, n = fleet_run["rounds"]["clean"]["cancelled"]
        assert (state, err) == ("failed", "RequestCancelled")
        assert 2 <= n < LONG
        ends = [o["clean_end"] for o in fleet_run["outs"][:2]]
        assert ends[0] == ends[1]
        cancelled, completed, busy, queued, alive = ends[0]
        assert (cancelled, busy, queued, alive) == (1, 0, 0, True)

    def test_drained_group_readmits_on_the_other(self, fleet_run):
        """Group a drained mid-stream: both its ranks return the same
        snapshots (some mid-stream), each re-admits on group b, and the
        streams are the reference's."""
        r = fleet_run["rounds"]["drain"]
        outs = fleet_run["outs"]
        snaps = outs[0]["drain_snaps"]
        assert snaps and outs[1]["drain_snaps"] == snaps
        assert any(0 < len(s[1]) < NEW for s in snaps)
        assert r["stats"]["drains"] == 1
        assert r["stats"]["readmissions"] == len(snaps)
        assert r["stats"]["replica_deaths"] == 0
        moved = [i for i, (h, n) in enumerate(zip(r["home"], r["replicas"]))
                 if h != n]
        assert len(moved) == len(snaps)
        assert all(r["replicas"][i] == "b" for i in moved)
        assert r["states"]["a"] == "doomed"

    def test_dropped_channel_is_dead_and_readmits_from_shadow(self,
                                                            fleet_run):
        """Group b's front drops its channel without a drain: its proxy
        is fatal (``EngineStopped``), the replica DEAD, its live
        requests re-admitted on group a from the fleet's shadow state;
        both of b's ranks stopped with nothing drained."""
        r = fleet_run["rounds"]["lost"]
        assert r["fatal"] == "EngineStopped"
        assert r["states"] == {"a": "healthy", "b": "dead"}
        assert r["stats"]["replica_deaths"] == 1
        assert r["stats"]["readmissions"] >= 1
        moved = [(h, n) for h, n in zip(r["home"], r["replicas"]) if h != n]
        assert moved and all(m == ("b", "a") for m in moved), moved
        outs = fleet_run["outs"]
        assert outs[2]["lost_snaps"] == outs[3]["lost_snaps"] == []


# ---------------------------------------------------------------------------
# The proxy over a loopback channel to a one-process engine
# ---------------------------------------------------------------------------

def _stub_engine(**kw):
    return GenerationEngine(StubBackend(2, 64, step_s=kw.pop("step_s", 0.005),
                                       prefill_s=kw.pop("prefill_s", 0.0),
                                       vocab_size=50),
                            prefill_chunk=8, **kw)


class _Served:
    """A ``FrontServer`` over ``engine`` on a thread of this process and
    the proxy connected to it."""

    def __init__(self, engine, timeout_s=10.0):
        self.engine = engine
        self.server = FrontServer(engine, ("127.0.0.1", 0), b"key",
                                  accept_timeout_s=30.0)
        self.result: list = []
        self.thread = threading.Thread(
            target=lambda: self.result.append(self.server.serve()),
            daemon=True)
        self.thread.start()
        self.proxy = RemoteEngine(self.server.address, b"key",
                                  timeout_s=timeout_s)

    def join(self):
        self.thread.join(WAIT_S)
        assert not self.thread.is_alive()
        return self.result[0]


def _clean_streams(prompts, new):
    eng = _stub_engine()
    hs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.run_until_idle()
    return [h.result(1) for h in hs]


class TestProxyOverLoopback:

    def test_queue_full_reaches_placement(self):
        """A full remote queue raises ``QueueFullError`` here; the
        router's placement walks on to the next replica."""
        s = _Served(_stub_engine(queue_capacity=1, prefill_s=2.0))
        s.proxy.submit([1, 2, 3], 4, block=False)
        # once the first request holds a slot, the loop spends 2 s on its
        # prefill chunk, so the queue the next submits fill stays full
        _until(lambda: any(r is not None for r in s.engine._slots), 10.0,
               "the first request in a slot")
        with pytest.raises(QueueFullError):
            for i in range(1, 3):
                s.proxy.submit([1 + i, 2, 3], 4, block=False)
        local = _stub_engine()
        fleet = EngineFleet([s.proxy, local], names=["a", "b"],
                            routing="round_robin")
        fr = fleet.submit([7, 8, 9], 4)
        assert fr.replica == "b"  # round robin chose a first: it was full
        fleet.start()
        assert fr.wait(WAIT_S) and fr.tokens == _clean_streams([[7, 8, 9]],
                                                               4)[0]
        fleet.stop(drain=False, timeout=WAIT_S)
        s.join()

    def test_rejection_reaches_placement(self):
        """A prompt the remote engine can never fit raises
        ``RequestRejected`` here; a fleet of that replica alone fails it
        as unroutable."""
        s = _Served(_stub_engine())
        with pytest.raises(RequestRejected, match="max_len"):
            s.proxy.submit([1] * 69, 4, block=False)
        fleet = EngineFleet([s.proxy], names=["a"])
        with pytest.raises(FleetRoutingError, match="rejected by"):
            fleet.submit([1] * 69, 4)
        fleet.start()
        fleet.stop(timeout=WAIT_S)
        assert s.join() == []

    def test_silent_channel_makes_the_replica_dead(self):
        """A front that says nothing for ``timeout_s`` loses the channel:
        the proxy is fatal, a call raises ``EngineStopped`` and the
        started fleet marks the replica DEAD."""
        box = []
        lis = Listener(("127.0.0.1", 0), authkey=b"key")
        threading.Thread(target=lambda: box.append(lis.accept()),
                         daemon=True).start()
        proxy = RemoteEngine(lis.address, b"key", timeout_s=0.3)
        fleet = EngineFleet([proxy], names=["a"], min_replicas=0)
        fleet.start()
        try:
            _until(lambda: fleet.replica_state("a") == DEAD, 10.0,
                   "the silent replica DEAD")
            assert isinstance(proxy._fatal, EngineStopped)
            assert "TimeoutError" in str(proxy._fatal)
            with pytest.raises(EngineStopped):
                proxy.submit([1, 2], 2, block=False)
            with pytest.raises(FleetDegradedError):
                fleet.submit([1, 2], 2)
        finally:
            fleet.stop(timeout=5.0)
            lis.close()
            for c in box:
                c.close()

    def test_dropped_channel_fails_the_mirrors_and_readmits(self):
        """The front drops its channel mid-stream: every live mirror
        fails with ``EngineStopped``, the replica goes DEAD, its requests
        finish on the local replica from the fleet's shadow, exactly
        once; the front stopped its engine."""
        s = _Served(_stub_engine(step_s=0.02))
        local = _stub_engine()
        fleet = EngineFleet([s.proxy, local], names=["a", "b"],
                            routing="round_robin")
        fleet.start()
        prompts = [[1 + i, 2, 3] for i in range(4)]
        got: dict = {}
        frs = [fleet.submit(p, 12, stream_cb=lambda fr, t: got.setdefault(
            fr.id, []).append(t)) for p in prompts]
        mirrors = [fr._primary for fr in frs if fr.replica == "a"]
        _until(lambda: any(len(m.tokens) >= 2 for m in mirrors))
        s.server.close()
        assert all(fr.wait(WAIT_S) for fr in frs)
        fleet.stop(timeout=WAIT_S)
        assert s.join() == []
        assert fleet.replica_state("a") == DEAD
        failed = [m for m in mirrors if m.state == "failed"]
        assert failed and all(isinstance(m.error, EngineStopped)
                              for m in failed)
        assert [fr.tokens for fr in frs] == _clean_streams(prompts, 12)
        assert all(got[fr.id] == fr.tokens for fr in frs)
        assert s.engine._thread is None and s.engine._fatal is None

    def test_cancel_and_drain_cross_the_channel(self):
        """``cancel()`` on a mirror ends the remote request
        (``RequestCancelled`` on both sides); ``drain()`` returns the
        mirrors handed out, updated from the remote snapshots, which
        resume elsewhere to the clean streams."""
        s = _Served(_stub_engine(step_s=0.02))
        a = s.proxy.submit([1, 2, 3], 30, block=False)
        b = s.proxy.submit([4, 5, 6], 12, block=False)
        _until(lambda: len(a.tokens) >= 2)
        a.cancel()
        assert a.wait(WAIT_S) and isinstance(a.error, RequestCancelled)
        assert a.finish_reason == "cancelled"
        _until(lambda: len(b.tokens) >= 2)
        snaps = s.proxy.drain(timeout=5.0)
        assert snaps == [b] and b.state == "queued"
        assert len(s.join()) == 1  # the front's own snapshot of b
        assert s.engine.stats["cancelled"] == 1
        other = _stub_engine()
        other.resume(b)
        other.run_until_idle()
        assert b.result(1) == _clean_streams([[4, 5, 6]], 12)[0]
        with pytest.raises(EngineStopped):
            s.proxy.submit([1, 2], 2, block=False)

    def test_inline_drive_is_refused(self):
        """``EngineFleet.step()`` over a remote replica raises, naming
        the roadmap entry, instead of reporting an idle fleet."""
        s = _Served(_stub_engine())
        fleet = EngineFleet([s.proxy], names=["a"])
        with pytest.raises(NotImplementedError, match="C 2"):
            fleet.step()
        s.proxy.stop(timeout=5.0)
        s.join()
