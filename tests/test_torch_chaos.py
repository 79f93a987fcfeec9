"""The port's fault injection (``runner/chaos.py``) through its sites in
the runner, the data plane and the checkpoint manager, on the CPU.

Twins of ``tests/test_chaos.py``'s ``TestFaultPlan``,
``TestChaosThroughFit``, ``TestCorruptKind`` (its supervised-gang test
needs ``launcher.supervise``, not ported) and ``TestDecimateKind``. Where
a test has an output (a plan's serialization, a seeded trigger's firing
steps, the failure counters, a poisoned batch, the restarts and steps of
a supervised fit), the same inputs go through the JAX package and the
port and the outputs are compared. The fits train a 4×3 linear softmax
model on seeded numpy batches. The kinds that kill the process
(``sigkill``, ``decimate``) run in a child process with its own timeout.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json
import os
import signal
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

from sparkdl_tpu.runner import XlaRunner as JaxRunner
from sparkdl_tpu.runner import chaos as ref_chaos
from sparkdl_tpu.runner import metrics as ref_metrics
from sparkdl_tpu.runner import softmax_cross_entropy_loss as jax_sce
from sparkdl_tpu_torch.runner import (CheckpointManager, Fault, FaultPlan,
                                      InjectedFatal, InjectedPreemption,
                                      TrainingDivergedError, XlaRunner,
                                      classify_exception, run_stats,
                                      sgd, softmax_cross_entropy_loss,
                                      touch_heartbeat)
from sparkdl_tpu_torch.runner import chaos
from sparkdl_tpu_torch.runner import checkpoint as ckpt_lib

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    """No plan installed, no env plan, zeroed failure counters, in both
    packages, before and after every test."""
    monkeypatch.delenv(chaos.CHAOS_ENV, raising=False)
    monkeypatch.delenv("SPARKDL_PROCESS_ID", raising=False)
    monkeypatch.delenv("SPARKDL_NUM_PROCESSES", raising=False)
    for mod in (chaos, ref_chaos):
        mod.uninstall()
    run_stats.reset()
    ref_metrics.run_stats.reset()
    yield
    for mod in (chaos, ref_chaos):
        mod.uninstall()
    run_stats.reset()
    ref_metrics.run_stats.reset()


class Linear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(np.array(w)))

    def forward(self, x):
        return x @ self.w


def _params(seed=0):
    return {"w": np.random.RandomState(seed).randn(4, 3).astype(np.float32)}


def _data(n_batches=64, seed=1):
    rng = np.random.RandomState(seed)
    for _ in range(n_batches):
        x = rng.randn(16, 4).astype(np.float32)
        yield {"image": x, "label": rng.randint(0, 3, (16,))}


def _port_main(attempts, **kw):
    def main(ctx):
        attempts.append(1)
        return ctx.fit(loss_fn=softmax_cross_entropy_loss(),
                       model=Linear(_params()["w"]), tx=sgd(0.1),
                       data=_data(), **kw)
    return main


def _ref_main(attempts, **kw):
    def main(ctx):
        attempts.append(1)
        return ctx.fit(loss_fn=jax_sce(), params=_params(),
                       tx=optax.sgd(0.1), apply_fn=lambda p, x: x @ p["w"],
                       data=_data(), **kw)
    return main


def _both(plan_faults, port_runner, ref_runner, **fit_kw):
    """Run the same plan and fit through the port and the reference:
    ``[(result or exception, attempts, run_stats snapshot)]``."""
    out = []
    for ch, runner, main, stats in (
            (chaos, port_runner, _port_main, run_stats),
            (ref_chaos, ref_runner, _ref_main, ref_metrics.run_stats)):
        ch.install(ch.FaultPlan([ch.Fault(**f) for f in plan_faults]))
        attempts: list = []
        try:
            res = runner.run_with_restarts(main(attempts, **fit_kw),
                                           max_restarts=3, backoff_s=0.0)
        except Exception as e:
            res = e
        ch.uninstall()
        out.append((res, attempts, stats.snapshot()))
    return out


# --- TestFaultPlan -----------------------------------------------------------

class TestFaultPlan:
    def test_env_roundtrip(self):
        faults = [dict(site="step_start", kind="preempt", at_step=3),
                  dict(site="batch_fetch", kind="nan", at_step=1, rank=1,
                       once=False)]
        plan = FaultPlan([Fault(**f) for f in faults], seed=42,
                         state_dir="/tmp/x")
        env = plan.to_env()
        back = FaultPlan.from_env(env)
        assert back.faults == plan.faults
        assert back.seed == 42 and back.state_dir == "/tmp/x"
        assert FaultPlan.from_env({}) is None
        ref = ref_chaos.FaultPlan([ref_chaos.Fault(**f) for f in faults],
                                  seed=42, state_dir="/tmp/x")
        assert json.loads(plan.to_json()) == json.loads(ref.to_json())
        # each package reads the other's env transport
        assert ref_chaos.FaultPlan.from_env(env).to_json() == ref.to_json()

    def test_validation(self):
        for mod in (chaos, ref_chaos):
            with pytest.raises(ValueError, match="site"):
                mod.Fault("nowhere", "preempt", at_step=0)
            with pytest.raises(ValueError, match="kind"):
                mod.Fault("step_start", "explode", at_step=0)
            with pytest.raises(ValueError, match="batch_fetch"):
                mod.Fault("step_start", "nan", at_step=0)
            with pytest.raises(ValueError, match="trigger"):
                mod.Fault("step_start", "preempt")
        assert chaos.SITES == ref_chaos.SITES
        assert chaos.KINDS == ref_chaos.KINDS

    def test_at_step_fires_once_and_counts(self):
        plan = chaos.install(FaultPlan([Fault("step_start", "preempt",
                                              at_step=2)]))
        chaos.fire("step_start", step=0)
        chaos.fire("step_start", step=1)
        with pytest.raises(InjectedPreemption, match="UNAVAILABLE"):
            chaos.fire("step_start", step=2)
        chaos.fire("step_start", step=2)  # once: no re-fire
        assert plan._fired[0] == 1
        assert run_stats.faults_injected == 1
        assert run_stats.fault_sites == ["step_start:preempt"]

    def test_prob_trigger_is_seed_deterministic(self):
        def pattern(mod, seed):
            plan = mod.FaultPlan([mod.Fault("collective", "hang", prob=0.3,
                                            once=False, hang_s=0.0)],
                                 seed=seed)
            fired = []
            for _ in range(64):
                before = plan._fired[0]
                plan.fire("collective")
                fired.append(plan._fired[0] > before)
            return fired

        a, b = pattern(chaos, 7), pattern(chaos, 7)
        assert a == b
        assert any(a) and not all(a)
        assert pattern(chaos, 8) != a
        assert a == pattern(ref_chaos, 7)  # the reference's coin, to the toss

    def test_rank_filter(self, monkeypatch):
        plan = chaos.install(FaultPlan([Fault("step_start", "preempt",
                                              at_step=0, rank=1)]))
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "0")
        chaos.fire("step_start", step=0)
        assert plan._fired[0] == 0
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "1")
        with pytest.raises(InjectedPreemption):
            chaos.fire("step_start", step=0)

    def test_once_persists_across_plan_instances_via_state_dir(self,
                                                               tmp_path):
        plan1 = FaultPlan([Fault("step_start", "preempt", at_step=1)],
                          state_dir=str(tmp_path))
        with pytest.raises(InjectedPreemption):
            plan1.fire("step_start", step=1)
        plan2 = FaultPlan.from_json(plan1.to_json())
        plan2.fire("step_start", step=1)  # the marker file suppresses it
        assert plan2._fired[0] == 0
        # the reference reads the same marker
        ref = ref_chaos.FaultPlan.from_json(plan1.to_json())
        ref.fire("step_start", step=1)
        assert ref._fired[0] == 0

    def test_nan_poisons_float_leaves_only(self):
        batch = {"image": np.ones((4, 2), np.float32),
                 "label": np.arange(4)}
        outs = []
        for mod in (chaos, ref_chaos):
            mod.install(mod.FaultPlan([mod.Fault("batch_fetch", "nan",
                                                 at_step=0)]))
            out = mod.fire("batch_fetch", step=0, batch=batch)
            mod.uninstall()
            assert np.isnan(out["image"]).all()
            assert (out["label"] == np.arange(4)).all()
            outs.append(out)
        assert outs[0]["image"].dtype == outs[1]["image"].dtype
        assert run_stats.faults_injected == 1
        assert ref_metrics.run_stats.faults_injected == 1

    def test_nan_poisons_tensor_batches_wherever_they_lie(self):
        """A batch of tensors: float tensors come back NaN with their
        dtype and device, integer ones untouched, the batch's structure
        kept."""
        batch = {"image": torch.ones(4, 2, dtype=torch.bfloat16),
                 "ids": torch.arange(4),
                 "nested": [torch.zeros(3), (np.ones(2, np.float32),)]}
        chaos.install(FaultPlan([Fault("batch_fetch", "nan", at_step=0)]))
        out = chaos.fire("batch_fetch", step=0, batch=batch)
        assert out["image"].dtype == torch.bfloat16
        assert out["image"].device == batch["image"].device
        assert torch.isnan(out["image"]).all()
        assert out["ids"] is batch["ids"]
        assert torch.isnan(out["nested"][0]).all()
        assert isinstance(out["nested"][1], tuple)
        assert np.isnan(out["nested"][1][0]).all()
        assert torch.equal(batch["image"], torch.ones(4, 2,
                                                      dtype=torch.bfloat16))

    def test_env_autoinstall(self, monkeypatch):
        plan = FaultPlan([Fault("worker", "fatal", prob=1.0)])
        monkeypatch.setenv(chaos.CHAOS_ENV, plan.to_json())
        chaos.uninstall()
        with pytest.raises(InjectedFatal, match="INVALID_ARGUMENT"):
            chaos.fire("worker")
        # the worker site fires at XlaRunner.run's entry
        chaos.uninstall()
        with pytest.raises(InjectedFatal):
            XlaRunner(device="cpu").run(lambda ctx: 1)

    def test_no_plan_is_noop(self):
        batch = {"x": np.ones(3)}
        assert chaos.fire("step_start", step=0, batch=batch) is batch

    def test_injected_errors_classify_correctly(self):
        assert classify_exception(
            InjectedPreemption("UNAVAILABLE: injected")) == "retryable"
        assert classify_exception(
            InjectedFatal("INVALID_ARGUMENT: injected")) == "fatal"
        assert classify_exception(TrainingDivergedError(7, float("nan"))) \
            == "fatal"

    def test_collective_site_in_the_hvd_module(self):
        """``api.allreduce`` / ``broadcast`` consult the collective site."""
        from sparkdl_tpu_torch.runner import api
        ctx = api.init(device="cpu")
        try:
            chaos.install(FaultPlan([Fault("collective", "fatal",
                                           prob=1.0)]))
            with pytest.raises(InjectedFatal):
                api.allreduce(np.ones(2))
            chaos.install(FaultPlan([Fault("collective", "preempt",
                                           prob=1.0)]))
            with pytest.raises(InjectedPreemption):
                api.broadcast(np.ones(2))
            chaos.uninstall()
            assert api.allreduce(np.ones(2)).tolist() == [1.0, 1.0]
            assert ctx.size == 1
        finally:
            api.shutdown()
        assert run_stats.fault_sites == ["collective:fatal",
                                         "collective:preempt"]

    def test_announce_injection_marker(self, capsys):
        chaos.announce_injection("a test fault")
        err = capsys.readouterr().err
        assert err.startswith(chaos.CHAOS_INJECTED_MARKER)
        assert chaos.CHAOS_INJECTED_MARKER == ref_chaos.CHAOS_INJECTED_MARKER
        ref_chaos.announce_injection("a test fault")
        assert capsys.readouterr().err == err


# --- TestChaosThroughFit -----------------------------------------------------

class TestChaosThroughFit:
    def test_preempt_at_step_k_restarts_once_and_resumes(self, tmp_path):
        got = _both([dict(site="step_start", kind="preempt", at_step=3)],
                    XlaRunner(device="cpu",
                              checkpoint_dir=str(tmp_path / "port")),
                    JaxRunner(np=1, checkpoint_dir=str(tmp_path / "ref")),
                    num_steps=6, checkpoint_every=2, log_every=100)
        for res, attempts, snap in got:
            assert len(attempts) == 2
            assert int(res["state"].step) == 6
            assert res["meter"].steps == 4  # attempt 2 ran steps 2..5
            assert snap["restarts"] == 1
            assert snap["faults_injected"] == 1
            assert snap["last_failure_kind"] == "retryable"
            assert "UNAVAILABLE" in snap["last_failure"]
            ft = res["meter"].summary()["fault_tolerance"]
            assert ft == {"restarts": 1, "faults_injected": 1}
        keys = ("restarts", "faults_injected", "last_failure_kind",
                "fault_sites", "checkpoint_rollbacks")
        assert {k: got[0][2][k] for k in keys} == \
            {k: got[1][2][k] for k in keys}

    def test_nan_batch_fails_fast_fatal_no_restart(self, tmp_path):
        got = _both([dict(site="batch_fetch", kind="nan", at_step=1)],
                    XlaRunner(device="cpu",
                              checkpoint_dir=str(tmp_path / "port")),
                    JaxRunner(np=1, checkpoint_dir=str(tmp_path / "ref")),
                    num_steps=4, checkpoint_every=2, log_every=1)
        for err, attempts, snap in got:
            assert type(err).__name__ == "TrainingDivergedError"
            assert err.step == 2  # the NaN batch fed step index 1
            assert len(attempts) == 1
            assert snap["restarts"] == 0
            assert snap["last_failure_kind"] == "fatal"
        # the guard beat the step-2 checkpoint: nothing on disk
        mngr = CheckpointManager(str(tmp_path / "port"), async_save=False)
        assert mngr.latest_step() is None
        mngr.close()

    def test_fatal_injection_does_not_retry(self):
        got = _both([dict(site="step_start", kind="fatal", at_step=1)],
                    XlaRunner(device="cpu"), JaxRunner(np=1),
                    num_steps=3, log_every=100)
        for err, attempts, snap in got:
            assert type(err).__name__ == "InjectedFatal"
            assert len(attempts) == 1
        assert got[0][2]["fault_sites"] == got[1][2]["fault_sites"]

    def test_fit_touches_heartbeat(self, tmp_path, monkeypatch):
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "0")
        bodies = []
        for run, main, d in (
                (XlaRunner(device="cpu").run, _port_main, tmp_path / "p"),
                (JaxRunner(np=1).run, _ref_main, tmp_path / "r")):
            monkeypatch.setenv("SPARKDL_HEARTBEAT_DIR", str(d))
            run(main([], num_steps=3, log_every=100))
            body = json.loads((d / "rank0.hb").read_text())
            assert body["step"] == 2  # the last step index the loop ran
            assert body["time"] > 0
            bodies.append(body["step"])
        assert bodies[0] == bodies[1]

    def test_touch_heartbeat_noop_without_env(self, monkeypatch, tmp_path):
        monkeypatch.delenv("SPARKDL_HEARTBEAT_DIR", raising=False)
        touch_heartbeat(5)
        assert list(tmp_path.iterdir()) == []
        monkeypatch.setenv("SPARKDL_HEARTBEAT_DIR", str(tmp_path / "hb2"))
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "3")
        touch_heartbeat(5)
        body = json.loads((tmp_path / "hb2" / "rank3.hb").read_text())
        assert body["step"] == 5


# --- TestCorruptKind ---------------------------------------------------------

class TestCorruptKind:
    def test_new_sites_and_kind_validate(self):
        for mod in (chaos, ref_chaos):
            with pytest.raises(ValueError, match="corrupt"):
                mod.Fault("step_start", "corrupt", prob=1.0)
            for site in ("decode", "dispatch", "checkpoint_restore"):
                assert mod.Fault(site, "preempt", prob=1.0).site == site
        f = Fault("checkpoint_restore", "corrupt", prob=1.0)
        back = FaultPlan.from_env(FaultPlan([f]).to_env())
        assert back.faults == [f]

    def test_poison_kind_and_data_fetch_site_validate(self):
        for mod in (chaos, ref_chaos):
            with pytest.raises(ValueError, match="poison"):
                mod.Fault("step_start", "poison", prob=1.0)
            assert mod.Fault("batch_fetch", "poison", at_step=1).site == \
                "batch_fetch"
        f = Fault("data_fetch", "poison", at_step=8, once=False)
        back = FaultPlan.from_env(FaultPlan([f]).to_env())
        assert back.faults == [f]

    def test_poison_nans_floats_or_raises_without_them(self):
        clean = {"x": np.ones(3, np.float32), "y": np.arange(3)}
        for mod in (chaos, ref_chaos):
            plan = mod.FaultPlan([mod.Fault("data_fetch", "poison",
                                            at_step=2, once=False)])
            assert plan.fire("data_fetch", step=1, batch=clean) is clean
            out = plan.fire("data_fetch", step=2, batch=clean)
            assert np.isnan(out["x"]).all()
            np.testing.assert_array_equal(out["y"], np.arange(3))
            out2 = plan.fire("data_fetch", step=2, batch=clean)
            assert np.isnan(out2["x"]).all()
            with pytest.raises(mod.InjectedFatal, match="poison"):
                plan.fire("data_fetch", step=2, batch={"ids": np.arange(3)})
        # the LoRA batch, integer ids on the card or the host: raises
        plan = FaultPlan([Fault("batch_fetch", "poison", at_step=0)])
        with pytest.raises(InjectedFatal, match="poison"):
            plan.fire("batch_fetch", step=0,
                      batch={"input_ids": torch.arange(6).view(2, 3)})

    def test_corrupt_damages_newest_step_only(self, tmp_path):
        assert ckpt_lib.corrupt_latest_checkpoint is \
            chaos.corrupt_latest_checkpoint  # one implementation
        for pkg in ("port", "ref"):
            for step, size in ((1, 64), (2, 64)):
                d = tmp_path / pkg / str(step)
                d.mkdir(parents=True)
                (d / "data.bin").write_bytes(b"\x00" * size)
        damaged = chaos.corrupt_latest_checkpoint(str(tmp_path / "port"))
        want = ref_chaos.corrupt_latest_checkpoint(str(tmp_path / "ref"))
        assert damaged and "/2/" in damaged[0]
        for step in (1, 2):
            assert (tmp_path / "port" / str(step) / "data.bin"
                    ).read_bytes() == \
                (tmp_path / "ref" / str(step) / "data.bin").read_bytes()
        assert len(want) == len(damaged)
        assert (tmp_path / "port" / "2" / "data.bin").stat().st_size < 64
        assert (tmp_path / "port" / "1" / "data.bin").stat().st_size == 64
        assert chaos.corrupt_latest_checkpoint(str(tmp_path / "none")) == []
        assert chaos.corrupt_latest_checkpoint(None) == []

    def test_corrupt_fires_through_restore_site(self, tmp_path):
        d = tmp_path / "3"
        d.mkdir()
        (d / "leaf.bin").write_bytes(b"\x11" * 32)
        chaos.install(FaultPlan([Fault("checkpoint_restore", "corrupt",
                                       prob=1.0)]))
        chaos.fire("checkpoint_restore", path=str(tmp_path))
        assert (d / "leaf.bin").stat().st_size < 32
        assert run_stats.fault_sites == ["checkpoint_restore:corrupt"]

    def test_restore_site_rolls_back_a_real_checkpoint(self, tmp_path):
        """``CheckpointManager.restore`` fires ``checkpoint_restore`` with
        its directory: a ``corrupt`` plan damages the newest step before
        verification, which rolls back to the verified one; ``save``
        fires ``checkpoint_save`` (a preemption there leaves no step)."""
        d = str(tmp_path / "ck")
        res = XlaRunner(device="cpu", checkpoint_dir=d).run(
            _port_main([], num_steps=4, checkpoint_every=2, log_every=100))
        chaos.install(FaultPlan([Fault("checkpoint_restore", "corrupt",
                                       prob=1.0)]))
        m = CheckpointManager(d)
        st = m.restore(res["state"])
        assert st.step == 2
        assert run_stats.checkpoint_rollbacks == 1
        chaos.install(FaultPlan([Fault("checkpoint_save", "preempt",
                                       at_step=6)]))
        with pytest.raises(InjectedPreemption):
            m.save(6, st, wait=True)
        assert m.latest_step() == 2
        m.close()


# --- TestDecimateKind --------------------------------------------------------

_KILL_CHILD = """
import os, sys
sys.path.insert(0, {repo!r})
from sparkdl_tpu_torch.runner import chaos
plan = chaos.FaultPlan.from_json(sys.argv[1])
print("before", flush=True)
plan.fire("step_start", step=5)
print("survived", flush=True)
"""


class TestDecimateKind:
    def test_kind_validates_anywhere_and_roundtrips(self):
        f = Fault("step_start", "decimate", at_step=5, rank=2)
        back = FaultPlan.from_env(FaultPlan([f]).to_env())
        assert back.faults == [f]
        assert Fault("worker", "decimate", prob=1.0).kind == "decimate"
        with pytest.raises(ValueError, match="kind"):
            Fault("step_start", "decimated", at_step=1)

    def test_marker_is_rank_and_world_scoped(self, tmp_path, monkeypatch):
        plan = FaultPlan([Fault("step_start", "decimate", at_step=5,
                                rank=2)], state_dir=str(tmp_path))
        ref = ref_chaos.FaultPlan.from_json(plan.to_json())
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "2")
        monkeypatch.setenv("SPARKDL_NUM_PROCESSES", "4")
        marker = plan.decimate_marker(2)
        assert marker.endswith("chaos_decimated_rank2_np4")
        assert marker == ref.decimate_marker(2)
        assert not plan._slot_decimated()
        plan._mark_decimated()
        assert plan._slot_decimated() and ref._slot_decimated()
        monkeypatch.setenv("SPARKDL_NUM_PROCESSES", "3")
        assert not plan._slot_decimated()
        monkeypatch.setenv("SPARKDL_NUM_PROCESSES", "4")
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "1")
        assert not plan._slot_decimated()

    def test_no_state_dir_degrades_to_plain_sigkill(self, monkeypatch):
        plan = FaultPlan([Fault("step_start", "decimate", at_step=5,
                                rank=2)])
        monkeypatch.setenv("SPARKDL_PROCESS_ID", "2")
        assert plan.decimate_marker(2) is None
        assert not plan._slot_decimated()
        plan._mark_decimated()
        assert not plan._slot_decimated()

    @pytest.mark.parametrize("kind", ["sigkill", "decimate"])
    def test_kill_kinds_kill_the_calling_process(self, tmp_path, kind):
        """In a child process (its own timeout): the kind SIGKILLs it at
        the fault's step, after the chaos event is on disk; ``decimate``
        leaves its dead-slot marker, which re-kills the next process of
        that slot at its first ``fire()`` whatever the site or step."""
        plan = FaultPlan([Fault("step_start", kind, at_step=5)],
                         state_dir=str(tmp_path / "state"))
        env = {**os.environ, "SPARKDL_EVENT_DIR": str(tmp_path / "ev"),
               "SPARKDL_PROCESS_ID": "0", "SPARKDL_NUM_PROCESSES": "1",
               "JAX_PLATFORMS": "cpu"}
        script = tmp_path / "child.py"
        script.write_text(_KILL_CHILD.format(repo=_REPO))
        proc = subprocess.run([sys.executable, str(script), plan.to_json()],
                              env=env, capture_output=True, text=True,
                              timeout=60)
        assert proc.returncode == -signal.SIGKILL
        assert proc.stdout.split() == ["before"]
        lines = (tmp_path / "ev" / "events_rank0.jsonl").read_text()
        ev = [json.loads(ln) for ln in lines.splitlines()]
        assert [(e["name"], e["kind"]) for e in ev] == [("chaos", kind)]
        marked = os.path.exists(plan.decimate_marker(0, 1))
        assert marked == (kind == "decimate")
        if kind == "decimate":
            # a relaunch of the slot: killed again at its first fire
            again = subprocess.run(
                [sys.executable, str(script), plan.to_json()], env=env,
                capture_output=True, text=True, timeout=60)
            assert again.returncode == -signal.SIGKILL
