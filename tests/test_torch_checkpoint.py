"""The port's checkpoints and the runner's resume (``runner/checkpoint.py``,
``RunnerContext.fit(checkpoint_every=, resume=, feed_lookahead=,
profile_dir=)``, ``XlaRunner.run_with_restarts``), on the CPU.

Twins of the 14 single-topology tests of ``tests/test_checkpoint.py``
(manifests, quarantine, rollback to the newest verified step, legacy
directories, ``SPARKDL_CHECKPOINT_VERIFY=0``, idempotent wait/close, the
fit error path, ``load_portable``) and of ``tests/test_runner.py``'s
checkpoint, restart and feed-lookahead tests, on a linear softmax model
(the reference's ``_make_problem``) and on a narrow ResNet18 with
BatchNorm statistics. Where a twin trains, the port's parameters are held
against the JAX package's run on the same numpy data: within 1e-5
relative + 1e-6 absolute (f32, a 4×3 linear model, the same arithmetic
in other orders). A save and restore, and a resumed run on the CPU
against an uninterrupted one, are held bit for bit.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import glob
import json
import os
import threading

import numpy as np
import optax
import pytest
import torch

import jax
from sparkdl_tpu.runner import XlaRunner as JaxRunner
from sparkdl_tpu.runner import softmax_cross_entropy_loss as jax_sce
from sparkdl_tpu_torch.models import resnet as R
from sparkdl_tpu_torch.runner import (CheckpointManager, TrainState,
                                      XlaRunner, bn_classifier_loss, sgd,
                                      softmax_cross_entropy_loss)
from sparkdl_tpu_torch.runner import adam, chaos, data as D, metrics
from sparkdl_tpu_torch.runner.checkpoint import (CheckpointCorruptionError,
                                                 CheckpointTopologyError,
                                                 corrupt_latest_checkpoint,
                                                 load_portable,
                                                 save_portable)


#: the longest a test waits for ``m.wait()``; a save here lands in well
#: under a second, and a hung wait fails its test
WAIT_S = 30.0


def _wait(m):
    """``m.wait()`` itself, on a thread of its own that must return
    within WAIT_S; its error, if any, is raised here."""
    errors = []

    def call():
        try:
            m.wait()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t = threading.Thread(target=call, daemon=True)
    t.start()
    t.join(WAIT_S)
    assert not t.is_alive(), f"m.wait() still blocked after {WAIT_S} s"
    if errors:
        raise errors[0]


class Linear(torch.nn.Module):
    """``x @ w + b`` with the reference's parameter layout."""

    def __init__(self, w, b=None):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(np.array(w)))
        self.b = None if b is None else torch.nn.Parameter(
            torch.as_tensor(np.array(b)))

    def forward(self, x):
        y = x @ self.w
        return y if self.b is None else y + self.b


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(4, 3).astype(np.float32),
            "b": np.zeros((3,), np.float32)}


def _data(n_batches=12, bs=16, seed=0):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(4, 3).astype(np.float32)
    for _ in range(n_batches):
        x = rng.randn(bs, 4).astype(np.float32)
        yield {"image": x, "label": (x @ w_true).argmax(-1)}


def _state(value: float):
    return TrainState.create(Linear(np.full((4, 3), value, np.float32)),
                             sgd(0.1))


def _w(state):
    return state.model.w.detach().numpy()


def _two_step_dir(tmp_path):
    d = str(tmp_path / "ckpt")
    m = CheckpointManager(d, async_save=False)
    m.save(1, _state(1.0), wait=True)
    m.save(2, _state(2.0), wait=True)
    return d, m


def _jax_fit(params, data, num_steps, **kw):
    """The reference's fit on one device of the same problem."""
    res = JaxRunner(np=1).run(lambda ctx: ctx.fit(
        loss_fn=jax_sce(), params=params, tx=optax.sgd(0.1),
        apply_fn=lambda p, x: x @ p["w"] + p["b"], data=data,
        num_steps=num_steps, log_every=100, **kw))
    return jax.tree_util.tree_map(np.asarray, res["state"].params)


# --- twins of tests/test_checkpoint.py ---------------------------------------

def test_manifest_committed_per_step(tmp_path):
    d, m = _two_step_dir(tmp_path)
    names = sorted(os.path.basename(p)
                   for p in glob.glob(d + "/manifest_step_*.json"))
    assert names == ["manifest_step_1.json", "manifest_step_2.json"]
    assert m.verify_step(1) == (True, "ok")
    assert m.verify_step(2) == (True, "ok")
    with open(os.path.join(d, "manifest_step_2.json")) as f:
        man = json.load(f)
    assert man["topology"]["world_size"] == 1
    assert man["topology"]["tensors"]["w"] == [[4, 3], "float32"]
    m.close()


def test_restore_falls_back_to_verified_step(tmp_path):
    metrics.run_stats.reset()
    d, m = _two_step_dir(tmp_path)
    assert corrupt_latest_checkpoint(d)  # damages step 2
    ok, reason = m.verify_step(2)
    assert not ok and reason
    restored = m.restore(_state(0.0))
    np.testing.assert_array_equal(_w(restored), 1.0)  # step 1's value
    assert len(glob.glob(d + "/2.corrupt*")) == 1
    assert not os.path.exists(os.path.join(d, "2"))
    assert metrics.run_stats.checkpoint_rollbacks == 1
    assert "2 -> 1" in metrics.run_stats.last_rollback
    assert m.verify_step(1) == (True, "ok")
    m.close()
    metrics.run_stats.reset()


def test_all_corrupt_raises_not_death_loops(tmp_path):
    d = str(tmp_path / "ckpt")
    m = CheckpointManager(d, async_save=False)
    m.save(1, _state(1.0), wait=True)
    corrupt_latest_checkpoint(d)
    with pytest.raises(CheckpointCorruptionError, match="no verified"):
        m.restore(_state(0.0))
    m.close()


def test_explicit_corrupt_step_raises(tmp_path):
    d, m = _two_step_dir(tmp_path)
    corrupt_latest_checkpoint(d)
    with pytest.raises(CheckpointCorruptionError, match="step 2"):
        m.restore(_state(0.0), step=2)
    m.close()


def test_legacy_dir_without_manifests_still_restores(tmp_path):
    d, m = _two_step_dir(tmp_path)
    for p in glob.glob(d + "/manifest_step_*.json"):
        os.unlink(p)
    np.testing.assert_array_equal(_w(m.restore(_state(0.0))), 2.0)
    m.close()


def test_verify_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKDL_CHECKPOINT_VERIFY", "0")
    d = str(tmp_path / "ckpt")
    m = CheckpointManager(d, async_save=False)
    m.save(1, _state(1.0), wait=True)
    assert glob.glob(d + "/manifest_step_*.json") == []
    np.testing.assert_array_equal(_w(m.restore(_state(0.0))), 1.0)
    m.close()


def test_wait_close_idempotent_and_safe_before_first_save(tmp_path):
    m = CheckpointManager(str(tmp_path / "ckpt"))
    _wait(m)
    _wait(m)
    m.close()
    m.close()
    m2 = CheckpointManager(str(tmp_path / "ckpt2"))
    m2.save(1, _state(1.0), wait=False)
    _wait(m2)  # the writer has landed the file and its manifest
    assert m2.verify_step(1) == (True, "ok")
    m2.close()
    _wait(m2)  # after close: no-op


def test_fit_error_path_closes_manager_once(tmp_path):
    """A failing fit closes its manager (the in-flight save lands) and
    drops it, so the context can open another."""
    ctx = XlaRunner(device="cpu",
                    checkpoint_dir=str(tmp_path / "ckpt")).make_context()
    rng = np.random.RandomState(0)

    def boom():
        for i in range(100):
            if i == 3:
                raise RuntimeError("UNAVAILABLE: injected")
            yield {"image": rng.randn(8, 4).astype(np.float32),
                   "label": rng.randint(0, 3, (8,))}

    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        ctx.fit(loss_fn=softmax_cross_entropy_loss(),
                model=Linear(rng.randn(4, 3).astype(np.float32)),
                tx=sgd(0.1), data=boom(), num_steps=6, checkpoint_every=2,
                log_every=100)
    assert ctx._ckpt is None
    m = CheckpointManager(str(tmp_path / "ckpt"))
    assert m.latest_step() == 2
    assert m.verify_step(2) == (True, "ok")
    m.close()


def test_fit_resumes_past_corrupt_checkpoint(tmp_path):
    """Corrupt the newest checkpoint and fit again: the run rolls back to
    the previous verified step and completes."""
    metrics.run_stats.reset()
    ckpt = str(tmp_path / "ckpt")
    w0 = np.random.RandomState(1).randn(4, 3).astype(np.float32)

    def data(n):
        r = np.random.RandomState(2)
        for _ in range(n):
            yield {"image": r.randn(8, 4).astype(np.float32),
                   "label": r.randint(0, 3, (8,))}

    kw = dict(loss_fn=softmax_cross_entropy_loss(), tx=sgd(0.1),
              checkpoint_every=2, log_every=100)
    r1 = XlaRunner(device="cpu", checkpoint_dir=ckpt).run(
        lambda ctx: ctx.fit(model=Linear(w0), data=data(12), num_steps=4,
                            **kw))
    assert r1["state"].step == 4
    assert corrupt_latest_checkpoint(ckpt)
    r2 = XlaRunner(device="cpu", checkpoint_dir=ckpt).run(
        lambda ctx: ctx.fit(model=Linear(w0), data=data(12), num_steps=6,
                            **kw))
    assert r2["state"].step == 6
    assert r2["meter"].steps == 4  # resumed from step 2, not 4
    assert metrics.run_stats.checkpoint_rollbacks == 1
    assert glob.glob(ckpt + "/4.corrupt*")
    metrics.run_stats.reset()


def test_load_portable_reports_all_mismatches_in_one_error(tmp_path):
    path = str(tmp_path / "w.pt")
    save_portable({"a": {"w": np.ones((2, 2), np.float32)},
                   "extra": np.ones((1,), np.float32),
                   "b": np.ones((3,), np.float32)}, path)
    template = {"a": {"w": np.zeros((2, 3), np.float32)},
                "b": np.zeros((3,), np.float32),
                "missing1": np.zeros((1,), np.float32),
                "missing2": np.zeros((1,), np.float32)}
    with pytest.raises(ValueError) as ei:
        load_portable(template, path)
    msg = str(ei.value)
    assert "missing1" in msg and "missing2" in msg
    assert "extra" in msg
    assert "a/w" in msg and "(2, 2)" in msg and "(2, 3)" in msg


def test_load_portable_clean_roundtrip(tmp_path):
    path = str(tmp_path / "w.pt")
    params = {"a": {"w": np.arange(4, dtype=np.float32).reshape(2, 2)}}
    save_portable(params, path)
    out = load_portable({"a": {"w": np.zeros((2, 2), np.float32)}}, path)
    np.testing.assert_array_equal(out["a"]["w"].numpy(), params["a"]["w"])
    # a module's state dict round-trips through the same names
    model = R.ResNet18(num_classes=5, width=8)
    save_portable(model, path)
    back = load_portable(model.state_dict(), path)
    assert all(torch.equal(back[k], v)
               for k, v in model.state_dict().items())


def test_legacy_steps_survive_manifest_upgrade(tmp_path, monkeypatch):
    """A step saved before manifests is a valid restore point: when the
    newer manifested step is corrupt, restore falls back to it
    unverified instead of quarantining it."""
    d = str(tmp_path / "ckpt")
    monkeypatch.setenv("SPARKDL_CHECKPOINT_VERIFY", "0")
    m = CheckpointManager(d, async_save=False)
    m.save(1, _state(1.0), wait=True)
    m.close()
    monkeypatch.delenv("SPARKDL_CHECKPOINT_VERIFY")
    m2 = CheckpointManager(d, async_save=False)
    m2.save(2, _state(2.0), wait=True)
    assert corrupt_latest_checkpoint(d)
    np.testing.assert_array_equal(_w(m2.restore(_state(0.0))), 1.0)
    assert os.path.isdir(os.path.join(d, "1"))
    assert glob.glob(d + "/2.corrupt*")
    m2.close()


def test_uncommitted_partial_save_is_quarantined(tmp_path):
    d = str(tmp_path / "ckpt")
    m = CheckpointManager(d, async_save=False)
    m.save(1, _state(1.0), wait=True)
    m.save(2, _state(2.0), wait=True)
    os.unlink(os.path.join(d, "manifest_step_2.json"))  # died pre-commit
    np.testing.assert_array_equal(_w(m.restore(_state(0.0))), 1.0)
    assert glob.glob(d + "/2.corrupt*")
    m.close()


def test_restore_finalizes_inflight_async_save(tmp_path):
    d = str(tmp_path / "ckpt")
    m = CheckpointManager(d)
    m.save(1, _state(1.0), wait=True)
    m.save(2, _state(2.0), wait=False)
    np.testing.assert_array_equal(_w(m.restore(_state(0.0))), 2.0)
    assert not glob.glob(d + "/*.corrupt*")
    assert m.verify_step(2) == (True, "ok")
    m.close()


# --- the port's own properties -----------------------------------------------

def _trained_resnet(steps=2, seed=0):
    model = R.ResNet18(num_classes=5, width=8, seed=seed)
    state = TrainState.create(model, sgd(0.05, momentum=0.9))
    from sparkdl_tpu_torch.runner.train_state import make_train_step
    step = make_train_step(bn_classifier_loss(), mutable=True)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        step(state, {"image": torch.from_numpy(rng.uniform(
            0, 1, (4, 32, 32, 3)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, 5, 4))})
    return state


@pytest.mark.parametrize("async_save", [False, True])
def test_roundtrip_is_bit_identical(tmp_path, async_save):
    """Every model tensor (BatchNorm statistics included) and the
    optimizer's momentum buffers come back bit for bit; an asynchronous
    save holds the values of the moment it was called, though the next
    step updates the weights in place before the writer runs."""
    state = _trained_resnet()
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    want_opt = [state.optimizer.state[p]["momentum_buffer"].clone()
                for p in state.trainable()]
    m = CheckpointManager(str(tmp_path / "ckpt"), async_save=async_save)
    m.save(state.step, state)
    with torch.no_grad():  # the in-place update the hazard is about
        for p in state.model.parameters():
            p.add_(1.0)
        for buf in state.model.buffers():
            buf.add_(1.0)
    _wait(m)
    fresh = TrainState.create(R.ResNet18(num_classes=5, width=8, seed=9),
                              sgd(0.05, momentum=0.9))
    m.restore(fresh)
    assert fresh.step == 2
    got = fresh.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    got_opt = [fresh.optimizer.state[p]["momentum_buffer"]
               for p in fresh.trainable()]
    assert all(torch.equal(a, b) for a, b in zip(got_opt, want_opt))
    m.close()


def test_topology_mismatch_names_every_difference(tmp_path):
    """A restore into tensors of other names, shapes or dtypes raises
    CheckpointTopologyError naming each, before anything is copied."""
    m = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    m.save(1, _state(1.0), wait=True)
    other = TrainState.create(
        Linear(np.zeros((4, 5), np.float64), np.zeros(5, np.float32)),
        sgd(0.1))
    with pytest.raises(CheckpointTopologyError) as ei:
        m.restore(other)
    msg = str(ei.value)
    assert "w: saved (4, 3) float32, model (4, 5) float64" in msg
    assert "missing b" in msg and "topology mismatch" in msg
    assert "SPARKDL_ELASTIC" in msg
    assert np.all(other.model.w.detach().numpy() == 0)
    m.close()


def test_mutable_checkpoint_roundtrip_and_legacy(tmp_path):
    """Twin of test_runner.py::test_mutable_checkpoint_roundtrip_and_legacy:
    the BatchNorm statistics survive save/restore; a checkpoint saved
    without them restores into a model that has them and keeps the
    model's own."""
    from sparkdl_tpu_torch.models.image_layers import BatchNorm

    class TinyBN(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = torch.nn.Linear(4, 8)
            self.BatchNorm_0 = BatchNorm(8, 1e-5)
            self.Dense_1 = torch.nn.Linear(8, 3)

    src = TinyBN()
    with torch.no_grad():
        src.BatchNorm_0.running_mean.fill_(5.0)
    m = CheckpointManager(str(tmp_path / "a"), async_save=False)
    m.save(1, TrainState.create(src, sgd(0.1)), wait=True)
    fresh = TrainState.create(TinyBN(), sgd(0.1))
    m.restore(fresh)
    np.testing.assert_array_equal(
        fresh.model.BatchNorm_0.running_mean.numpy(), 5.0)
    m.close()

    class NoStats(torch.nn.Module):
        """TinyBN's parameters, no statistics (a pre-BatchNorm save)."""

        def __init__(self, like):
            super().__init__()
            self.Dense_0, self.Dense_1 = like.Dense_0, like.Dense_1
            self.BatchNorm_0 = torch.nn.Module()
            self.BatchNorm_0.weight = like.BatchNorm_0.weight
            self.BatchNorm_0.bias = like.BatchNorm_0.bias

    m2 = CheckpointManager(str(tmp_path / "b"), async_save=False)
    m2.save(1, TrainState.create(NoStats(src), sgd(0.1)), wait=True)
    fresh2 = TrainState.create(TinyBN(), sgd(0.1))
    m2.restore(fresh2)
    assert torch.equal(fresh2.model.Dense_0.weight, src.Dense_0.weight)
    np.testing.assert_array_equal(  # the model's own statistics kept
        fresh2.model.BatchNorm_0.running_mean.numpy(), 0.0)
    m2.close()


# --- twins of tests/test_runner.py's fit tests -------------------------------

def test_checkpoint_resume(tmp_path):
    """A second fit with the same checkpoint_dir resumes from the saved
    step: 3 more steps to 9, landing on the reference's uninterrupted
    9-step run of the same data."""
    ckpt = str(tmp_path / "ckpt")
    p = _problem(seed=4)
    kw = dict(loss_fn=softmax_cross_entropy_loss(), tx=sgd(0.1),
              checkpoint_every=3, log_every=100)
    r1 = XlaRunner(device="cpu", checkpoint_dir=ckpt).run(
        lambda ctx: ctx.fit(model=Linear(p["w"], p["b"]),
                            data=list(_data()), num_steps=6, **kw))
    assert r1["state"].step == 6
    r2 = XlaRunner(device="cpu", checkpoint_dir=ckpt).run(
        lambda ctx: ctx.fit(model=Linear(p["w"], p["b"]),
                            data=list(_data()), num_steps=9, **kw))
    assert r2["state"].step == 9
    assert r2["meter"].steps == 3
    ref = _jax_fit(p, list(_data()), 9)
    np.testing.assert_allclose(_w(r2["state"]), ref["w"], rtol=1e-5,
                               atol=1e-6)


def test_run_with_restarts_fault_injection(tmp_path):
    """main_fn dies once after its fit; the restart resumes from the
    checkpoint and finishes; a program error is not retried."""
    ckpt = str(tmp_path / "ckpt")
    p = _problem(seed=5)
    attempts = []

    def main(ctx):
        attempts.append(1)
        res = ctx.fit(loss_fn=softmax_cross_entropy_loss(),
                      model=Linear(p["w"], p["b"]), tx=sgd(0.1),
                      data=_data(), num_steps=4, checkpoint_every=2,
                      log_every=100)
        if len(attempts) == 1:
            raise RuntimeError("injected chip failure")
        return res

    metrics.run_stats.reset()
    res = XlaRunner(device="cpu", checkpoint_dir=ckpt).run_with_restarts(
        main, max_restarts=2, backoff_s=0.0)
    assert len(attempts) == 2 and res["state"].step == 4
    assert metrics.run_stats.restarts == 1

    def bad(ctx):
        attempts.append(1)
        raise ValueError("the user's bug")

    with pytest.raises(ValueError):
        XlaRunner(device="cpu").run_with_restarts(bad, backoff_s=0.0)
    assert len(attempts) == 3
    metrics.run_stats.reset()


def test_restart_resumes_mid_fit_from_an_injected_preemption(tmp_path):
    """A preemption injected at step 3 (chaos site ``step_start``) fails
    the fit after its step-2 save; the restart resumes there with the
    dataset's cursor, and the result equals the reference's
    uninterrupted 5-step run."""
    ckpt = str(tmp_path / "ckpt")
    p = _problem(seed=6)
    batches = list(_data(n_batches=5))
    chaos.install(chaos.FaultPlan([chaos.Fault("step_start", "preempt",
                                               at_step=3)]))
    try:
        res = XlaRunner(device="cpu", checkpoint_dir=ckpt) \
            .run_with_restarts(lambda ctx: ctx.fit(
                loss_fn=softmax_cross_entropy_loss(),
                model=Linear(p["w"], p["b"]), tx=sgd(0.1),
                data=D.ListDataset(batches), num_steps=5,
                checkpoint_every=2, log_every=100), backoff_s=0.0)
    finally:
        chaos.uninstall()
    assert res["state"].step == 5 and res["meter"].steps == 3
    ref = _jax_fit(p, batches, 5)
    np.testing.assert_allclose(_w(res["state"]), ref["w"], rtol=1e-5,
                               atol=1e-6)


def test_fit_feed_lookahead_matches_inline():
    """feed_lookahead=2 consumes the same batches in the same order and
    lands on bit-identical parameters, with accum cropping active (a
    skipped tail batch does not desync the step count)."""
    p = _problem(seed=6)
    kw = dict(loss_fn=softmax_cross_entropy_loss(), tx=sgd(0.1),
              log_every=100, accum_steps=2)

    def ragged(seed):
        yield from _data(n_batches=6, seed=seed)
        yield {"image": np.ones((3, 4), np.float32),
               "label": np.zeros((3,), np.int64)}

    r_inline = XlaRunner(device="cpu").run(lambda ctx: ctx.fit(
        model=Linear(p["w"], p["b"]), data=ragged(7), num_steps=10,
        feed_lookahead=0, **kw))
    r_ahead = XlaRunner(device="cpu").run(lambda ctx: ctx.fit(
        model=Linear(p["w"], p["b"]), data=ragged(7), num_steps=10,
        feed_lookahead=2, **kw))
    assert r_inline["state"].step == r_ahead["state"].step == 7
    for a, b in zip(r_inline["state"].model.parameters(),
                    r_ahead["state"].model.parameters()):
        assert torch.equal(a, b)


def test_fit_lookahead_never_overconsumes_iterator():
    """A reused iterator sits where the inline feed would leave it: the
    lookahead draws no batch the loop will not run."""
    p = _problem(seed=8)
    it = _data(n_batches=10)
    XlaRunner(device="cpu").run(lambda ctx: ctx.fit(
        loss_fn=softmax_cross_entropy_loss(), model=Linear(p["w"], p["b"]),
        tx=sgd(0.1), data=it, num_steps=4, feed_lookahead=3,
        log_every=100))
    assert sum(1 for _ in it) == 6


def test_resumed_resnet_equals_uninterrupted_run(tmp_path):
    """On the CPU a mutable ResNet run resumed from step 2 (model,
    BatchNorm statistics, momentum, data cursor) gives the same
    parameters and statistics as an uninterrupted 4-step run, bit for
    bit."""
    rng = np.random.default_rng(3)
    batches = [{"image": rng.uniform(0, 1, (4, 32, 32, 3)
                                     ).astype(np.float32),
                "label": rng.integers(0, 5, 4)} for _ in range(6)]
    kw = dict(loss_fn=bn_classifier_loss(), tx=sgd(0.05, momentum=0.9),
              mutable=True, log_every=1)

    def model():
        return R.ResNet18(num_classes=5, width=8, seed=2)

    whole = XlaRunner(device="cpu").run(lambda ctx: ctx.fit(
        model=model(), data=D.ListDataset(batches), num_steps=4, **kw))
    ckpt = str(tmp_path / "ckpt")
    XlaRunner(device="cpu", checkpoint_dir=ckpt).run(lambda ctx: ctx.fit(
        model=model(), data=D.ListDataset(batches), num_steps=2,
        checkpoint_every=2, **kw))
    resumed = XlaRunner(device="cpu", checkpoint_dir=ckpt).run(
        lambda ctx: ctx.fit(model=model(), data=D.ListDataset(batches),
                            num_steps=4, **kw))
    assert resumed["meter"].steps == 2
    a, b = whole["state"].model.state_dict(), \
        resumed["state"].model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert [h["loss"] for h in whole["history"]][2:] == \
        [h["loss"] for h in resumed["history"]]


def test_data_cursor_rides_the_manifest(tmp_path):
    """A dataset's cursor is saved with each step, CRC'd, and a mismatch
    makes ``data_cursor`` return None (recorded, not raised)."""
    ckpt = str(tmp_path / "ckpt")
    p = _problem()
    XlaRunner(device="cpu", checkpoint_dir=ckpt).run(lambda ctx: ctx.fit(
        loss_fn=softmax_cross_entropy_loss(), model=Linear(p["w"], p["b"]),
        tx=adam(1e-2), data=D.ListDataset(list(_data(n_batches=5))),
        num_steps=3, checkpoint_every=2, log_every=100))
    m = CheckpointManager(ckpt)
    assert m.latest_step() == 3
    assert m.data_cursor(2)["batch_index"] == 2
    assert m.data_cursor(3)["batch_index"] == 3
    path = os.path.join(ckpt, "manifest_step_3.json")
    with open(path) as f:
        man = json.load(f)
    man["data_cursor"]["batch_index"] = 1
    with open(path, "w") as f:
        json.dump(man, f)
    assert m.data_cursor(3) is None
    m.close()


def test_profile_dir_writes_a_trace(tmp_path):
    p = _problem()
    out = tmp_path / "prof"
    XlaRunner(device="cpu").run(lambda ctx: ctx.fit(
        loss_fn=softmax_cross_entropy_loss(), model=Linear(p["w"], p["b"]),
        tx=sgd(0.1), data=list(_data(n_batches=2)), num_steps=2,
        profile_dir=str(out), log_every=100))
    trace = json.loads((out / "trace_rank0.json").read_text())
    assert trace["traceEvents"]
