"""Data parallelism in the port (``XlaRunner`` gangs over
``torch.distributed``, the two gang steps, synchronised BatchNorm, the
hvd-compat module, ``shard=True`` datasets, checkpoints of a gang)
against the JAX package, on the CPU.

Gangs of two gloo ranks are started by ``runner.launcher.launch`` on
``tests/test_torch_gang_worker.py`` (torch, numpy and the port only);
each rank writes what it computed, and this module holds it against the
JAX package's reference, computed here on the conftest's 8 CPU devices.

Tolerances:
- The linear classifier (the twin of
  ``tests/test_multiprocess.py::test_two_process_train_and_collectives``):
  3 SGD steps on each rank's half against one process over the global
  batch, rtol 2e-5 and atol 2e-6 (the reference's); the hvd values exact.
- Narrow ResNet18 (width 8, 32², a global batch of 8 as 2 × 4,
  ``sgd(0.01, momentum=0.9)``), one mutable step: the largest parameter
  error as a share of the largest change the reference's step made ≤ 5e-4
  and the same share over the running statistics ≤ 1e-4, the limits of
  ``tests/test_torch_resnet_train.py``. The two references differ by
  more than that, so a port step held against the other step's
  reference fails.
- Synchronised BatchNorm at world size 1 against flax in train mode: the
  rules of ``test_torch_resnet_train.py``'s one-layer test.
- Within a gang, what must be bitwise: the two ranks' states, ``remat``
  against none, a resumed run against a straight one.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json
import os
from pathlib import Path

import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
import flax.linen as fnn
from sparkdl_tpu.models import resnet as JRN
from sparkdl_tpu.runner import train_state as JTS
from sparkdl_tpu.runner.xla_runner import XlaRunner as JaxRunner
from sparkdl_tpu_torch.models import resnet as R
from sparkdl_tpu_torch.models.image_layers import BatchNorm, sync_batch_stats
from sparkdl_tpu_torch.models.registry import (flax_to_state_dict,
                                               load_flax_variables)
from sparkdl_tpu_torch.runner import (CheckpointManager, TrainState,
                                      XlaRunner, bn_classifier_loss,
                                      launcher, sgd)
from sparkdl_tpu_torch.runner.checkpoint import CheckpointTopologyError
from sparkdl_tpu_torch.runner.data import ListDataset

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("test_torch_gang_worker.py")
WIDTH, SIZE, CLASSES, GLOBAL, LR = 8, 32, 10, 8, 0.01
PARAM_SHARE, STAT_SHARE = 5e-4, 1e-4


def _gang(mode, in_dir, out_dir, np_=2):
    env = {"OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(ROOT) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    launcher.launch(str(WORKER), np=np_,
                    args=[mode, str(in_dir), str(out_dir)], env=env,
                    timeout_s=120.0, capture=True)
    return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False)
            for r in range(np_)]


# --- the linear classifier: twin of test_two_process_train_and_collectives --

def test_two_rank_gang_trains_like_one_process_over_the_global_batch(
        tmp_path, monkeypatch):
    """Two gloo ranks, each on its half of every batch, end where one
    process over the global batch ends (the reference, JAX); then
    ``api.allreduce`` sums to 3.0 and averages to 1.5, and
    ``broadcast(root_rank=1)`` gives 17.0 on both ranks. A gang fit's
    ``SPARKDL_MFU_ESTIMATE`` count (the rank's count times the gang's
    size) equals one process's count over the global batch."""
    rng = np.random.RandomState(0)
    dim, classes, gbs = 4, 3, 8
    w = rng.randn(dim, classes).astype(np.float32)
    b = np.zeros((classes,), np.float32)
    xs = rng.randn(3, gbs, dim).astype(np.float32)
    ys = rng.randint(0, classes, size=(3, gbs))
    np.savez(tmp_path / "linear.npz", w=w, b=b, x=xs, y=ys)

    p = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    for x, y in zip(xs, ys):
        def loss(q):
            logits = jnp.asarray(x) @ q["w"] + q["b"]
            return optax.softmax_cross_entropy(
                logits, jax.nn.one_hot(y, classes)).mean()
        g = jax.grad(loss)(p)
        p = jax.tree_util.tree_map(lambda a, d: a - 0.1 * d, p, g)

    outs = _gang("linear", tmp_path, tmp_path)
    for out in outs:
        np.testing.assert_allclose(out["w"].numpy(), np.asarray(p["w"]),
                                   rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(out["b"].numpy(), np.asarray(p["b"]),
                                   rtol=2e-5, atol=2e-6)
        assert float(out["hvd_sum"]) == 3.0
        assert float(out["hvd_mean"]) == 1.5
        assert float(out["hvd_bcast"]) == 17.0
        assert out["hvd_size"] == 2
    assert [o["hvd_rank"] for o in outs] == [0, 1]
    # the step's loss is the gang's mean: the same on both ranks
    assert torch.equal(outs[0]["losses"], outs[1]["losses"])
    from sparkdl_tpu_torch.runner import softmax_cross_entropy_loss
    monkeypatch.setenv("SPARKDL_MFU_ESTIMATE", "1")
    one = XlaRunner(device="cpu").run(lambda ctx: ctx.fit(
        loss_fn=softmax_cross_entropy_loss(),
        model=torch.nn.Linear(dim, classes), tx=sgd(0.1), num_steps=1,
        data=[{"image": xs[0], "label": ys[0]}]))
    assert one["meter"].flops_per_step == 2 * 2 * gbs * dim * classes
    assert [o["fit_flops"] for o in outs] == [one["meter"].flops_per_step] * 2


# --- narrow ResNet18: the two gang steps against their references ----------

def _variables(seed=0):
    """Flax variables of the narrow ResNet18 at flax's shapes: kernels
    lecun-scaled normals, every BatchNorm term and statistic random."""
    model = JRN.ResNet(stage_sizes=[2, 2, 2, 2], block=JRN.BasicBlock,
                       width=WIDTH, num_classes=CLASSES)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf, shape = path[-1].key, s.shape
        if leaf == "kernel":
            return (rng.standard_normal(shape)
                    / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(rows=GLOBAL, seed=1):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0, 1, (rows, SIZE, SIZE, 3)
                                 ).astype(np.float32),
            "label": rng.integers(0, CLASSES, rows)}


def _jax_step(model, v, batch, explicit):
    """One step of the reference ``XlaRunner(np=2)``: its implicit
    ``make_train_step(mutable=True)`` or, with ``explicit``,
    ``make_shard_map_step(mutable=True)``; the new state as a port state
    dict."""
    def main(ctx):
        st = JTS.TrainState.create(
            None, v["params"], optax.sgd(LR, momentum=0.9),
            model_state={"batch_stats": v["batch_stats"]})
        st = ctx.put_replicated(st)
        step = ctx.make_train_step(JTS.bn_classifier_loss(model),
                                   explicit_collectives=explicit,
                                   mutable=True)
        st, _ = step(st, ctx.shard_batch(batch))
        return jax.tree_util.tree_map(
            np.asarray, {"params": st.params, **st.model_state})

    return flax_to_state_dict(JaxRunner(np=2).run(main))


def _shares(own, ref, before):
    """(params, stats): the largest |own − ref| as a share of the largest
    change the reference's step made, over the parameters and over the
    running statistics (``test_torch_resnet_train.py``'s measure)."""
    out = []
    for stats in (False, True):
        keys = [k for k in ref if ("running" in k) == stats]
        upd = max((ref[k] - before[k]).abs().max().item() for k in keys)
        err = max((own[k] - ref[k]).abs().max().item() for k in keys)
        out.append(err / upd)
    return out


@pytest.fixture(scope="module")
def resnet_gang(tmp_path_factory):
    """The ``resnet`` worker's two ranks and the two references, from one
    carried state and one global batch."""
    d = tmp_path_factory.mktemp("resnet_gang")
    model, v = _variables()
    init = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, v))
    torch.save(init, d / "init.pt")
    batch = _batch()
    np.savez(d / "batch.npz", **batch)
    refs = {name: _jax_step(model, v, batch, explicit=name == "explicit")
            for name in ("implicit", "explicit")}
    return _gang("resnet", d, d), refs, init


@pytest.mark.parametrize("step", ["implicit", "explicit"])
def test_gang_step_matches_its_reference(resnet_gang, step):
    """The implicit gang step (synchronised BatchNorm) against the
    reference's implicit step, the explicit one (each rank's own
    statistics, averaged running statistics) against
    ``make_shard_map_step``; both ranks equal to the bit."""
    outs, refs, init = resnet_gang
    for out in outs:
        p, s = _shares(out[step], refs[step], init)
        assert p <= PARAM_SHARE, (step, p)
        assert s <= STAT_SHARE, (step, s)
    for k, t in outs[0][step].items():
        assert torch.equal(t, outs[1][step][k]), k


def test_the_two_references_differ_beyond_the_limits(resnet_gang):
    """At 4 rows a rank, global and per-rank BatchNorm statistics differ
    by more than the parity limits, so a port step swapped for the
    other (or BatchNorm left unsynchronised) fails its test."""
    outs, refs, init = resnet_gang
    p, s = _shares(refs["explicit"], refs["implicit"], init)
    assert p > PARAM_SHARE and s > STAT_SHARE, (p, s)
    p, s = _shares(outs[0]["explicit"], refs["implicit"], init)
    assert p > PARAM_SHARE and s > STAT_SHARE, (p, s)


def test_gang_step_behaviour(resnet_gang):
    """``remat`` leaves the state bitwise as without it (the statistics
    updated once, the recomputed forward's collectives in step on both
    ranks); the explicit step refuses ``accum_steps``; ``with_rng`` hands
    the loss rank r's window of the global batch (rows 4r..4r+4 of 8);
    ranks seeded differently start equal after ``put_replicated``."""
    outs, _, _ = resnet_gang
    for r, out in enumerate(outs):
        for k, t in out["implicit"].items():
            assert torch.equal(t, out["remat"][k]), k
        assert "explicit_collectives" in out["explicit_accum_refusal"]
        assert out["with_rng_window"] == [("RowWindow", 4 * r, GLOBAL)]
        assert out["replicated"]


# --- a gang's fit with checkpoints ----------------------------------------

@pytest.fixture(scope="module")
def fit_gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("fit_gang")
    rng = np.random.default_rng(5)
    np.savez(d / "fit.npz",
             x=rng.uniform(0, 1, (4, GLOBAL, SIZE, SIZE, 3)).astype(
                 np.float32),
             y=rng.integers(0, CLASSES, (4, GLOBAL)))
    return d, _gang("fit", d, d)


def test_gang_fit_checkpoints_on_rank_0_and_resumes_bitwise(fit_gang):
    """``fit(checkpoint_every=2)`` in a two-rank gang over a
    ``shard=True`` dataset: rank 0 writes each step once (rank 1 never),
    the manifest records world size 2, a run of 2 steps resumed to 4
    ends bitwise where 4 straight steps end, on both ranks; the meter
    counts the gang's rows over two chips."""
    d, outs = fit_gang
    assert outs[0]["writes_straight"] == [2, 4]
    assert outs[0]["writes"] == [2, 4, 2, 4]
    assert outs[1]["writes"] == []
    for out in outs:
        assert out["steps_run"] == [4, 2, 2]
        for k, t in out["straight"].items():
            assert torch.equal(t, out["resumed"][k]), k
        assert out["n_chips"] == 2
        assert out["examples"] == 3 * GLOBAL  # 4 steps, one warm-up
        assert all(np.isfinite(out["losses"]))
    assert outs[0]["losses"] == outs[1]["losses"]
    for k, t in outs[0]["straight"].items():
        assert torch.equal(t, outs[1]["straight"][k]), k
    man = json.loads((d / "straight" / "manifest_step_4.json").read_text())
    assert man["topology"]["world_size"] == 2
    assert man["data_cursor"]["batch_index"] == 4


def test_gang_checkpoint_refuses_a_one_process_restore(fit_gang):
    """A checkpoint written by a gang of 2 raises
    ``CheckpointTopologyError`` (naming both world sizes and
    ``SPARKDL_ELASTIC``) when one process restores it."""
    d, _ = fit_gang
    model = R.ResNet(stage_sizes=[2, 2, 2, 2], block=R.BasicBlock,
                     width=WIDTH, num_classes=CLASSES)
    with pytest.raises(CheckpointTopologyError,
                       match="world size 2, restoring at 1") as ei:
        CheckpointManager(str(d / "straight")).restore(
            TrainState.create(model, sgd(LR, momentum=0.9)))
    assert "topology mismatch" in str(ei.value)
    assert "SPARKDL_ELASTIC" in str(ei.value)


# --- synchronised BatchNorm at world size 1, in this process ----------------

@pytest.fixture
def one_rank_group():
    """A one-rank gloo process group over an in-memory store, destroyed
    after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 5, 5, 6), (16, 6)])
def test_sync_batchnorm_matches_flax(one_rank_group, shape, dtype):
    """``BatchNorm(train=True)`` inside ``sync_batch_stats`` (one rank):
    the output, the gradients of the input, scale and bias, and the new
    running statistics equal flax's train mode, f32 and bf16, conv and
    dense inputs; the layer leaves its buffers alone and the sync switch
    off on the way out."""
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.standard_normal(c).astype(np.float32)},
         "batch_stats": {"mean": rng.standard_normal(c).astype(np.float32),
                         "var": rng.uniform(0.5, 2, c).astype(np.float32)}}
    jdt = jnp.dtype(dtype)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jdt)

    def f(params, xx):
        y, nv = bn.apply({"params": params,
                          "batch_stats": v["batch_stats"]}, xx,
                         mutable=["batch_stats"])
        return (y.astype(jnp.float32) * g).sum(), (y, nv)

    xj = jnp.asarray(x, jdt)
    (_, (y, nv)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], xj)

    def to_model(a):  # NHWC / NC → the layer's NCHW channels-last / NC
        t = torch.from_numpy(np.asarray(a, np.float32))
        return t.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last) if t.ndim == 4 else t

    def from_model(t):
        t = t.detach().float()
        return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()

    tdt = getattr(torch, dtype)
    layer = BatchNorm(c, 1e-5, momentum=0.9)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        layer.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        layer.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        layer.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    xt = to_model(xj.astype(jnp.float32)).to(tdt).requires_grad_()
    with sync_batch_stats(layer, one_rank_group):
        assert layer.sync_group is one_rank_group
        yt, (mean, var) = layer(xt, train=True)
    assert layer.sync_group is None
    assert yt.dtype == tdt and mean.dtype == var.dtype == torch.float32
    (yt.float() * to_model(g)).sum().backward()
    assert torch.equal(layer.running_mean,
                       torch.from_numpy(v["batch_stats"]["mean"]))

    def close(got, ref, atol_share, rtol):
        ref = np.asarray(ref, np.float32)
        atol = atol_share * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(np.asarray(got, np.float32), ref,
                                   atol=atol, rtol=rtol)

    if dtype == "float32":
        close(from_model(yt), y, 1e-5, 1e-5)
        close(from_model(xt.grad), gx, 1e-5, 1e-5)
        close(layer.weight.grad, gp["scale"], 1e-4, 1e-5)
        close(layer.bias.grad, gp["bias"], 1e-4, 1e-5)
    else:
        close(from_model(yt), y.astype(jnp.float32), 2.0 ** -6, 0)
        close(from_model(xt.grad), gx.astype(jnp.float32), 2.0 ** -6, 0)
        close(layer.weight.grad, gp["scale"], 1e-3, 1e-3)
        close(layer.bias.grad, gp["bias"], 1e-3, 1e-3)
    close(mean, nv["batch_stats"]["mean"], 1e-5, 1e-5)
    close(var, nv["batch_stats"]["var"], 1e-5, 1e-5)


def test_sync_step_at_one_rank_matches_the_one_process_step(one_rank_group):
    """The implicit gang step at world size 1 (synchronised BatchNorm and
    the gradient all-reduce) against ``make_train_step`` in one process,
    from one carried state: the shares of the single-process ResNet
    tests (the two BatchNorms compute the variance differently, so not
    bitwise)."""
    from sparkdl_tpu_torch.runner import make_train_step

    _, v = _variables()
    batch = {k: torch.from_numpy(np.asarray(x))
             for k, x in _batch(4, seed=3).items()}
    states = []
    for group in (None, one_rank_group):
        m = load_flax_variables(
            R.ResNet(stage_sizes=[2, 2, 2, 2], block=R.BasicBlock,
                     width=WIDTH, num_classes=CLASSES), v)
        before = {k: t.clone() for k, t in m.state_dict().items()}
        st = TrainState.create(m, sgd(LR, momentum=0.9))
        make_train_step(bn_classifier_loss(), mutable=True,
                        group=group)(st, batch)
        states.append(m.state_dict())
    p, s = _shares(states[1], states[0], before)
    assert p <= PARAM_SHARE and s <= STAT_SHARE, (p, s)


# --- runner identity and refusals, in this process -------------------------

def test_np_above_one_needs_a_gang():
    """``np > 1`` with no rendezvous raises ``ValueError`` naming
    ``launcher.launch`` (one process drives one device here); a gang
    whose size is not ``np`` raises before it joins."""
    with pytest.raises(ValueError, match="launcher.launch"):
        XlaRunner(np=2, device="cpu")
    with pytest.raises(ValueError, match="the gang has 3"):
        XlaRunner(np=2, device="cpu", coordinator="127.0.0.1:1",
                  num_processes=3, process_id=0)
    with pytest.raises(ValueError, match="outside a gang"):
        XlaRunner(device="cpu", coordinator="127.0.0.1:1",
                  num_processes=2, process_id=2)
    ctx = XlaRunner(device="cpu").make_context()
    assert (ctx.size, ctx.rank, ctx.num_processes,
            ctx.local_device_count) == (1, 0, 1, 1)
    assert ctx.meter().n_chips == 1


def test_np_beyond_the_cards_raises_before_the_rendezvous(monkeypatch):
    """On the card, a gang larger than the visible devices raises
    ``ValueError`` before any process group is made (here with two cards
    faked visible, np=3)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="exceeds visible devices"):
        XlaRunner(np=3, coordinator="127.0.0.1:1", num_processes=3,
                  process_id=0)
    assert not dist.is_initialized()


def test_hvd_api_in_one_process():
    """``runner.api`` in one process: size 1, rank 0, ``allreduce`` the
    identity (mean) or ``x·size`` (sum), ``broadcast`` the identity, as
    numpy; ``shutdown`` drops the context ``init`` made."""
    from sparkdl_tpu_torch.runner import api, current_context

    with pytest.raises(RuntimeError, match="init"):
        api.size()
    ctx = api.init(device="cpu")
    try:
        assert current_context() is ctx
        assert (api.size(), api.rank(), api.local_rank()) == (1, 0, 0)
        x = np.arange(3, dtype=np.float32)
        np.testing.assert_array_equal(api.allreduce(x), x)
        np.testing.assert_array_equal(api.allreduce(x, average=False), x)
        out = api.broadcast(np.float32(7))
        assert isinstance(out, np.ndarray) and float(out) == 7.0
    finally:
        api.shutdown()
    assert current_context() is None


# --- twins of tests/test_data.py::test_rank_sharding_is_opt_in ------------

def _data_batches(n, rows=8):
    return [{"image": np.random.RandomState(i).randn(rows, 4)
             .astype(np.float32),
             "label": np.random.RandomState(i).randint(0, 3, (rows,))}
            for i in range(n)]


def test_rank_sharding_is_opt_in(monkeypatch):
    """Twin of ``tests/test_data.py::test_rank_sharding_is_opt_in``: by
    default a batch is the rank's already; ``shard=True`` cuts rank 1's
    contiguous half from the global stream, the cursor stays global, and
    a leaf that cannot be sliced is replicated."""
    monkeypatch.setenv("SPARKDL_NUM_PROCESSES", "2")
    monkeypatch.setenv("SPARKDL_PROCESS_ID", "1")
    _, untouched = next(ListDataset(_data_batches(2)).indexed())
    assert len(untouched["image"]) == 8
    ds = ListDataset(_data_batches(2), shard=True)
    cur, local = next(ds.indexed())
    assert len(local["image"]) == 4
    np.testing.assert_array_equal(local["image"],
                                  _data_batches(2)[0]["image"][4:])
    assert cur["batch_index"] == 1
    ds2 = ListDataset([{"x": np.ones((8, 2), np.float32), "frac": 0.5}],
                      shard=True)
    _, b = next(ds2.indexed())
    assert b["frac"] == 0.5 and len(b["x"]) == 4


@pytest.mark.parametrize("world,rank", [(1, 0), (3, 0), (3, 2)])
def test_shard_rows_cut_and_crop(monkeypatch, world, rank):
    """``shard=True`` at other gang sizes: each rank takes ``rows //
    world`` contiguous rows (the remainder cropped); outside a gang the
    batch is untouched."""
    monkeypatch.setenv("SPARKDL_NUM_PROCESSES", str(world))
    monkeypatch.setenv("SPARKDL_PROCESS_ID", str(rank))
    full = _data_batches(1, rows=8)[0]
    _, got = next(ListDataset([full], shard=True).indexed())
    per = 8 // world
    want = full["label"][rank * per:(rank + 1) * per] if world > 1 \
        else full["label"]
    np.testing.assert_array_equal(got["label"], want)
