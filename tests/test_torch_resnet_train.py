"""ResNet training in the port (BatchNorm in train mode, the mutable train
step, ``bn_classifier_loss``, ``softmax_cross_entropy_loss``, ``sgd``)
against the JAX package's, on the CPU.

Inputs and flax variables are made from numpy seeds (variables at the
shapes flax's ``init`` gives, traced with ``jax.eval_shape``: kernels
lecun-scaled normals, every BatchNorm term and statistic random) and go
into both packages (``registry.load_flax_variables``); afterwards the
port's ``state_dict()`` is held against the reference's new ``params``
and ``batch_stats`` mapped through ``registry.flax_to_state_dict``.

Tolerances:
- One BatchNorm layer in train mode against flax's, f32: the output, the
  input's gradient and the new statistics within 1e-5·max(1, max|ref|) +
  1e-5·|ref|; the scale and bias gradients, sums over all 200 positions,
  within 1e-4·max(1, max|ref|) + 1e-5·|ref| (measured ≤ 3e-5 absolute).
  bf16 compute: the output and the input's gradient within
  2^-6·max(1, max|ref|) (each rounds to bf16 at other points; one bf16
  step at the largest gradient is 2^-7 of it), the f32 parameter
  gradients within 1e-3·max(1, max|ref|) + 1e-3·|ref|, the statistics as
  in f32. flax computes the variance as E[x²] − E[x]² and the port from
  ``invstd``, so the two agree to f32 rounding, not bit for bit.
- Mutable SGD steps of a narrow ResNet18 and a narrow bottleneck ResNet
  (width 8, 32², batch 8, ``sgd(0.01, momentum=0.9)``): the largest
  parameter error as a share of the largest change the reference's step
  made, ≤ 5e-4 (measured ≤ 3.1e-5), and the same share over the running
  statistics, ≤ 1e-4 (measured ≤ 1.1e-5). Step 1 starts from the carried
  variables, step 4 from the reference's state after step 3 (its
  momentum trace carried into the optimizer). A free-running comparison
  over 4 steps is not a test of the port: the two packages round
  differently, a ReLU or max-pool decision near a tie then routes one
  gradient element elsewhere and moves a whole kernel's gradient by
  about 1/sqrt(positions), and SGD carries that on (measured 1–5 % of
  the update after 4 steps here).
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn
from sparkdl_tpu.core import runtime as jruntime
from sparkdl_tpu.models import resnet as JRN
from sparkdl_tpu.runner import train_state as JTS
from sparkdl_tpu_torch.models import resnet as R
from sparkdl_tpu_torch.models.image_layers import BatchNorm
from sparkdl_tpu_torch.models.registry import (flax_to_state_dict,
                                               load_flax_variables)
from sparkdl_tpu_torch.runner import (TrainState, XlaRunner,
                                      bn_classifier_loss, make_train_step,
                                      sgd, softmax_cross_entropy_loss)

# --- one BatchNorm layer -----------------------------------------------------


def _bn_case(momentum, dtype, seed=0, shape=(8, 5, 5, 6)):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.standard_normal(c).astype(np.float32)},
         "batch_stats": {"mean": rng.standard_normal(c).astype(np.float32),
                         "var": rng.uniform(0.5, 2, c).astype(np.float32)}}
    return x, g, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum", [0.9, 0.99, 0.9997])
def test_batchnorm_train_mode_matches_flax(momentum, dtype):
    """The output, the gradients of the input, scale and bias, and the new
    running statistics of one BatchNorm in train mode, f32 and bf16
    compute, at each reference model's momentum (ResNet, Xception,
    InceptionV3)."""
    x, g, v = _bn_case(momentum, dtype)
    jdt = jnp.dtype(dtype)
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum,
                       epsilon=1e-5, dtype=jdt)

    def f(params, xx):
        y, nv = bn.apply({"params": params,
                          "batch_stats": v["batch_stats"]}, xx,
                         mutable=["batch_stats"])
        return (y.astype(jnp.float32) * g).sum(), (y, nv)

    xj = jnp.asarray(x, jdt)
    (_, (y, nv)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], xj)

    tdt = getattr(torch, dtype)
    layer = BatchNorm(x.shape[-1], 1e-5, momentum=momentum)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        layer.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        layer.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        layer.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).permute(
        0, 3, 1, 2).to(dtype=tdt, memory_format=torch.channels_last)
    xt.requires_grad_()
    yt, (mean, var) = layer(xt, train=True)
    assert yt.dtype == tdt and mean.dtype == var.dtype == torch.float32
    (yt.float() * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    # the buffers are untouched: the step copies the new values in
    assert torch.equal(layer.running_mean,
                       torch.from_numpy(v["batch_stats"]["mean"]))

    def nhwc(t):
        return t.detach().float().permute(0, 2, 3, 1).numpy()

    def close(got, ref, atol_share, rtol):
        ref = np.asarray(ref, np.float32)
        atol = atol_share * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(np.asarray(got, np.float32), ref,
                                   atol=atol, rtol=rtol)

    if dtype == "float32":
        close(nhwc(yt), y, 1e-5, 1e-5)
        close(nhwc(xt.grad), gx, 1e-5, 1e-5)
        close(layer.weight.grad, gp["scale"], 1e-4, 1e-5)
        close(layer.bias.grad, gp["bias"], 1e-4, 1e-5)
    else:
        close(nhwc(yt), y.astype(jnp.float32), 2.0 ** -6, 0)
        close(nhwc(xt.grad), gx.astype(jnp.float32), 2.0 ** -6, 0)
        close(layer.weight.grad, gp["scale"], 1e-3, 1e-3)
        close(layer.bias.grad, gp["bias"], 1e-3, 1e-3)
    close(mean, nv["batch_stats"]["mean"], 1e-5, 1e-5)
    close(var, nv["batch_stats"]["var"], 1e-5, 1e-5)


def test_batchnorm_inference_mode_is_unchanged():
    """``train=False`` (the default) is the scoring path's F.batch_norm on
    the running statistics, bit for bit."""
    layer = BatchNorm(6, 1e-5)
    with torch.no_grad():
        layer.running_mean.normal_(generator=torch.Generator().manual_seed(1))
        layer.running_var.uniform_(0.5, 2.0)
    x = torch.randn(4, 6, 3, 3, generator=torch.Generator().manual_seed(2))
    want = torch.nn.functional.batch_norm(
        x, layer.running_mean, layer.running_var, layer.weight, layer.bias,
        False, 0.0, 1e-5)
    assert torch.equal(layer(x), want)


# --- narrow ResNets ----------------------------------------------------------

ARCHS = {"resnet18": ([2, 2, 2, 2], JRN.BasicBlock, R.BasicBlock),
         "bottleneck": ([1, 1, 1, 1], JRN.BottleneckBlock,
                        R.BottleneckBlock)}
WIDTH, SIZE, BATCH, CLASSES, LR = 8, 32, 8, 10, 0.01


@functools.lru_cache(maxsize=None)
def _flax_shapes(arch):
    sizes, jblock, _ = ARCHS[arch]
    model = JRN.ResNet(stage_sizes=sizes, block=jblock, width=WIDTH,
                       num_classes=CLASSES)
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))


def _variables(arch, seed=0):
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf, shape = path[-1].key, s.shape
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)
                    ).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, _flax_shapes(arch))


def _batches(n, seed=1, rows=BATCH):
    rng = np.random.default_rng(seed)
    return [{"image": rng.uniform(0, 1, (rows, SIZE, SIZE, 3)
                                  ).astype(np.float32),
             "label": rng.integers(0, CLASSES, rows)} for _ in range(n)]


def _port_model(arch, variables):
    sizes, _, block = ARCHS[arch]
    m = R.ResNet(stage_sizes=sizes, block=block, width=WIDTH,
                 num_classes=CLASSES)
    return load_flax_variables(m, variables)


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_trajectory(arch, n_steps=4):
    """The reference's mutable step (``make_train_step(bn_classifier_loss,
    mutable=True)`` on a one-device mesh, ``optax.sgd(LR, 0.9)``): the
    state before the first step and after each, as ``(port state dict,
    momentum trace by port parameter name)``."""
    sizes, jblock, _ = ARCHS[arch]
    model = JRN.ResNet(stage_sizes=sizes, block=jblock, width=WIDTH,
                       num_classes=CLASSES)
    v = _variables(arch)
    mesh = jruntime.make_mesh({"data": 1}, jax.devices()[:1])
    st = JTS.TrainState.create(None, v["params"],
                               optax.sgd(LR, momentum=0.9),
                               model_state={"batch_stats": v["batch_stats"]})
    step = JTS.make_train_step(JTS.bn_classifier_loss(model), mesh,
                               mutable=True)

    def snap(st):
        host = jax.tree_util.tree_map(np.asarray, (
            {"params": st.params, **st.model_state}, st.opt_state[0].trace))
        return (flax_to_state_dict(host[0]),
                flax_to_state_dict({"params": host[1]}))

    out = [snap(st)]
    with mesh:
        for b in _batches(n_steps):
            st, _ = step(st, b)
            out.append(snap(st))
    return out


def _shares(own, ref, before):
    """(params, stats): the largest |own − ref| as a share of the largest
    change the reference's step made, |ref − before|, over the parameters
    and over the running statistics."""
    out = []
    for stats in (False, True):
        keys = [k for k in ref if ("running" in k) == stats]
        upd = max((ref[k] - before[k]).abs().max().item() for k in keys)
        err = max((own[k] - ref[k]).abs().max().item() for k in keys)
        out.append(err / upd)
    return out


@pytest.mark.parametrize("step_no", [1, 4])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_resnet_mutable_steps_match_flax(arch, step_no):
    """Parameters and BatchNorm statistics after mutable SGD steps
    (momentum 0.9) equal the reference's within the module's tolerances:
    step 1 from the carried variables, and step 4 from the reference's
    state after step 3, its momentum trace carried into the optimizer
    (so the step that uses a momentum buffer is held too)."""
    traj = _jax_trajectory(arch)
    before, trace = traj[step_no - 1]
    model = _port_model(arch, _variables(arch))
    model.load_state_dict(before)
    state = TrainState.create(model, sgd(LR, momentum=0.9))
    if step_no > 1:
        for name, p in model.named_parameters():
            state.optimizer.state[p]["momentum_buffer"] = trace[name].clone()
    step = make_train_step(bn_classifier_loss(model), mutable=True)
    state, m = step(state, _tensors(_batches(step_no)[step_no - 1]))
    assert np.isfinite(float(m["loss"]))
    p_share, s_share = _shares(model.state_dict(), traj[step_no][0], before)
    assert p_share <= 5e-4, p_share
    assert s_share <= 1e-4, s_share


def test_train_flag_returns_logits_and_named_stats():
    """``forward(train=True)`` returns the logits (or features) and one
    value for every running statistic, keyed by buffer name; the buffers
    do not move; ``train=False`` is the scoring forward."""
    model = _port_model("bottleneck", _variables("bottleneck"))
    x = torch.from_numpy(_batches(1)[0]["image"])
    before = {k: b.clone() for k, b in model.named_buffers()}
    logits, stats = model(x, train=True)
    feats, stats_f = model(x, train=True, features_only=True)
    assert logits.shape == (BATCH, CLASSES) and logits.dtype == torch.float32
    assert feats.shape == (BATCH, model.feature_dim)
    assert set(stats) == set(before) == set(stats_f)
    assert "stage2_block1.proj_bn.running_var" in stats
    assert all(torch.equal(b, before[k]) for k, b in model.named_buffers())
    assert torch.equal(model(x), model(x, train=False))


def test_remat_updates_the_statistics_once():
    """``remat=True`` re-runs the forward in the backward; the statistics
    still come out as with ``remat=False`` (one update), and so do the
    parameters, bit for bit on the CPU."""
    v = _variables("resnet18")
    b = _tensors(_batches(1)[0])
    out = []
    for remat in (False, True):
        model = _port_model("resnet18", v)
        state = TrainState.create(model, sgd(LR, momentum=0.9))
        make_train_step(bn_classifier_loss(), mutable=True,
                        remat=remat)(state, b)
        out.append(model.state_dict())
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


def test_sgd_is_optax_sgd():
    """``sgd`` is ``optax.sgd``: plain, with momentum, and Nesterov, over
    four steps of the same gradients."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(7).astype(np.float32)
    grads = [rng.standard_normal(7).astype(np.float32) for _ in range(4)]
    for kw in ({}, {"momentum": 0.9}, {"momentum": 0.9, "nesterov": True}):
        tx = optax.sgd(0.1, **kw)
        p, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
        for g in grads:
            u, st = tx.update(jnp.asarray(g), st, p)
            p = optax.apply_updates(p, u)
        model = torch.nn.Linear(7, 1, bias=False)
        with torch.no_grad():
            model.weight.copy_(torch.from_numpy(p0)[None])
        opt = sgd(0.1, **kw)(model)
        for g in grads:
            model.weight.grad = torch.from_numpy(g)[None].clone()
            opt.step()
        np.testing.assert_allclose(model.weight.detach().numpy()[0],
                                   np.asarray(p), rtol=1e-6, atol=1e-7)


# --- twins of tests/test_runner.py -------------------------------------------


class TinyBN(torch.nn.Module):
    """The port's twin of test_runner's flax ``TinyBN`` (Dense → BatchNorm
    → Dense), with its flax names."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(4, 8)
        self.BatchNorm_0 = BatchNorm(8, 1e-5, momentum=0.9)
        self.Dense_1 = torch.nn.Linear(8, 3)

    def forward(self, x, train=False):
        h = self.Dense_0(x)
        if not train:
            return self.Dense_1(self.BatchNorm_0(h))
        h, (mean, var) = self.BatchNorm_0(h, train=True)
        return self.Dense_1(h), {"BatchNorm_0.running_mean": mean,
                                 "BatchNorm_0.running_var": var}


class FlaxTinyBN(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.Dense(8)(x)
        x = fnn.BatchNorm(use_running_average=not train, momentum=0.9)(x)
        return fnn.Dense(3)(x)


def test_mutable_step_updates_batch_stats():
    """Twin of test_runner.py::test_mutable_step_updates_batch_stats: one
    mutable step moves the running mean and gives a finite loss, and the
    parameters and statistics equal the reference step's."""
    rng = np.random.RandomState(0)
    x = rng.randn(16, 4).astype(np.float32) * 3 + 1
    y = rng.randint(0, 3, size=(16,))
    fm = FlaxTinyBN()
    v = jax.tree_util.tree_map(np.asarray, fm.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 4))))
    mesh = jruntime.make_mesh({"data": 1}, jax.devices()[:1])
    jst = JTS.TrainState.create(None, v["params"], optax.sgd(0.01),
                                model_state={"batch_stats":
                                             v["batch_stats"]})
    with mesh:
        jst, _ = JTS.make_train_step(JTS.bn_classifier_loss(fm), mesh,
                                     mutable=True)(jst, {"image": x,
                                                         "label": y})
    model = load_flax_variables(TinyBN(), v)
    state = TrainState.create(model, sgd(0.01))
    state, m = make_train_step(bn_classifier_loss(), mutable=True)(
        state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    old = v["batch_stats"]["BatchNorm_0"]["mean"]
    assert not np.allclose(old, model.BatchNorm_0.running_mean.numpy())
    assert np.isfinite(float(m["loss"]))
    ref = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jst.params, **jst.model_state}))
    for k, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), ref[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_mutable_with_accum_steps_raises():
    """Twin of test_runner.py's mutable + accum_steps refusal (`:158`)."""
    with pytest.raises(ValueError, match="mutable"):
        make_train_step(bn_classifier_loss(), mutable=True, accum_steps=2)
    with pytest.raises(ValueError, match="accum_steps"):
        make_train_step(softmax_cross_entropy_loss(), accum_steps=0)


def test_softmax_cross_entropy_loss_matches_reference():
    """Index and one-hot labels give the reference's loss and accuracy."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 6)
    onehot = np.eye(5, dtype=np.float32)[labels]
    for lab in (labels, onehot):
        jl, jaux = JTS.softmax_cross_entropy_loss()(
            None, lambda p, x: x, {"image": logits, "label": lab})
        pl, paux = softmax_cross_entropy_loss()(
            lambda x: x, {"image": torch.from_numpy(logits),
                          "label": torch.from_numpy(lab)})
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
        assert float(paux["accuracy"]) == float(jaux["accuracy"])


def test_graft_resnet18_step_remat_accum_matches_plain():
    """Twin of ``__graft_entry__.dryrun_multichip``'s ResNet18 step at
    ``np=1``: ``get_model("ResNet18")`` at 10 classes, 32², ``train=False``
    (the BatchNorms on their running statistics), SGD momentum 0.9; the
    step with ``remat=True, accum_steps=2`` lands within rtol 5e-5 of the
    plain step (accumulation is exact for a mean loss)."""
    from sparkdl_tpu_torch.models.registry import get_model

    batch = {"image": torch.from_numpy(np.random.RandomState(1).randint(
                 0, 256, size=(4, 32, 32, 3)).astype(np.float32)),
             "label": torch.from_numpy(np.random.RandomState(2).randint(
                 0, 10, size=(4,)))}
    loss_fn = softmax_cross_entropy_loss()
    params = []
    for kw in ({}, {"remat": True, "accum_steps": 2}):
        model = get_model("ResNet18").build(num_classes=10, seed=0)
        state = TrainState.create(model, sgd(0.01, momentum=0.9))
        state, m = make_train_step(loss_fn, **kw)(state, batch)
        assert state.step == 1 and np.isfinite(float(m["loss"]))
        params.append([p.detach().clone() for p in model.parameters()])
    for a, b in zip(*params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-5,
                                   atol=5e-6)


def test_fit_mutable_trains_a_resnet():
    """``XlaRunner(device="cpu").run(ctx.fit(mutable=True))`` on a narrow
    ResNet18: the statistics move, the loss stays finite, and the state
    equals the bare step's run over the same batches."""
    v = _variables("resnet18")
    batches = _batches(3)
    model = _port_model("resnet18", v)
    res = XlaRunner(device="cpu").run(lambda ctx: ctx.fit(
        loss_fn=bn_classifier_loss(), model=model,
        tx=sgd(LR, momentum=0.9), data=batches, num_steps=3, log_every=1,
        mutable=True))
    assert res["state"].step == 3 and len(res["history"]) == 3
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    bare = _port_model("resnet18", v)
    state = TrainState.create(bare, sgd(LR, momentum=0.9))
    step = make_train_step(bn_classifier_loss(), mutable=True)
    for b in batches:
        state, _ = step(state, _tensors(b))
    for k, t in bare.state_dict().items():
        assert torch.equal(t, model.state_dict()[k]), k


def test_resnet_flop_estimate_against_xla_cost_analysis(monkeypatch):
    """(b) ``SPARKDL_MFU_ESTIMATE=1`` on the narrow ResNet18's mutable
    fit, against the reference's estimate of the same step (its
    ``_estimate_step_flops``, what its ``fit`` calls under the knob: XLA's
    cost analysis of the lowered step). The port's count is its
    convolutions' and the head's products exactly: 3 × the forward's (the
    forward, the input gradient and the weight gradient), less the stem's
    input gradient (the images take none). XLA's cost analysis counts
    fewer here: it counts only the taps of a convolution that fall inside
    the image (SAME padding's zeros and a strided convolution's dilation
    zeros are left out), where FlopCounterMode counts every tap, and at
    32² the last stages' maps are 4×4 and 2×2, where most 3×3 taps are
    padding. XLA also counts BatchNorm, ReLU and the adds, which the port
    does not. Measured port / XLA: 1.4206 (the bottleneck ResNet's mostly
    1×1 convolutions: 1.0173); held within [1.38, 1.46]."""
    from sparkdl_tpu.runner.xla_runner import _estimate_step_flops
    from sparkdl_tpu_torch.models.image_layers import Conv, Dense

    monkeypatch.setenv("SPARKDL_MFU_ESTIMATE", "1")
    arch = "resnet18"
    v, batches = _variables(arch), _batches(1)
    model = _port_model(arch, v)
    fwd = []

    def count(m, inp, out):
        taps = m.kernel[0] * m.kernel[1] if isinstance(m, Conv) else 1
        fwd.append(2 * out.numel() * m.weight.shape[1] * taps)

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv, Dense))]
    with torch.no_grad():
        model(_tensors(batches[0])["image"])
    for hk in hooks:
        hk.remove()
    port = XlaRunner(device="cpu").run(lambda ctx: ctx.fit(
        loss_fn=bn_classifier_loss(), model=model,
        tx=sgd(LR, momentum=0.9), data=batches, num_steps=1,
        mutable=True))["meter"].flops_per_step
    assert port == 3 * sum(fwd) - fwd[0]
    sizes, jblock, _ = ARCHS[arch]
    jm = JRN.ResNet(stage_sizes=sizes, block=jblock, width=WIDTH,
                    num_classes=CLASSES)
    mesh = jruntime.make_mesh({"data": 1}, jax.devices()[:1])
    st = JTS.TrainState.create(None, v["params"],
                               optax.sgd(LR, momentum=0.9),
                               model_state={"batch_stats": v["batch_stats"]})
    step = JTS.make_train_step(JTS.bn_classifier_loss(jm), mesh,
                               mutable=True)
    with mesh:
        ref = _estimate_step_flops(step, st, batches[0])
    assert 1.38 <= port / ref <= 1.46, (port, ref, port / ref)
