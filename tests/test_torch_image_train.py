"""InceptionV3 and Xception in train mode in the port (``forward(train=
True)``, the mutable step) against the JAX package's flax models with
``train=True``, on the CPU.

The flax variables come from ``test_torch_image_models.flax_variables``
(numpy, seeded, every BatchNorm term and statistic random) at the
1000-class shapes; the inputs are seeded images in [0, 1). Sizes are
``test_torch_image_models_299.py``'s smallest: InceptionV3 at 75², whose
last blocks run on a 1 × 1 grid, Xception at 71², a batch of 4.

Tolerances. The yardstick is the reference's step computed in float64
(``jax.enable_x64`` scoped to the call, ``build(dtype=jnp.float64)``,
the same seeded variables and batch cast to f64). After one mutable
``sgd(0.01, momentum=0.9)`` step from the carried variables, the port's
float32 step is held to it: the largest parameter error as a share of
the largest change the f64 step made, and the same share taken for each
running statistic against its own change, each within the larger of
``tests/test_torch_resnet_train.py``'s limits (5e-4 and 1e-4) and the
share by which the reference's own float32 step misses the f64 step
(the rounding the reference itself makes); the loss within 1e-5
relative or the reference's own f32 miss. A correct port differs from
the exact step by rounding alone (PyTorch's convolutions and reductions
sum in other orders than XLA's; BatchNorm's variance is E[x²] − E[x]²
in flax and from ``invstd`` here), and these models in train mode pass
rounding on unevenly: at 4 rows their BatchNorms normalise over as few
as 4 values a channel (InceptionV3's last blocks run on a 1 × 1 grid)
and their gradients grow through the depth.

Measured on an x86 CPU (jax 0.9.0, torch 2.13): InceptionV3
parameters 4.0e-2 against the reference f32's 1.47e-1, statistics
6.3e-4 against 2.1e-3, loss 2.3e-4 against 9.4e-4; Xception parameters
8.6e-4 against 6.5e-3, statistics 1.1e-5 and 1.4e-5 (inside 1e-4),
loss 1e-6 against 0. The port is 3.5–7.5× closer to the f64 step than
the reference's f32 step.
An earlier version of this test scaled its limits by the share between
the reference's step and the same step on the input nudged by one f32
ulp; XLA's f32 error on the CPU is systematic on some hosts, so that
nudge moved Xception's step by 6.5e-3 on one machine and by 1.48e-5 on
another, and the test failed there on a port that had not changed. A
BatchNorm whose momentum is off by 5e-4 moves the statistics' share to
1.67 (InceptionV3) and 5.0e-2 (Xception), far outside.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
from sparkdl_tpu.core import runtime as jruntime
from sparkdl_tpu.models import registry as JR
from sparkdl_tpu.runner import train_state as JTS
from sparkdl_tpu_torch.models import registry as R
from sparkdl_tpu_torch.models.registry import (flax_to_state_dict,
                                               load_flax_variables)
from sparkdl_tpu_torch.runner import (TrainState, bn_classifier_loss,
                                      make_train_step, sgd)
from test_torch_image_models import flax_variables

CASES = [("InceptionV3", 75, 0.9997), ("Xception", 71, 0.99)]
IDS = [c[0] for c in CASES]
BATCH, LR = 4, 0.01
PARAM_SHARE, STAT_SHARE = 5e-4, 1e-4


def _batch(size, seed=7):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0, 1, (BATCH, size, size, 3)
                                 ).astype(np.float32),
            "label": rng.integers(0, 1000, BATCH)}


def _state_dict64(tree):
    """The reference's variables as a float64 port state dict: the f32
    conversion of :func:`flax_to_state_dict` applied to the leaves' f32
    part and to their remainder, summed in f64 (exact to ~2^-48, so the
    f64 step is not rounded back to f32 before the comparison)."""
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
    hi = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    lo = jax.tree_util.tree_map(
        lambda a: (a - a.astype(np.float32).astype(np.float64)
                   ).astype(np.float32), tree)
    hi, lo = flax_to_state_dict(hi), flax_to_state_dict(lo)
    return {k: hi[k].double() + lo[k].double() for k in hi}


def _loss64(model):
    """``JTS.bn_classifier_loss`` without its cast of the logits to f32,
    so the f64 step stays f64 end to end."""
    import jax.numpy as jnp

    def loss_fn(params, model_state, _apply_fn, batch):
        logits, new_vars = model.apply({"params": params, **model_state},
                                       batch["image"], train=True,
                                       mutable=["batch_stats"])
        onehot = jax.nn.one_hot(batch["label"], logits.shape[-1],
                                dtype=logits.dtype)
        loss = optax.softmax_cross_entropy(logits, onehot).mean()
        return loss, {}, dict(new_vars)

    return loss_fn


@functools.lru_cache(maxsize=None)
def _reference(name, size):
    """The reference's mutable step (``make_train_step(...,
    mutable=True)`` on a one-device mesh) from the carried variables: in
    float32 (``bn_classifier_loss``, the reference as it runs), and in
    float64 (``jax.enable_x64`` scoped to this call, ``build(dtype=
    jnp.float64)``, the same variables and batch cast to f64). Returns
    the f64 state dict before, the f32 and f64 state dicts after, and
    the f32 and f64 losses."""
    import jax.numpy as jnp

    v = flax_variables(name, size)
    batch = _batch(size)
    mesh = jruntime.make_mesh({"data": 1}, jax.devices()[:1])
    model = JR.get_model(name).build()
    step = JTS.make_train_step(JTS.bn_classifier_loss(model), mesh,
                               mutable=True, donate=False)
    st = JTS.TrainState.create(
        None, v["params"], optax.sgd(LR, momentum=0.9),
        model_state={"batch_stats": v["batch_stats"]})
    with mesh:
        st, m = step(st, batch)
    after32 = _state_dict64({"params": st.params, **st.model_state})
    loss32 = float(m["loss"])
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), v)
        model64 = JR.get_model(name).build(dtype=jnp.float64)
        step64 = JTS.make_train_step(_loss64(model64), mesh, mutable=True,
                                     donate=False)
        st = JTS.TrainState.create(
            None, v64["params"], optax.sgd(LR, momentum=0.9),
            model_state={"batch_stats": v64["batch_stats"]})
        with mesh:
            st, m = step64(st, dict(batch, image=batch["image"].astype(
                np.float64)))
        leaves = jax.tree_util.tree_leaves(st.params)
        assert all(leaf.dtype == jnp.float64 for leaf in leaves)
        after64 = _state_dict64({"params": st.params, **st.model_state})
        loss64 = float(m["loss"])
    return _state_dict64(v), after32, after64, loss32, loss64


def _shares(got, want, before):
    """(params, stats): the largest parameter error as a share of the
    largest change the step made; the largest over the running
    statistics of each one's error as a share of its own change."""
    params = [k for k in want if "running" not in k]
    p = (max((got[k] - want[k]).abs().max().item() for k in params)
         / max((want[k] - before[k]).abs().max().item() for k in params))
    s = max((got[k] - want[k]).abs().max().item()
            / (want[k] - before[k]).abs().max().item()
            for k in want if "running" in k)
    return p, s


def _port(name, size):
    return load_flax_variables(R.get_model(name).build(),
                               flax_variables(name, size))


@pytest.mark.parametrize("name,size,momentum", CASES, ids=IDS)
def test_mutable_step_matches_flax(name, size, momentum):
    """One mutable SGD step: the parameters and every BatchNorm's new
    running statistics (at the model's momentum) equal the reference's
    float64 step within the larger of the ResNet limits and the share by
    which the reference's own float32 step misses it; the loss likewise
    (1e-5 relative or the reference's own f32 miss)."""
    before, ref32, ref64, loss32, loss64 = _reference(name, size)
    ref = _shares(ref32, ref64, before)
    model = _port(name, size)
    assert {m.momentum for m in model.modules()
            if hasattr(m, "running_var")} == {momentum}
    state = TrainState.create(model, sgd(LR, momentum=0.9))
    state, m = make_train_step(bn_classifier_loss(), mutable=True)(
        state, {k: torch.from_numpy(np.asarray(v))
                for k, v in _batch(size).items()})
    loss_tol = max(1e-5 * abs(loss64), abs(loss32 - loss64))
    got = {k: t.double() for k, t in model.state_dict().items()}
    p, s = _shares(got, ref64, before)
    assert abs(float(m["loss"]) - loss64) <= loss_tol, (
        float(m["loss"]), loss64, loss_tol)
    assert p <= max(PARAM_SHARE, ref[0]), (p, ref)
    assert s <= max(STAT_SHARE, ref[1]), (s, ref)


@pytest.mark.parametrize("name,size,momentum", CASES, ids=IDS)
def test_train_flag_returns_output_and_named_stats(name, size, momentum):
    """``forward(train=True)`` returns the logits (or the features) and
    one value for every running statistic, keyed by buffer name; the
    buffers do not move; ``train=False`` is the scoring forward, bit for
    bit."""
    model = _port(name, size)
    x = torch.from_numpy(_batch(size)["image"])
    buffers = {k: b.clone() for k, b in model.named_buffers()}
    logits, stats = model(x, train=True)
    feats, stats_f = model(x, train=True, features_only=True)
    assert logits.shape == (BATCH, 1000) and logits.dtype == torch.float32
    assert feats.shape == (BATCH, model.feature_dim)
    assert set(stats) == set(buffers) == set(stats_f)
    assert all(torch.equal(b, buffers[k]) for k, b in model.named_buffers())
    moved = [k for k in stats if not torch.equal(stats[k], buffers[k])]
    assert len(moved) == len(buffers)
    assert torch.equal(model(x), model(x, train=False))
    assert torch.equal(model(x, features_only=True),
                       model(x, train=False, features_only=True))
