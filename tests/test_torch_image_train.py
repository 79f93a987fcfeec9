"""InceptionV3 and Xception in train mode in the port (``forward(train=
True)``, the mutable step) against the JAX package's flax models with
``train=True``, on the CPU.

The flax variables come from ``test_torch_image_models.flax_variables``
(numpy, seeded, every BatchNorm term and statistic random) at the
1000-class shapes; the inputs are seeded images in [0, 1). Sizes are
``test_torch_image_models_299.py``'s smallest: InceptionV3 at 75², whose
last blocks run on a 1 × 1 grid, Xception at 71², a batch of 4.

Tolerances. After one mutable ``sgd(0.01, momentum=0.9)`` step from the
carried variables: the largest parameter error as a share of the largest
change the reference's step made, and the same share taken for each
running statistic against its own change, are each held to the larger of
``tests/test_torch_resnet_train.py``'s limits (5e-4 and 1e-4) and ten
times the same share between the reference's step and the reference's
step on the input nudged by one f32 ulp (every pixel × (1 + 2^-23)),
which is the size of one rounding as the model passes it on. A correct
port differs from flax by rounding alone (XLA's and PyTorch's
convolutions and reductions sum in other orders; BatchNorm's variance is
E[x²] − E[x]² in flax and from ``invstd`` here), and these models in
train mode pass rounding on unevenly: at 4 rows their BatchNorms
normalise over as few as 4 values a channel (InceptionV3's last blocks
run on a 1 × 1 grid) and their gradients grow through the depth, so
the one-ulp nudge moves InceptionV3's step by a sizeable share of the
step. The loss is held to 1e-5 relative or ten times the nudge's.
Measured here: InceptionV3 parameters 0.170 against the nudge's 0.057,
statistics 2.3e-3 against 7.1e-4, the loss 1.1e-3 against 3.9e-4 (each
about 3× the nudge); Xception parameters 8.6e-4 against 6.5e-3,
statistics 1.7e-5 (inside 1e-4). A BatchNorm at the wrong momentum moves
its statistics by hundreds of times their change, far outside.
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


@functools.lru_cache(maxsize=None)
def _reference(name, size):
    """The reference's mutable step (``make_train_step(bn_classifier_loss,
    mutable=True)`` on a one-device mesh) from the carried variables, on
    the batch and on the batch nudged by one ulp: the port state dict
    before, the two after, and the two losses."""
    model = JR.get_model(name).build()
    v = flax_variables(name, size)
    mesh = jruntime.make_mesh({"data": 1}, jax.devices()[:1])
    step = JTS.make_train_step(JTS.bn_classifier_loss(model), mesh,
                               mutable=True, donate=False)
    batch = _batch(size)
    nudged = dict(batch, image=batch["image"] * np.float32(1 + 2.0 ** -23))
    assert (nudged["image"] != batch["image"]).any()
    out = [flax_to_state_dict(jax.tree_util.tree_map(np.asarray, v))]
    losses = []
    for b in (batch, nudged):
        st = JTS.TrainState.create(
            None, v["params"], optax.sgd(LR, momentum=0.9),
            model_state={"batch_stats": v["batch_stats"]})
        with mesh:
            st, m = step(st, b)
        out.append(flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, {"params": st.params, **st.model_state})))
        losses.append(float(m["loss"]))
    return (*out, *losses)


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
    within the module's limits, which the one-ulp nudge sets where it
    moves the reference's own step further than the ResNet limits."""
    before, want, nudged, ref_loss, nudged_loss = _reference(name, size)
    noise = _shares(nudged, want, before)
    model = _port(name, size)
    assert {m.momentum for m in model.modules()
            if hasattr(m, "running_var")} == {momentum}
    state = TrainState.create(model, sgd(LR, momentum=0.9))
    state, m = make_train_step(bn_classifier_loss(), mutable=True)(
        state, {k: torch.from_numpy(np.asarray(v))
                for k, v in _batch(size).items()})
    loss_tol = max(1e-5 * abs(ref_loss), 10 * abs(nudged_loss - ref_loss))
    assert abs(float(m["loss"]) - ref_loss) <= loss_tol, (
        float(m["loss"]), ref_loss, loss_tol)
    p, s = _shares(model.state_dict(), want, before)
    assert p <= max(PARAM_SHARE, 10 * noise[0]), (p, noise)
    assert s <= max(STAT_SHARE, 10 * noise[1]), (s, noise)


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
