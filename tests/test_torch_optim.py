"""The port's optimizer factories (``runner.train_state``: ``adam``,
``sgd``, ``adamw``, ``rmsprop``) against optax's, on the CPU.

The same seeded parameters and gradients go through the optax
transformation (``tx.update`` then ``optax.apply_updates``) and through
the factory's ``torch.optim`` optimizer (``p.grad`` set, ``step()``) for
several steps; the parameters are held after every step to rtol 1e-6
and an absolute 1e-4 of the learning rate, the most one step moves a
parameter (float32: the two packages order the same few operations
differently — torch folds Adam's bias corrections into the step size
and the root, optax divides the moments — so they agree to a few ulps
of the parameter and ~2e-5 of a step; a misplaced eps or decay moves
small-gradient entries by a whole step). ``adamw`` and ``rmsprop`` use
optax's defaults (``weight_decay=1e-4``; ``decay=0.9``, ``eps=1e-8``
inside the square root), which ``KerasImageFileEstimator`` names.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from sparkdl_tpu_torch.runner import train_state as TS

SHAPES = {"w": (5, 3), "b": (3,)}
STEPS = 4
RTOL = 1e-6


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    # mixed scales: eps matters where a gradient is small
    return {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 1, s)
                ).astype(np.float32) for k, s in SHAPES.items()}


class _Model(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            self.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(v.copy())))


CASES = [
    ("adam", 1e-2, lambda lr: TS.adam(lr), lambda lr: optax.adam(lr)),
    ("sgd", 1e-2, lambda lr: TS.sgd(lr, momentum=0.9),
     lambda lr: optax.sgd(lr, momentum=0.9)),
    ("adamw", 1e-2, lambda lr: TS.adamw(lr), lambda lr: optax.adamw(lr)),
    ("adamw_wd", 3e-2, lambda lr: TS.adamw(lr, weight_decay=0.1),
     lambda lr: optax.adamw(lr, weight_decay=0.1)),
    ("rmsprop", 1e-2, lambda lr: TS.rmsprop(lr),
     lambda lr: optax.rmsprop(lr)),
    ("rmsprop_decay", 5e-3, lambda lr: TS.rmsprop(lr, decay=0.5, eps=1e-4),
     lambda lr: optax.rmsprop(lr, decay=0.5, eps=1e-4)),
]


@pytest.mark.parametrize("name,lr,port,ref", CASES,
                         ids=[c[0] for c in CASES])
def test_optimizer_matches_optax(name, lr, port, ref):
    params = _params()
    tx = ref(lr)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    model = _Model(params)
    opt = port(lr)(model)
    for step in range(STEPS):
        g = _grads(step)
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[k]), rtol=RTOL,
                                       atol=1e-4 * lr,
                                       err_msg=f"{name} step {step} {k}")


def test_rmsprop_eps_inside_the_root_differs_from_torch():
    """Why rmsprop is the port's own optimizer: ``torch.optim.RMSprop``
    adds eps outside the root, which differs from optax on small
    gradients far beyond rounding."""
    params = _params()
    g = {k: np.full(s, 1e-5, np.float32) for k, s in SHAPES.items()}
    ours, theirs = _Model(params), _Model(params)
    opt = TS.rmsprop(1e-2, eps=1e-8)(ours)
    topt = torch.optim.RMSprop(theirs.parameters(), lr=1e-2, alpha=0.9,
                               eps=1e-8)
    for m, o in ((ours, opt), (theirs, topt)):
        for k, p in m.named_parameters():
            p.grad = torch.from_numpy(g[k])
        o.step()
    tx = optax.rmsprop(1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    upd, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, g), tx.init(jp),
                       jp)
    want = optax.apply_updates(jp, upd)
    np.testing.assert_allclose(ours.w.detach().numpy(), np.asarray(want["w"]),
                               rtol=RTOL, atol=1e-6)
    assert not np.allclose(theirs.w.detach().numpy(), np.asarray(want["w"]),
                           rtol=1e-4, atol=1e-4)


def test_factories_skip_frozen_parameters():
    model = _Model(_params())
    model.b.requires_grad_(False)
    for make in (TS.adamw(1e-3), TS.rmsprop(1e-3)):
        opt = make(model)
        assert [p for g in opt.param_groups for p in g["params"]] == \
            [model.w]
