"""Train state and train steps for one device.

The counterpart of ``sparkdl_tpu/runner/train_state.py``. There the step
is a pure function jitted over a mesh, and the state (params, optimizer
state, step) flows through it as a pytree. Here the model holds its
weights (``nn.Module``) and the optimizer its state, both updated in
place, so :class:`TrainState` is the pair plus the step count, and a step
is a plain call: forward, ``backward``, ``optimizer.step()``. PyTorch
runs it eagerly; nothing is compiled.

- ``loss_fn(model, batch) -> (loss, aux_dict)`` (the PyTorch idiom for
  the reference's ``loss_fn(params, apply_fn, batch)``).
- ``tx`` is an optimizer factory, ``model → torch.optim.Optimizer``
  (``models.llama.lora_optimizer`` returns one): like an optax
  transformation it is made before the model it will update.
- The loss is taken in f32 whatever the model's dtype.
- ``with_rng=True`` hands the loss ``rng=``, a ``torch.Generator`` on the
  model's device seeded from ``(rng_seed, step)`` (:func:`step_generator`,
  the counterpart of ``fold_in(PRNGKey(rng_seed), step)``): the same seed
  and step give the same dropout masks, so a replayed step repeats them.
- ``mutable=True`` (BatchNorm models):
  ``loss_fn(model, batch) -> (loss, aux, new_model_state)``, the new
  state a dict of buffer name → tensor (``ResNet.forward(train=True)``'s
  second output); the step copies it into the model's buffers after the
  optimizer step (:func:`bn_classifier_loss`).
- :func:`adam` and :func:`sgd` are ``optax.adam`` and ``optax.sgd`` as
  optimizer factories; :func:`softmax_cross_entropy_loss` is the
  reference's classification loss.

The explicit-collective twin ``make_shard_map_step`` comes with data
parallelism (ROADMAP.md, Queue A 3 (c) and A 8).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the number of optimizer steps taken."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, tx: Callable) -> "TrainState":
        """``tx(model)`` builds the optimizer (and may freeze weights, as
        ``lora_optimizer``'s does)."""
        return cls(model=model, optimizer=tx(model))

    def trainable(self) -> list:
        """The parameters the optimizer updates, in its order."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def apply_gradients(self) -> "TrainState":
        """One optimizer step from the gradients in ``p.grad``."""
        self.optimizer.step()
        self.step += 1
        return self


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    """``optax.adam`` as the optimizer factory :class:`TrainState` calls:
    ``model → torch.optim.Adam`` over every parameter that requires a
    gradient (the same update: bias-corrected moments, ``eps`` added to
    the square root)."""
    def make(model: nn.Module) -> torch.optim.Optimizer:
        return torch.optim.Adam(
            [p for p in model.parameters() if p.requires_grad],
            lr=learning_rate, betas=(b1, b2), eps=eps)

    return make


def sgd(learning_rate: float, momentum: float | None = None,
        nesterov: bool = False):
    """``optax.sgd`` as an optimizer factory: ``torch.optim.SGD`` with
    ``dampening=0`` over every parameter that requires a gradient. The
    same update: the trace ``t = g + momentum·t`` (``t`` starts at 0, so
    the first step's trace is ``g``, as torch's first buffer), then ``p −=
    lr·t``, or ``lr·(g + momentum·t)`` with ``nesterov``."""
    def make(model: nn.Module) -> torch.optim.Optimizer:
        return torch.optim.SGD(
            [p for p in model.parameters() if p.requires_grad],
            lr=learning_rate, momentum=momentum or 0.0, dampening=0.0,
            nesterov=nesterov)

    return make


def step_generator(rng_seed: int, step: int, device,
                   micro: int | None = None) -> torch.Generator:
    """The ``rng=`` of train step ``step``: a ``torch.Generator`` on
    ``device`` seeded from ``(rng_seed, step)``, or from ``(rng_seed,
    step, micro)`` for microbatch ``micro`` under ``accum_steps`` (the
    reference folds the microbatch index into the step's key). A pure
    function of its arguments."""
    # micro + 1: SeedSequence does not tell a trailing 0 word from none
    words = [rng_seed, step] if micro is None else [rng_seed, step,
                                                    micro + 1]
    seed = int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(seed)


def _split(batch, k: int) -> list:
    """``k`` contiguous microbatches of equal size along dim 0 of every
    leaf (a dict of tensors)."""
    n = len(next(iter(batch.values())))
    if n % k:
        raise ValueError(f"batch dim {n} not divisible by accum_steps={k}")
    m = n // k
    return [{key: x[i * m:(i + 1) * m] for key, x in batch.items()}
            for i in range(k)]


def make_train_step(loss_fn: Callable, mutable: bool = False,
                    with_rng: bool = False, rng_seed: int = 0,
                    remat: bool = False, accum_steps: int = 1) -> Callable:
    """A train step: ``step(state, batch) -> (state, metrics)``, metrics
    ``{"loss": ..., **aux}`` as 0-d tensors on the model's device (read
    them with ``float()``, which waits for the device). The step's
    gradients stay in each trainable parameter's ``.grad`` until the next
    step replaces them.

    ``remat=True`` wraps the loss forward in ``torch.utils.checkpoint``
    (``use_reentrant=False``): the backward recomputes the activations
    instead of keeping them, the reference's ``jax.checkpoint``. Same
    gradients either way.

    ``accum_steps=k`` > 1 splits the batch into k contiguous microbatches,
    one forward and backward each, sums their gradients in f32, divides
    by k, casts to each parameter's dtype and makes ONE optimizer step;
    the loss and aux are the microbatches' means. For a mean-reduced loss
    this is the full-batch gradient. The batch's leading dim must divide
    by k.

    ``with_rng=True`` calls ``loss_fn(model, batch, rng=g)``, ``g`` =
    :func:`step_generator` of ``(rng_seed, state.step)`` on the model's
    device, and under ``accum_steps`` of ``(rng_seed, state.step, i)`` for
    microbatch i. The generator is made inside the (rematerialised)
    forward, so a recomputation draws the same masks.

    ``mutable=True`` calls ``loss_fn(model, batch) -> (loss, aux,
    new_model_state)`` (the reference's mutable branch): the forward (under
    ``remat`` too) runs once in the step, the new state is taken from its
    primal outputs, and after the optimizer step it is copied into the
    model's buffers of the same names under ``no_grad``, once. A forward
    that ``checkpoint`` recomputes in the backward leaves no trace in the
    buffers, because the model writes none itself
    (``image_layers.BatchNorm``)."""
    if accum_steps > 1 and mutable:
        raise ValueError(
            "accum_steps > 1 with mutable=True is not supported: BatchNorm "
            "statistics would come from single microbatches, silently "
            "changing the model's normalization semantics")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def run(model, batch, n_step, micro):
        if not with_rng:
            return loss_fn(model, batch)
        device = next(model.parameters()).device
        return loss_fn(model, batch,
                       rng=step_generator(rng_seed, n_step, device, micro))

    def forward(model, batch, n_step, micro=None):
        if remat:
            loss, *rest = checkpoint(run, model, batch, n_step, micro,
                                     use_reentrant=False)
        else:
            loss, *rest = run(model, batch, n_step, micro)
        return (loss.float(), *rest)

    def step(state: TrainState, batch):
        params = state.trainable()
        new_ms = None
        if accum_steps == 1:  # always, when mutable
            loss, aux, *rest = forward(state.model, batch, state.step)
            if mutable:
                new_ms = rest[0]
            grads = torch.autograd.grad(loss, params)
        else:
            gsum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            losses, auxs = [], []
            for i, mb in enumerate(_split(batch, accum_steps)):
                loss, aux = forward(state.model, mb, state.step, i)
                # summed in f32 whatever the parameter dtype: k bf16
                # additions would round small contributions away
                for s, g in zip(gsum, torch.autograd.grad(loss, params)):
                    s.add_(g.float())
                losses.append(loss.detach())
                auxs.append(aux)
            grads = [(s / accum_steps).to(p.dtype)
                     for s, p in zip(gsum, params)]
            loss = torch.stack(losses).mean()
            aux = {key: torch.stack([a[key].detach().float()
                                     for a in auxs]).mean()
                   for key in auxs[0]}
        for p, g in zip(params, grads):
            p.grad = g
        state.apply_gradients()
        if new_ms:
            assign_buffers(state.model, new_ms)
        return state, {"loss": loss.detach(),
                       **{key: val.detach() for key, val in aux.items()}}

    return step


@torch.no_grad()
def assign_buffers(model: nn.Module, values: dict) -> None:
    """Copy ``values`` (buffer name → tensor) into ``model``'s buffers of
    those names, in one multi-tensor copy. A name the model does not hold
    raises ``KeyError``."""
    own = dict(model.named_buffers())
    unknown = sorted(set(values) - set(own))
    if unknown:
        raise KeyError(f"new model state names buffers the model does not "
                       f"hold: {unknown[:8]}")
    names = list(values)
    torch._foreach_copy_([own[k] for k in names],
                         [values[k].detach() for k in names])


def make_eval_step(eval_fn: Callable) -> Callable:
    """``eval(state, batch) -> metrics``: ``eval_fn(model, batch)`` under
    ``torch.no_grad()``."""
    def step(state: TrainState, batch):
        with torch.no_grad():
            return eval_fn(state.model, batch)

    return step


def bn_classifier_loss(model: nn.Module | None = None,
                       preprocess: Callable | None = None,
                       label_key: str = "label",
                       input_key: str = "image") -> Callable:
    """The classification loss of a BatchNorm model, for ``mutable=True``
    steps: ``loss_fn(model, batch) -> (loss, {"accuracy"}, new_stats)``,
    the model run with ``train=True`` on ``preprocess(batch[input_key])``,
    mean softmax cross-entropy of its logits taken in f32. ``model`` is
    the reference's argument; the loss runs the model the step hands it,
    so it may be left out."""
    del model

    def loss_fn(m: nn.Module, batch):
        x = batch[input_key]
        if preprocess is not None:
            x = preprocess(x)
        logits, new_stats = m(x, train=True)
        logits = logits.float()
        labels = batch[label_key]
        loss = torch.nn.functional.cross_entropy(logits, labels.long())
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"accuracy": acc}, new_stats

    return loss_fn


def softmax_cross_entropy_loss(num_classes: int | None = None,
                               label_key: str = "label",
                               input_key: str = "image") -> Callable:
    """The reference's classification loss: ``loss_fn(model, batch) ->
    (loss, {"accuracy"})``, the mean softmax cross-entropy of
    ``model(batch[input_key])`` taken in f32 (bf16-friendly). Labels are
    class indices, or one-hot (or soft) rows when they have the logits'
    rank. ``num_classes`` is the reference's argument; the logits give
    it."""
    del num_classes

    def loss_fn(model: nn.Module, batch):
        logits = model(batch[input_key]).float()
        labels = batch[label_key]
        logp = torch.log_softmax(logits, dim=-1)
        if labels.ndim == logits.ndim:  # one-hot
            loss = -(labels.float() * logp).sum(-1).mean()
            target = labels.argmax(-1)
        else:
            loss = -logp.gather(-1, labels.long()[:, None]).mean()
            target = labels
        acc = (logits.argmax(-1) == target).float().mean()
        return loss, {"accuracy": acc}

    return loss_fn
