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

Not ported yet (ROADMAP.md, Queue A 3): ``mutable`` (BatchNorm statistics,
for ResNet) and ``with_rng`` (dropout, for BERT) raise
``NotImplementedError``. The explicit-collective twin
``make_shard_map_step`` comes with data parallelism (Queue A 8).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

_NOT_PORTED = "is not ported yet (ROADMAP.md, Queue A 3)"


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
                    with_rng: bool = False, remat: bool = False,
                    accum_steps: int = 1) -> Callable:
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
    by k."""
    if mutable:
        raise NotImplementedError(f"mutable=True (BatchNorm) {_NOT_PORTED}")
    if with_rng:
        raise NotImplementedError(f"with_rng=True (dropout) {_NOT_PORTED}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def forward(model, batch):
        if remat:
            loss, aux = checkpoint(loss_fn, model, batch, use_reentrant=False)
        else:
            loss, aux = loss_fn(model, batch)
        return loss.float(), aux

    def step(state: TrainState, batch):
        params = state.trainable()
        if accum_steps == 1:
            loss, aux = forward(state.model, batch)
            grads = torch.autograd.grad(loss, params)
        else:
            gsum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            losses, auxs = [], []
            for mb in _split(batch, accum_steps):
                loss, aux = forward(state.model, mb)
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
        return state, {"loss": loss.detach(),
                       **{key: val.detach() for key, val in aux.items()}}

    return step


def make_eval_step(eval_fn: Callable) -> Callable:
    """``eval(state, batch) -> metrics``: ``eval_fn(model, batch)`` under
    ``torch.no_grad()``."""
    def step(state: TrainState, batch):
        with torch.no_grad():
            return eval_fn(state.model, batch)

    return step
