"""Train state and train steps, for one process or a gang of them.

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
- :func:`adam`, :func:`sgd`, :func:`adamw` and :func:`rmsprop` are
  ``optax.adam``, ``optax.sgd``, ``optax.adamw`` and ``optax.rmsprop`` as
  optimizer factories, with optax's defaults; :func:`softmax_cross_entropy_loss` is the
  reference's classification loss.

**Data parallelism** (``group=``, a ``torch.distributed`` process group
of one process a device, each feeding its own rows). The two steps of the
reference keep their semantics:

- :func:`make_train_step` is the reference's implicit step: the step of
  the global batch. BatchNorm pools its batch statistics over the gang
  (``image_layers.sync_batch_stats``), and each rank's gradients, loss
  and aux are averaged over the ranks.
- :func:`make_shard_map_step` is the explicit one: BatchNorm uses each
  rank's own statistics, and the gradients, the loss, the aux and the new
  running statistics are averaged (``pmean``).

Either way a step makes one all-reduce of one flat f32 buffer
(:func:`_gang_mean`) after its backward, besides synchronised BatchNorm's
two a layer.

**The FSDP×TP step** (``mesh=``, a named ``DeviceMesh`` from
``core.runtime.make_mesh``; the reference's ``make_train_step(loss_fn,
mesh, data_axis=, param_rules=, batch_spec=)``). The model is placed on
the mesh first (``models.llama.shard_model`` for Llama,
``parallel.fsdp.shard_module`` for any module): each rank holds its
shard of each parameter, gathers a layer's ``data``-sharded weights at
use and reduce-scatters their gradients in the backward, and the
``model`` axis runs Megatron's split with its conjugate collectives.
Every rank passes the GLOBAL batch (the reference's global array); the
step keeps the rank's block of each dim ``batch_spec`` (default
``P(data_axis)``, truncated to each leaf's rank) puts on ``data_axis``
and the whole of every other dim, so a spec naming another axis
(``P("data", "sp")``) leaves the loss that of the global batch. The
gradients of ``data``-sharded parameters come out of the reduce-scatter
summed and are divided by the axis's extent; the others, the loss and
the aux are averaged over ``data`` (:func:`_gang_mean`).

Dropout in a gang (``with_rng=True``) keeps the reference's keys. The
implicit step is the step of the global batch, so rank r draws rows r of
the masks one process would draw over it: every rank seeds the step's
generator alike and hands the loss a :class:`~..utils.rng.RowWindow` of
its rows (rank·n of world·n, n its rows; every rank passes the same n,
which ``RunnerContext`` checks). The explicit step folds the rank into
the generator's seed (:func:`step_generator` ``rank=``), so each rank
draws its own masks over its own rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.image_layers import sync_batch_stats
from ..utils.rng import RowWindow


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


def state_sharding(state: TrainState, mesh, rules: Callable | None = None):
    """Where each entry of the state's ``model.state_dict()`` lies on
    ``mesh``: a ``{name: parallel.sharding.NamedSharding}`` dict,
    replicated by default (pure data parallelism) or from ``rules(path,
    leaf) -> P`` (``parallel.sharding.make_rules``, ``fsdp_rules``) for
    TP/FSDP. The optimizer's state follows its parameter."""
    from ..parallel.sharding import P, sharding_pytree
    return sharding_pytree(state.model.state_dict(), mesh,
                           rules or (lambda path, leaf: P()))


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


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``optax.adamw`` as an optimizer factory: ``torch.optim.AdamW`` over
    every parameter that requires a gradient. The same update: optax adds
    ``weight_decay·p`` to the Adam step before scaling by the learning
    rate, ``p −= lr·(m̂/(√v̂ + eps) + wd·p)``; torch first scales ``p`` by
    ``1 − lr·wd``, then subtracts ``lr·m̂/(√v̂ + eps)`` — the same sum."""
    def make(model: nn.Module) -> torch.optim.Optimizer:
        return torch.optim.AdamW(
            [p for p in model.parameters() if p.requires_grad],
            lr=learning_rate, betas=(b1, b2), eps=eps,
            weight_decay=weight_decay)

    return make


class _RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop`` (``scale_by_rms`` with ``eps`` inside the root,
    no centring, no momentum): ``ν ← decay·ν + (1 − decay)·g²`` from
    ``ν = 0``, then ``p −= lr·g/√(ν + eps)``. ``torch.optim.RMSprop`` adds
    ``eps`` outside the root, a different update."""

    def __init__(self, params, lr: float, decay: float, eps: float):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                nu = st["nu"]
                nu.mul_(decay).addcmul_(p.grad, p.grad, value=1 - decay)
                p.addcmul_(p.grad, (nu + eps).rsqrt(), value=-lr)
        return loss


def rmsprop(learning_rate: float, decay: float = 0.9, eps: float = 1e-8):
    """``optax.rmsprop`` as an optimizer factory (optax's defaults: no
    centring, no momentum, ``eps`` inside the square root) over every
    parameter that requires a gradient."""
    def make(model: nn.Module) -> torch.optim.Optimizer:
        return _RMSprop([p for p in model.parameters() if p.requires_grad],
                        lr=learning_rate, decay=decay, eps=eps)

    return make


def step_generator(rng_seed: int, step: int, device,
                   micro: int | None = None,
                   rank: int | None = None) -> torch.Generator:
    """The ``rng=`` of train step ``step``: a ``torch.Generator`` on
    ``device`` seeded from ``(rng_seed, step)``, from ``(rng_seed, step,
    micro)`` for microbatch ``micro`` under ``accum_steps`` (the reference
    folds the microbatch index into the step's key), and with ``rank``
    from the rank too (the explicit step's per-rank key). A pure function
    of its arguments; no two argument tuples share a seed."""
    # SeedSequence does not tell a trailing 0 word from none, so each
    # optional word is stored + 1 and a missing micro before a rank is 0
    words = [rng_seed, step]
    if micro is not None or rank is not None:
        words.append(0 if micro is None else micro + 1)
    if rank is not None:
        words.append(rank + 1)
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
                    remat: bool = False, accum_steps: int = 1,
                    group=None, *, mesh=None, data_axis: str = "data",
                    param_rules: Callable | None = None,
                    batch_spec=None) -> Callable:
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
    microbatch i. In a gang ``g`` is the :class:`~..utils.rng.RowWindow`
    of this rank's rows over that generator: rows ``rank·n`` to
    ``(rank + 1)·n`` of a global ``world·n`` (under ``accum_steps`` n is
    the microbatch's rows, so the rank's chunk i is its rows of the global
    microbatch i, the reference's shard-aligned split), and the masks are
    those of one process over the global batch. The generator and its
    window are made inside the (rematerialised) forward, so a
    recomputation draws the same masks.

    ``mutable=True`` calls ``loss_fn(model, batch) -> (loss, aux,
    new_model_state)`` (the reference's mutable branch): the forward (under
    ``remat`` too) runs once in the step, the new state is taken from its
    primal outputs, and after the optimizer step it is copied into the
    model's buffers of the same names under ``no_grad``, once. A forward
    that ``checkpoint`` recomputes in the backward leaves no trace in the
    buffers, because the model writes none itself
    (``image_layers.BatchNorm``).

    ``group`` (a ``torch.distributed`` process group; None: one process)
    makes it the reference's implicit data-parallel step, the step of the
    gang's global batch: each rank passes its own rows, BatchNorm pools
    its statistics over the gang (so the new running statistics come out
    equal on every rank), and the gradients (after ``accum_steps``), the
    loss and the aux are averaged over the ranks.

    ``mesh`` makes it the FSDP×TP step over a placed model (module doc):
    every rank passes the global batch, ``batch_spec`` (a ``P``; default
    ``P(data_axis)``) says which dims are split over ``data_axis``, and
    ``accum_steps`` splits the rank's rows (the reference's shard-aligned
    split); BatchNorm pools over ``data_axis`` and ``with_rng`` windows
    the rank's rows of the global masks, as ``group`` does.
    ``param_rules`` pins the layout: the first step raises
    ``ValueError`` unless the model was placed by those rules at this
    mesh."""
    if mesh is not None and group is not None:
        raise ValueError("pass group= (a data-parallel gang) or mesh= (the "
                         "FSDP×TP step), not both")
    if accum_steps > 1 and mutable:
        raise ValueError(
            "accum_steps > 1 with mutable=True is not supported: BatchNorm "
            "statistics would come from single microbatches, silently "
            "changing the model's normalization semantics")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if mesh is not None:
        return _make_step(loss_fn, mutable, with_rng, rng_seed, remat,
                          accum_steps, None, implicit=True,
                          on_mesh=_MeshStep(mesh, data_axis, param_rules,
                                            batch_spec))
    return _make_step(loss_fn, mutable, with_rng, rng_seed, remat,
                      accum_steps, group, implicit=True)


class _MeshStep:
    """What the FSDP×TP step knows of its mesh: the ``data_axis`` group
    (None when the mesh has no such axis), the rank's place on it, the
    batch's split and the layout the model must have."""

    def __init__(self, mesh, data_axis, param_rules, batch_spec):
        from ..parallel.sharding import P
        names = list(mesh.mesh_dim_names)
        self.mesh, self.data_axis = mesh, data_axis
        self.param_rules = param_rules
        self.spec = batch_spec if batch_spec is not None else P(data_axis)
        if data_axis in names:
            self.group = mesh.get_group(data_axis)
            self.n = mesh.size(names.index(data_axis))
            self.coord = mesh.get_local_rank(data_axis)
        else:
            self.group, self.n, self.coord = None, 1, 0
        self.checked = False

    def rows(self, batch):
        """The rank's block of every dim the spec puts on the data axis."""
        def cut(x):
            if not torch.is_tensor(x):
                x = torch.as_tensor(np.asarray(x))
            for dim, ax in enumerate(tuple(self.spec)[:x.dim()]):
                axes = ax if isinstance(ax, tuple) else (ax,)
                if self.data_axis not in axes:
                    continue
                if x.shape[dim] % self.n:
                    raise ValueError(
                        f"batch dim {dim} of {tuple(x.shape)} does not split "
                        f"over {self.data_axis!r} ({self.n})")
                w = x.shape[dim] // self.n
                x = x.narrow(dim, self.coord * w, w)
            return x
        return {k: cut(v) for k, v in batch.items()}

    def sharded(self, model) -> set:
        """ids of the parameters whose gradients arrive reduce-scattered
        (placed sharded over the data axis), after checking the layout."""
        from ..parallel import fsdp
        from ..parallel.sharding import divisible_rules
        pl = fsdp.placement(model)
        if not self.checked:
            if pl is not None and pl.mesh is not self.mesh and \
                    pl.mesh_shape() != {str(n): int(self.mesh.size(i))
                                        for i, n in enumerate(
                                            self.mesh.mesh_dim_names)}:
                raise ValueError(f"the model is placed on the mesh "
                                 f"{pl.mesh_shape()}, the step's is another")
            if self.param_rules is not None:
                if pl is None:
                    raise ValueError(
                        "param_rules pins a placed model's layout: place it "
                        "first (models.llama.shard_model or parallel.fsdp."
                        "shard_module)")
                rules = divisible_rules(self.param_rules, self.mesh)
                for name, spec in pl.specs.items():
                    want = rules((name,), torch.empty(pl.shapes[name],
                                                      device="meta"))
                    if tuple(want) != tuple(spec):
                        raise ValueError(
                            f"{name} is placed {spec}, param_rules give "
                            f"{want} at this mesh")
            self.checked = True
        if pl is None or self.group is None:
            return set()
        return {id(p) for n, p in pl.locals.items()
                if any(self.data_axis in (ax if isinstance(ax, tuple)
                                          else (ax,))
                       for ax in pl.specs[n])}


def make_shard_map_step(loss_fn: Callable, group=None,
                        mutable: bool = False, with_rng: bool = False,
                        rng_seed: int = 0, remat: bool = False,
                        accum_steps: int = 1) -> Callable:
    """The explicit-collective twin of :func:`make_train_step` (the
    reference's ``shard_map`` step): each rank runs its forward and
    backward on its own rows, and its gradients, loss and aux are averaged
    over ``group`` (``pmean``), Horovod's ring all-reduce. With
    ``with_rng`` the loss gets :func:`step_generator` of ``(rng_seed,
    state.step, rank=r)``: each rank's own masks over its own rows.

    ``mutable=True``: BatchNorm normalises by each rank's own batch
    statistics, and only the new running statistics are averaged, which
    is Horovod's default (not synchronised) BatchNorm. The implicit step
    pools the statistics over the global batch instead, so the two differ
    for BatchNorm models at a small batch a rank; pick by the BatchNorm
    semantics, not by style. ``remat`` composes; ``accum_steps`` is the
    implicit step's only."""
    if accum_steps != 1:
        raise ValueError(
            "accum_steps is not supported with explicit_collectives / "
            "make_shard_map_step — use the implicit make_train_step path")
    return _make_step(loss_fn, mutable, with_rng, rng_seed, remat, 1,
                      group, implicit=False)


def _gang_mean(tensors: list, group) -> list:
    """Each tensor's mean over the ranks of ``group``: one all-reduce of
    one flat f32 buffer, each tensor back in its own dtype and shape."""
    from ..parallel.fsdp import count
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    count("all_reduce")
    flat /= dist.get_world_size(group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def _make_step(loss_fn, mutable, with_rng, rng_seed, remat, accum_steps,
               group, implicit: bool, on_mesh: _MeshStep | None = None
               ) -> Callable:
    rank = world = None
    if on_mesh is not None:
        group = on_mesh.group
    if group is not None:
        rank, world = dist.get_rank(group), dist.get_world_size(group)

    def run(model, batch, n_step, micro):
        if not with_rng:
            return loss_fn(model, batch)
        device = next(model.parameters()).device
        if group is None:
            return loss_fn(model, batch, rng=step_generator(
                rng_seed, n_step, device, micro))
        if not implicit:  # the rank's own key
            return loss_fn(model, batch, rng=step_generator(
                rng_seed, n_step, device, micro, rank=rank))
        n = len(next(iter(batch.values())))
        return loss_fn(model, batch, rng=RowWindow(
            step_generator(rng_seed, n_step, device, micro),
            rank * n, world * n))

    def forward(model, batch, n_step, micro=None):
        if remat:
            loss, *rest = checkpoint(run, model, batch, n_step, micro,
                                     use_reentrant=False)
        else:
            loss, *rest = run(model, batch, n_step, micro)
        return (loss.float(), *rest)

    def local_step(state: TrainState, batch):
        """(loss, aux, new model state or None, gradients) of this
        process's rows."""
        params = state.trainable()
        if accum_steps == 1:  # always, when mutable
            loss, aux, *rest = forward(state.model, batch, state.step)
            grads = torch.autograd.grad(loss, params)
            return loss, aux, (rest[0] if mutable else None), grads
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
        return loss, aux, None, grads

    def step(state: TrainState, batch):
        sharded = set()
        if on_mesh is not None:
            sharded = on_mesh.sharded(state.model)
            batch = on_mesh.rows(batch)
        synced = (sync_batch_stats(state.model, group)
                  if group is not None and implicit
                  else contextlib.nullcontext())
        with synced:
            loss, aux, new_ms, grads = local_step(state, batch)
        loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
        if group is not None:
            # synchronised statistics are equal on every rank already;
            # the explicit step's own ones are averaged with the rest.
            # A data-sharded parameter's gradient came out of its
            # reduce-scatter summed over the ranks: divided here.
            own = list(new_ms) if new_ms and not implicit else []
            params = state.trainable()
            whole = [i for i, p in enumerate(params) if id(p) not in sharded]
            out = iter(_gang_mean([*(grads[i] for i in whole), loss,
                                   *aux.values(),
                                   *(new_ms[k] for k in own)], group))
            grads = [g.div_(world) if id(p) in sharded and world > 1
                     else g for p, g in zip(params, grads)]
            for i in whole:
                grads[i] = next(out)
            loss = next(out)
            aux = {k: next(out) for k in aux}
            new_ms = {**new_ms, **{k: next(out) for k in own}} \
                if new_ms else new_ms
        for p, g in zip(state.trainable(), grads):
            p.grad = g
        state.apply_gradients()
        if new_ms:
            assign_buffers(state.model, new_ms)
        return state, {"loss": loss, **aux}

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
