"""XlaRunner — the training entry point of the port, for one process and one
device.

The counterpart of ``sparkdl_tpu/runner/xla_runner.py``; the names are
kept so a reader finds each piece's twin: ``XlaRunner(np=1).run(main_fn)``
hands ``main_fn`` a :class:`RunnerContext`, whose :meth:`RunnerContext.fit`
is the training loop::

    from sparkdl_tpu_torch.models import llama as L
    from sparkdl_tpu_torch.runner import XlaRunner

    model = L.LlamaModel(L.LlamaConfig.tiny(lora_rank=4), device="cpu")
    res = XlaRunner(np=1, device="cpu").run(lambda ctx: ctx.fit(
        loss_fn=L.causal_lm_loss_fn(), model=model,
        tx=L.lora_optimizer(5e-3), data=[{"input_ids": ids}] * 8,
        num_steps=8, log_every=1))

The device is the card unless the caller asks for the CPU (``device=None``
means ``cuda`` and raises without one). Not ported yet, each raising
``NotImplementedError`` that names its ROADMAP.md item: ``np > 1``
(data parallelism over several cards, Queue A 8), checkpoints and resume
(``runner/checkpoint.py``, Queue A 3), ``profile_dir`` and
``feed_lookahead`` (Queue A 3).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..utils.platform import resolve_device
from . import data as data_lib
from . import events
from . import metrics as metrics_lib
from . import sentinel as sentinel_lib
from .train_state import TrainState, make_eval_step, make_train_step

log = logging.getLogger("sparkdl_tpu_torch.runner")


class TrainingDivergedError(RuntimeError):
    """The train loop produced a non-finite loss (the JAX package's
    ``runner.failures.TrainingDivergedError``): restarting from the same
    data and weights would diverge again."""

    def __init__(self, step: int, value: float | None = None):
        super().__init__(
            f"training diverged: non-finite loss ({value}) at step {step}")
        self.step = step
        self.value = value


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to sparkdl_tpu_torch yet (ROADMAP.md, {item})")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree) if not torch.is_tensor(tree)
                           else tree).to(device)


def _rows(batch) -> int:
    leaf = batch
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return len(leaf)


def _nbytes(batch) -> int:
    if isinstance(batch, dict):
        return sum(_nbytes(v) for v in batch.values())
    return int(getattr(batch, "nbytes", 0))


@dataclass
class RunnerContext:
    """What ``main_fn`` receives: the hvd-style identity (one process, one
    device), the device, and the training loop."""
    device: torch.device

    # -- hvd-compat identity --------------------------------------------
    @property
    def size(self) -> int:
        return 1

    @property
    def rank(self) -> int:
        return 0

    def shard_batch(self, batch):
        """Host batch (a dict of numpy arrays or tensors, nested dicts
        allowed) → the same dict of tensors on the context's device."""
        return _to_device(batch, self.device)

    # -- steps ------------------------------------------------------------
    def make_train_step(self, loss_fn, **kw):
        return make_train_step(loss_fn, **kw)

    def make_eval_step(self, eval_fn):
        return make_eval_step(eval_fn)

    def meter(self, warmup_steps: int = 1) -> metrics_lib.ThroughputMeter:
        return metrics_lib.ThroughputMeter(n_chips=self.size,
                                           warmup_steps=warmup_steps)

    # -- the training loop --------------------------------------------------
    def fit(self, *, loss_fn: Callable, model: torch.nn.Module, tx: Callable,
            data: Iterable, num_steps: int, log_every: int = 10,
            eval_fn: Callable | None = None,
            eval_data: Iterable | None = None, eval_every: int = 0,
            remat: bool = False, accum_steps: int = 1,
            flops_per_step: float | None = None,
            checkpoint_every: int = 0, resume: bool = False,
            profile_dir: str | None = None,
            feed_lookahead: int | None = None) -> dict:
        """Run a training loop; returns ``{state, meter, history}``.

        ``loss_fn(model, batch) -> (loss, aux)``; ``tx`` builds the
        optimizer from the model (``models.llama.lora_optimizer``);
        ``model`` should already lie on the context's device. Streams
        ``data`` — a bare iterator of host batch dicts, or a list, a
        generator factory or a :class:`~.data.CheckpointableDataset`,
        which ``data.as_dataset`` turns into a dataset with a cursor and
        the ``SPARKDL_SKIP_BATCHES`` skip-list — moves each batch to the
        device, runs the step (:func:`~.train_state.make_train_step`
        with ``remat`` and ``accum_steps``; a tail batch that does not
        divide by ``accum_steps`` is cropped, or skipped when smaller,
        without burning a step) and meters examples/s.

        Every ``log_every`` steps, and at the last, the step's metrics are
        read (a wait for the device), the loss is checked to be finite
        (:class:`TrainingDivergedError` if not), logged and appended to
        ``history`` with ``examples_per_sec_per_chip``. With
        ``log_every=1`` every step waits, so the meter's step times are
        device step times. ``flops_per_step`` feeds the meter's MFU
        against ``metrics.peak_flops_per_chip()``.

        Flight-recorded (``runner.events``): ``fit_start``, per-step
        ``data_fetch`` / ``shard_put`` / ``step_compute`` spans, ``eval``
        spans and ``fit_end`` with the meter's summary."""
        if checkpoint_every or resume:
            raise _not_ported("checkpoint_every / resume "
                              "(runner/checkpoint.py)", "Queue A 3")
        if profile_dir is not None:
            raise _not_ported("profile_dir", "Queue A 3")
        if feed_lookahead:
            raise _not_ported("feed_lookahead", "Queue A 3")
        if log_every < 1:
            raise ValueError(f"log_every must be >= 1, got {log_every}")
        state = TrainState.create(model, tx)
        dataset = data_lib.as_dataset(data)
        if dataset is not None:
            dataset.extend_skip(data_lib.env_skip_list())
            data_it = dataset.indexed()
        else:
            data_it = ((None, b) for b in iter(data))
        step_fn = self.make_train_step(loss_fn, remat=remat,
                                       accum_steps=accum_steps)
        eval_step = self.make_eval_step(eval_fn) if eval_fn else None
        meter = self.meter()
        meter.flops_per_step = flops_per_step
        logger = metrics_lib.MetricsLogger()
        sentinel_lib.maybe_arm_from_env()
        events.event("fit_start", start_step=0, num_steps=num_steps,
                     n_chips=self.size, device=str(self.device))
        history: list[dict] = []

        def _crop(batch):
            """The accum_steps tail crop; None skips the batch."""
            n = _rows(batch)
            keep = (n // accum_steps) * accum_steps
            if keep == n:
                return batch
            if keep == 0:
                log.warning("skipping tail batch of %d rows (< accum_steps "
                            "= %d)", n, accum_steps)
                return None
            log.warning("cropping tail batch %d -> %d rows for "
                        "accum_steps=%d", n, keep, accum_steps)
            return _map(lambda x: x[:keep], batch)

        def _next_batch(step: int):
            while True:
                with events.span("data_fetch", step=step):
                    try:
                        _, batch = next(data_it)
                    except StopIteration:
                        return None
                batch = _crop(batch)
                if batch is not None:
                    return batch

        for i in range(num_steps):
            batch = _next_batch(i)
            if batch is None:
                break
            n = _rows(batch)
            with events.span("shard_put", rows=n, bytes=_nbytes(batch)):
                dev_batch = self.shard_batch(batch)
            with events.span("step_compute", step=i):
                state, m = step_fn(state, dev_batch)
            if (i + 1) % log_every == 0 or i + 1 == num_steps:
                m = {k: float(v) for k, v in m.items()}
                _assert_finite_loss(m, i + 1)
                meter.update(n)
                m["examples_per_sec_per_chip"] = \
                    meter.recent_examples_per_sec() / max(self.size, 1)
                logger.log(i + 1, m)
                history.append({"step": i + 1, **m})
            else:
                meter.update(n)
            if eval_step and eval_every and (i + 1) % eval_every == 0 \
                    and eval_data is not None:
                with events.span("eval", step=i + 1):
                    evm = _run_eval(eval_step, state, eval_data,
                                    self.shard_batch)
                logger.log(i + 1, {f"eval_{k}": v for k, v in evm.items()})
        summary = meter.summary()
        logger.log_summary(state.step, summary)
        events.event("fit_end", final_step=state.step, steps=meter.steps,
                     mfu=summary.get("mfu"))
        return {"state": state, "meter": meter, "history": history}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _assert_finite_loss(m: dict, step: int):
    """The train loop's divergence guard: a non-finite loss raises
    :class:`TrainingDivergedError` naming the step."""
    v = m.get("loss")
    if v is not None and not np.isfinite(float(v)):
        raise TrainingDivergedError(step, float(v))


def _run_eval(eval_step, state, eval_data, shard):
    totals: dict[str, float] = {}
    n = 0
    for batch in eval_data:
        m = eval_step(state, shard(batch))
        bs = _rows(batch)
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + float(v) * bs
        n += bs
    return {k: v / max(n, 1) for k, v in totals.items()}


class XlaRunner:
    """``XlaRunner(np=1).run(main_fn, **kwargs)`` — one process, one device.

    ``device``: where the context trains; None means ``cuda`` (and raises
    without a card), ``"cpu"`` asks for the CPU."""

    def __init__(self, np: int = 1, device=None):
        if np != 1:
            raise _not_ported(f"np={np} (data parallelism over several "
                              f"cards, DDP)", "Queue A 8")
        self.device = resolve_device(device)

    def make_context(self) -> RunnerContext:
        return RunnerContext(device=self.device)

    def run(self, main_fn: Callable, **kwargs) -> Any:
        """Invoke ``main_fn(ctx, **kwargs)`` with a fresh context."""
        return main_fn(self.make_context(), **kwargs)
