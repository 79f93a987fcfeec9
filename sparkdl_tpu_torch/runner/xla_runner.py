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
means ``cuda`` and raises without one). ``XlaRunner(checkpoint_dir=)``
gives ``fit`` checkpoints and resume (``runner/checkpoint.py``), and
:meth:`XlaRunner.run_with_restarts` re-runs a failed ``main_fn``, which
then resumes from the last checkpoint. Not ported yet: ``np > 1`` (data
parallelism, ROADMAP.md Queue A 3 (c) over A 8's collectives) raises
``NotImplementedError`` naming Queue A 8.
"""

from __future__ import annotations

import collections
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..utils.platform import resolve_device
from . import chaos
from . import data as data_lib
from . import events
from . import failures
from . import metrics as metrics_lib
from . import sentinel as sentinel_lib
from .checkpoint import CheckpointManager
from .failures import TrainingDivergedError
from .train_state import TrainState, make_eval_step, make_train_step

log = logging.getLogger("sparkdl_tpu_torch.runner")


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
    device), the device, the checkpoint manager and the training loop."""
    device: torch.device
    checkpoint_dir: str | None = None
    _ckpt: CheckpointManager | None = field(default=None, repr=False)

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

    # -- checkpoints ------------------------------------------------------
    @property
    def checkpoints(self) -> CheckpointManager | None:
        """The context's :class:`~.checkpoint.CheckpointManager` over
        ``checkpoint_dir`` (None without one), opened at first use."""
        if self._ckpt is None and self.checkpoint_dir:
            self._ckpt = CheckpointManager(self.checkpoint_dir)
        return self._ckpt

    def _close_checkpoints(self):
        """Error-path cleanup: close the manager once (finishing an
        in-flight save) and drop it, so a retry on this context opens its
        own."""
        ckpt, self._ckpt = self._ckpt, None
        if ckpt is not None:
            try:
                ckpt.close()
            except Exception:
                log.warning("checkpoint close on error path failed",
                            exc_info=True)

    # -- the training loop --------------------------------------------------
    def fit(self, *, loss_fn: Callable, model: torch.nn.Module, tx: Callable,
            data: Iterable, num_steps: int, log_every: int = 10,
            eval_fn: Callable | None = None,
            eval_data: Iterable | None = None, eval_every: int = 0,
            mutable: bool = False, with_rng: bool = False,
            remat: bool = False, accum_steps: int = 1,
            flops_per_step: float | None = None,
            checkpoint_every: int = 0, resume: bool = True,
            profile_dir: str | None = None,
            feed_lookahead: int = 0) -> dict:
        """Run a training loop; returns ``{state, meter, history}``.

        ``loss_fn(model, batch) -> (loss, aux)``, or ``(loss, aux,
        new_model_state)`` with ``mutable=True`` (BatchNorm models: the
        statistics live in the model's buffers, so there is no
        ``model_state`` argument); ``tx`` builds the optimizer from the
        model (``train_state.sgd``, ``adam``,
        ``models.llama.lora_optimizer``); ``model`` should already lie on
        the context's device. Streams ``data`` — a bare iterator of host
        batch dicts, or a list, a generator factory or a
        :class:`~.data.CheckpointableDataset`, which ``data.as_dataset``
        turns into a dataset with a cursor and the
        ``SPARKDL_SKIP_BATCHES`` skip-list — moves each batch to the
        device, runs the step (:func:`~.train_state.make_train_step` with
        ``mutable``, ``with_rng``, ``remat`` and ``accum_steps``; a tail
        batch that does not divide by ``accum_steps`` is cropped, or
        skipped when smaller, without burning a step) and meters
        examples/s.

        Every ``log_every`` steps, and at the last, the step's metrics are
        read (a wait for the device), the loss is checked to be finite
        (:class:`TrainingDivergedError` if not), logged and appended to
        ``history`` with ``examples_per_sec_per_chip``. With
        ``log_every=1`` every step waits, so the meter's step times are
        device step times. ``flops_per_step`` feeds the meter's MFU
        against ``metrics.peak_flops_per_chip()``.

        **Checkpoints** (the context's ``checkpoint_dir``): every
        ``checkpoint_every`` steps the loss is checked to be finite and
        the state saved, with the data cursor of the last completed step
        when ``data`` is a dataset; at the end a final save that waits.
        With ``resume`` (the default) and a checkpoint present, the
        model, optimizer and step are restored first and a dataset
        restarts at the saved cursor, so the loop runs the steps left to
        ``num_steps``. On a failure the manager is closed once (an
        in-flight save lands) and the error re-raised.

        ``feed_lookahead`` > 0 moves batches that many steps ahead to the
        device from worker threads (0, the default, moves each inline),
        never drawing past the steps the loop will run; on the card the
        workers copy on a stream of their own, so a copy overlaps the
        steps before it.
        ``profile_dir`` writes a ``torch.profiler`` trace of the steps
        (``trace_rank0.json``, Chrome format) there.

        Flight-recorded (``runner.events``): ``fit_start``, ``train_resume``,
        per-step ``data_fetch`` / ``shard_put`` / ``step_compute`` spans,
        ``checkpoint_save`` / ``checkpoint_restore`` and ``eval`` spans and
        ``fit_end`` with the meter's summary. The crash postmortem the
        reference writes on a failure comes with ``events.postmortem``
        (ROADMAP.md, Queue A 7)."""
        if log_every < 1:
            raise ValueError(f"log_every must be >= 1, got {log_every}")
        state = TrainState.create(model, tx)
        dataset = data_lib.as_dataset(data)
        if dataset is not None:
            dataset.extend_skip(data_lib.env_skip_list())
        start_step = 0
        if resume and self.checkpoints and \
                self.checkpoints.latest_step() is not None:
            state = self.checkpoints.restore(state)
            start_step = int(state.step)
            cursor = None
            if dataset is not None and start_step > 0:
                cursor = self.checkpoints.data_cursor(start_step)
                if cursor is not None:
                    dataset.restore(cursor)
            events.event("train_resume", step=start_step,
                         batch_index=(cursor or {}).get("batch_index"),
                         epoch=(cursor or {}).get("epoch"),
                         verified_cursor=cursor is not None)
            log.info("resumed from checkpoint at step %d%s", start_step,
                     f" (data cursor {cursor})" if cursor else "")
        if dataset is not None:
            data_it = dataset.indexed()
        else:
            data_it = ((None, b) for b in iter(data))
        step_fn = self.make_train_step(loss_fn, mutable=mutable,
                                       with_rng=with_rng, remat=remat,
                                       accum_steps=accum_steps)
        eval_step = self.make_eval_step(eval_fn) if eval_fn else None
        meter = self.meter()
        meter.flops_per_step = flops_per_step
        logger = metrics_lib.MetricsLogger()
        sentinel_lib.maybe_arm_from_env()
        events.event("fit_start", start_step=start_step,
                     num_steps=num_steps, n_chips=self.size,
                     device=str(self.device))
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

        staged_it = _staged(self, data_it, _crop, num_steps - start_step,
                            start_step, int(feed_lookahead))
        prof = _start_profiler(profile_dir, self.device)
        ckpt = self.checkpoints
        last_m = None
        last_cursor: dict | None = None
        failed = False
        try:
            for i in range(start_step, num_steps):
                chaos.fire("step_start", step=i)
                try:
                    n, dev_batch, cur = next(staged_it)
                except StopIteration:
                    break
                with events.span("step_compute", step=i):
                    state, m = step_fn(state, dev_batch)
                if cur is not None:
                    last_cursor = cur
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
                last_m = m
                if checkpoint_every and ckpt and \
                        (i + 1) % checkpoint_every == 0:
                    # the divergence guard before the save: a non-finite
                    # checkpoint would poison every resume
                    _assert_finite_loss(m, i + 1)
                    ckpt.save(i + 1, state, data_cursor=last_cursor)
                if eval_step and eval_every and (i + 1) % eval_every == 0 \
                        and eval_data is not None:
                    with events.span("eval", step=i + 1):
                        evm = _run_eval(eval_step, state, eval_data,
                                        self.shard_batch)
                    logger.log(i + 1, {f"eval_{k}": v for k, v in evm.items()})
            if ckpt:
                # the final save waits; a step the loop just saved is not
                # written twice
                if last_m is not None:
                    _assert_finite_loss(last_m, state.step)
                if ckpt.latest_step() != state.step:  # waits for the writer
                    ckpt.save(state.step, state, wait=True,
                              data_cursor=last_cursor)
        except BaseException:
            failed = True
            raise
        finally:
            staged_it.close()
            _stop_profiler(prof, profile_dir, failed)
            if failed:
                self._close_checkpoints()
        summary = meter.summary()
        logger.log_summary(state.step, summary)
        events.event("fit_end", final_step=state.step, steps=meter.steps,
                     mfu=summary.get("mfu"))
        return {"state": state, "meter": meter, "history": history}


def _staged(ctx: RunnerContext, data_it, crop, limit: int, start_step: int,
            lookahead: int):
    """``(rows, device_batch, cursor_after)`` for at most ``limit``
    batches: cropped, moved to the device inline or, with ``lookahead`` >
    0, that many batches ahead from worker threads. Nothing is drawn from
    ``data_it`` past ``limit``: a reused iterator sits where the inline
    feed leaves it.

    On the card a worker first copies the batch into pinned host memory
    (on an H100 a side-stream copy from pageable memory hid none of its
    time behind the steps; from pinned memory it hid most of it), then
    ``shard_batch`` moves it on a side stream, which does not wait for
    the steps queued on the loop's stream and has finished when it
    returns. Each staged
    tensor is recorded on the loop's stream so the allocator does not
    hand its memory back to the side stream while a step still reads
    it."""
    side = (torch.cuda.Stream(ctx.device)
            if lookahead > 0 and ctx.device.type == "cuda" else None)

    def one(cur, batch):
        n = _rows(batch)
        with events.span("shard_put", rows=n, bytes=_nbytes(batch)):
            if side is None:
                return n, ctx.shard_batch(batch), cur
            pinned = _map(lambda x: torch.as_tensor(x).pin_memory(), batch)
            with torch.cuda.stream(side):
                return n, ctx.shard_batch(pinned), cur

    def handed(staged):
        if side is not None:
            loop_stream = torch.cuda.current_stream(ctx.device)
            _map(lambda t: t.record_stream(loop_stream), staged[1])
        return staged

    def cropped():
        produced = 0
        while produced < limit:
            try:
                with events.span("data_fetch", step=start_step + produced):
                    cur, batch = next(data_it)
            except StopIteration:
                return
            batch = crop(batch)
            if batch is None:
                continue
            produced += 1
            yield cur, batch

    if lookahead <= 0:
        for cur, batch in cropped():
            yield one(cur, batch)
        return
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=lookahead,
                              thread_name_prefix="sparkdl-shard")
    pending: collections.deque = collections.deque()
    try:
        for cur, batch in cropped():
            pending.append(pool.submit(one, cur, batch))
            while len(pending) > lookahead:
                yield handed(pending.popleft().result())
        while pending:
            yield handed(pending.popleft().result())
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def _start_profiler(profile_dir: str | None, device: torch.device):
    """A running ``torch.profiler`` over the CPU and, on the card, CUDA
    (None without ``profile_dir``)."""
    if not profile_dir:
        return None
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    events.event("profile_trace", dir=os.path.abspath(profile_dir))
    return prof


def _stop_profiler(prof, profile_dir: str | None, failed: bool) -> None:
    """Stop the trace and write it; while a failure unwinds, a stop that
    fails is logged and does not replace the training error."""
    if prof is None:
        return
    try:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(profile_dir,
                                              "trace_rank0.json"))
    except Exception:
        if not failed:
            raise
        log.warning("profiler stop failed during exception unwind",
                    exc_info=True)


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
    without a card), ``"cpu"`` asks for the CPU. ``checkpoint_dir``: where
    ``fit`` saves and resumes (none without it)."""

    def __init__(self, np: int = 1, device=None,
                 checkpoint_dir: str | None = None):
        if np != 1:
            raise _not_ported(f"np={np} (data parallelism over several "
                              f"cards, DDP)", "Queue A 8")
        self.device = resolve_device(device)
        self.checkpoint_dir = checkpoint_dir

    def make_context(self) -> RunnerContext:
        return RunnerContext(device=self.device,
                             checkpoint_dir=self.checkpoint_dir)

    def run(self, main_fn: Callable, **kwargs) -> Any:
        """Invoke ``main_fn(ctx, **kwargs)`` with a fresh context."""
        return main_fn(self.make_context(), **kwargs)

    def run_with_restarts(self, main_fn: Callable, max_restarts: int = 2,
                          backoff_s: float = 1.0, retry_all: bool = False,
                          **kwargs) -> Any:
        """Checkpoint-and-restart supervision: re-invoke ``main_fn`` on a
        failure, with a fresh context each time; with a ``checkpoint_dir``
        its ``fit`` resumes from the last saved step, so a restart loses
        at most ``checkpoint_every`` steps.

        Failures are classified by ``failures.classify_exception``: only
        infrastructure faults (device unavailable, preemption, timeouts)
        restart; program errors (``ValueError`` and the like, a diverged
        loss, a CUDA out-of-memory) re-raise at once. ``retry_all=True``
        retries everything. Attempt ``k`` waits ``backoff_s·k`` seconds
        first. The crash postmortem the reference writes before
        re-raising comes with ``events.postmortem`` (ROADMAP.md, Queue
        A 7)."""
        attempt = 0
        while True:
            try:
                return self.run(main_fn, **kwargs)
            except Exception as e:
                kind = failures.classify_exception(e)
                metrics_lib.run_stats.record_failure(
                    kind, f"{type(e).__name__}: {e}")
                attempt += 1
                if (kind == "fatal" and not retry_all) \
                        or attempt > max_restarts:
                    raise
                metrics_lib.run_stats.record_restart()
                events.event("restart", attempt=attempt, kind=kind,
                             error=f"{type(e).__name__}: {e}"[:300])
                log.exception("run failed (%s); restart %d/%d", kind,
                              attempt, max_restarts)
                time.sleep(backoff_s * attempt)
