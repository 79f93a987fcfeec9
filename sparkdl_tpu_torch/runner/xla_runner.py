"""XlaRunner — the training entry point of the port, for one process or a
data-parallel gang of processes, one device each.

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
then resumes from the last checkpoint.

**Data parallelism** is torch's idiom, one process a device: start N
copies of a worker script with ``runner.launcher.launch(script, np=N)``
(the ``mpirun`` role), and each builds ``XlaRunner(...)`` as it would in
one process. The launcher's ``SPARKDL_COORDINATOR`` /
``SPARKDL_NUM_PROCESSES`` / ``SPARKDL_PROCESS_ID`` (or the
``coordinator=``, ``num_processes=``, ``process_id=`` arguments) make
:func:`_init_gang` join ``torch.distributed`` once a process, over
``tcp://<coordinator>``: NCCL when the device is the card (rank r takes
``cuda:r``), gloo when the caller asked for the CPU. Every rank feeds its
own rows (``shard_batch``); the train step is the gang's
(``train_state.make_train_step(group=)``, synchronised BatchNorm) or, with
``explicit_collectives=True``, ``make_shard_map_step``'s. The reference's
single-controller form (one process driving N devices) is not torch's:
``np > 1`` without a rendezvous raises ``ValueError`` naming
``launcher.launch``.
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
import torch.distributed as dist

from ..utils.platform import resolve_device
from . import chaos
from . import data as data_lib
from . import events
from . import failures
from . import metrics as metrics_lib
from . import sentinel as sentinel_lib
from . import telemetry as telemetry_lib
from .checkpoint import CheckpointManager
from .failures import TrainingDivergedError
from .train_state import (TrainState, make_eval_step,
                          make_shard_map_step, make_train_step)

log = logging.getLogger("sparkdl_tpu_torch.runner")


_CURRENT_CONTEXT: list["RunnerContext"] = []


@dataclass(frozen=True)
class Gang:
    """This process's place in a data-parallel gang: ``group`` carries
    the device collectives (NCCL on the card, gloo on the CPU) and
    ``host_group`` the host-side ones over host values (row counts, the
    checkpoint step, the hvd-compat module's numpy): the same group under
    gloo, a gloo group beside NCCL's."""
    backend: str
    size: int
    rank: int
    group: Any = field(repr=False)
    host_group: Any = field(repr=False)


_GANG: list[Gang] = []  # the process's gang, once joined


def _rendezvous(coordinator: str | None, num_processes: int | None,
                process_id: int | None):
    """``(coordinator, num_processes, process_id)`` from the arguments or,
    when ``coordinator`` is None, from the launcher's ``SPARKDL_*`` env;
    None when neither names one."""
    if coordinator is None:
        coordinator = os.environ.get("SPARKDL_COORDINATOR") or None
        if coordinator:
            num_processes = int(os.environ["SPARKDL_NUM_PROCESSES"])
            process_id = int(os.environ["SPARKDL_PROCESS_ID"])
    if coordinator is None:
        return None
    if num_processes is None or process_id is None:
        raise ValueError("coordinator= needs num_processes= and "
                         "process_id=")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process_id={process_id} is outside a gang of "
                         f"{num_processes}")
    return coordinator, int(num_processes), int(process_id)


def _init_gang(coordinator: str, size: int, rank: int,
               backend: str) -> Gang:
    """Join the gang's ``torch.distributed`` process group, once a
    process. A second runner in the process reuses it; one that asks for
    another backend, size or rank raises (a process never switches from
    NCCL to gloo or back)."""
    if _GANG:
        g = _GANG[0]
        if (g.backend, g.size, g.rank) != (backend, size, rank):
            raise RuntimeError(
                f"this process joined a {g.backend} gang as rank {g.rank} "
                f"of {g.size}; it cannot also be rank {rank} of {size} "
                f"over {backend}")
        return g
    if dist.is_initialized():
        raise RuntimeError("torch.distributed was initialised outside the "
                           "runner; XlaRunner joins its gang itself")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=size, rank=rank)
    host = (dist.new_group(backend="gloo") if backend == "nccl"
            else dist.group.WORLD)
    g = Gang(backend=backend, size=size, rank=rank, group=dist.group.WORLD,
             host_group=host)
    _GANG.append(g)
    log.info("joined a %s gang: rank %d of %d via %s", backend, rank, size,
             coordinator)
    return g


def leave_gang() -> None:
    """Destroy this process's process group (no-op outside a gang); a
    worker calls it before it exits."""
    if _GANG:
        _GANG.clear()
        dist.destroy_process_group()


def current_context() -> "RunnerContext | None":
    """The context of the innermost running ``XlaRunner.run`` (or of
    ``api.init``), or None."""
    return _CURRENT_CONTEXT[-1] if _CURRENT_CONTEXT else None


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
    """What ``main_fn`` receives: the hvd-style identity (a process, one
    device, in a gang of ``size``), the device, the checkpoint manager and
    the training loop."""
    device: torch.device
    checkpoint_dir: str | None = None
    gang: Gang | None = None
    axes: dict | None = None
    log_dir: str | None = None
    _ckpt: CheckpointManager | None = field(default=None, repr=False)
    _mesh: Any = field(default=None, repr=False)

    # -- hvd-compat identity --------------------------------------------
    @property
    def size(self) -> int:
        """Devices in the gang (one a process): hvd.size."""
        return self.gang.size if self.gang else 1

    @property
    def rank(self) -> int:
        return self.gang.rank if self.gang else 0

    @property
    def num_processes(self) -> int:
        return self.size

    @property
    def local_device_count(self) -> int:
        return 1

    def _check_rows(self, n: int) -> None:
        """In a gang, raise unless every rank's batch has ``n`` rows (one
        host-side all-reduce of ``[n, −n]`` with MAX)."""
        if not self.gang:
            return
        t = torch.tensor([n, -n], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.gang.host_group)
        if int(t[0]) != n or -int(t[1]) != n:
            raise ValueError(
                f"rank {self.rank}'s batch has {n} rows, but the ranks' "
                f"batches range over {-int(t[1])}..{int(t[0])}: every rank "
                f"must pass a local shard of the same leading dim")

    def shard_batch(self, batch):
        """Host batch (a dict of numpy arrays or tensors, nested dicts
        allowed) → the same dict of tensors on the context's device. In a
        gang each rank passes its LOCAL shard (HorovodRunner semantics:
        every rank loads its own rows); a leading dim that differs
        between the ranks raises ``ValueError``."""
        self._check_rows(_rows(batch))
        return _to_device(batch, self.device)

    @torch.no_grad()
    def put_replicated(self, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer | None = None):
        """In a gang, rank 0's parameters, buffers and optimizer state
        broadcast to every rank, in place, so all start from one state
        (a no-op in one process). Returns ``model``."""
        if self.gang:
            tensors = [*model.parameters(), *model.buffers()]
            if optimizer is not None:
                tensors += [v for st in optimizer.state.values()
                            for v in st.values() if torch.is_tensor(v)]
            for t in tensors:
                if t.device == self.device:
                    dist.broadcast(t, src=0, group=self.gang.group)
                else:  # e.g. Adam's step count, kept on the host
                    moved = t.to(self.device)
                    dist.broadcast(moved, src=0, group=self.gang.group)
                    t.copy_(moved)
        return model

    # -- steps ------------------------------------------------------------
    @property
    def data_axis(self) -> str:
        """The mesh axis the batch is split over: the first of ``axes``."""
        return next(iter(self.axes)) if self.axes else "data"

    @property
    def mesh(self):
        """The gang's mesh over ``axes`` (default one ``{"data": size}``
        axis; ``core.runtime.make_mesh``), made at first use;
        ``ValueError`` outside a gang or when the axes do not multiply to
        the gang's size."""
        if self._mesh is None:
            from ..core.runtime import make_mesh
            self._mesh = make_mesh(self.axes or {"data": self.size})
        return self._mesh

    def make_train_step(self, loss_fn, explicit_collectives: bool = False,
                        **kw):
        """:func:`~.train_state.make_train_step` over the gang (None in
        one process), or with ``explicit_collectives``
        :func:`~.train_state.make_shard_map_step`. ``mesh=``,
        ``param_rules=`` or ``batch_spec=`` make it the FSDP×TP step over
        ``mesh`` (default: the context's :attr:`mesh`, as the reference
        passes the runner's)."""
        if not explicit_collectives and (
                kw.get("mesh") is not None
                or {"param_rules", "batch_spec"} & set(kw)):
            kw["mesh"] = kw.get("mesh") or self.mesh
            kw.setdefault("data_axis", self.data_axis)
            return make_train_step(loss_fn, **kw)
        group = self.gang.group if self.gang else None
        if explicit_collectives:
            return make_shard_map_step(loss_fn, group=group, **kw)
        return make_train_step(loss_fn, group=group, **kw)

    def make_eval_step(self, eval_fn):
        return make_eval_step(eval_fn)

    def trace(self, log_dir: str | None = None):
        """``with ctx.trace(dir): ...`` — a ``torch.profiler`` trace of
        the region (``metrics.trace``; CUDA too when the context trains on
        the card), written to ``dir/trace_rank{i}.json``; ``dir`` defaults
        to the runner's ``log_dir``, else ``sparkdl_tb`` in the temporary
        directory."""
        if log_dir is None:
            import tempfile
            log_dir = self.log_dir or os.path.join(tempfile.gettempdir(),
                                                   "sparkdl_tb")
        return metrics_lib.trace(log_dir, cuda=self.device.type == "cuda")

    def meter(self, warmup_steps: int = 1) -> metrics_lib.ThroughputMeter:
        """Counts global rows over ``n_chips = size``, so its per-chip rate
        is img/s/chip."""
        return metrics_lib.ThroughputMeter(n_chips=self.size,
                                           warmup_steps=warmup_steps)

    # -- checkpoints ------------------------------------------------------
    @property
    def checkpoints(self) -> CheckpointManager | None:
        """The context's :class:`~.checkpoint.CheckpointManager` over
        ``checkpoint_dir`` (None without one), opened at first use."""
        if self._ckpt is None and self.checkpoint_dir:
            self._ckpt = CheckpointManager(
                self.checkpoint_dir,
                group=self.gang.host_group if self.gang else None)
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
            feed_lookahead: int = 0,
            explicit_collectives: bool = False) -> dict:
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
        device, runs the step (:meth:`make_train_step` with ``mutable``,
        ``with_rng``, ``remat``, ``accum_steps`` and
        ``explicit_collectives``; a tail batch that does not divide by
        ``accum_steps`` is cropped, or skipped when smaller, without
        burning a step) and meters examples/s.

        **In a gang** every rank runs ``fit`` with its own ``data``: the
        batches it yields are the rank's local rows (a dataset made with
        ``shard=True`` cuts them from the global stream), of one leading
        dim on every rank (checked each step). The state starts as rank
        0's (:meth:`put_replicated`, after a resume too); the meter counts
        the gang's rows, so ``examples_per_sec_per_chip`` is per device;
        losses and eval metrics are the gang's means; checkpoints are
        written by rank 0 (``runner/checkpoint.py``).

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
        (``metrics.start_profiler_trace``: ``trace_rank{i}.json``, Chrome
        format) there, each step one ``metrics.step_annotation`` range.

        Flight-recorded (``runner.events``): ``fit_start``, ``train_resume``,
        per-step ``data_fetch`` / ``shard_put`` / ``step_compute`` spans,
        ``compile`` (the first step's wall time: allocation, autotuning,
        the first launches), ``checkpoint_save`` / ``checkpoint_restore``
        and ``eval`` spans and ``fit_end`` with the meter's summary. The
        env-armed layers start here: the telemetry plane
        (``SPARKDL_METRICS_DIR`` / ``SPARKDL_METRICS_PORT``, its snapshot
        flushed at the end and on a failure) and the sentinel
        (``SPARKDL_SENTINEL``). After each step call ``fit`` beats the
        heartbeat (``metrics.touch_heartbeat``, ``SPARKDL_HEARTBEAT_DIR``)
        and, with a dataset, appends the step's batch to the ledger
        (``data.append_ledger``, ``SPARKDL_BATCH_LEDGER``). The step call
        returns once the step is enqueued on the card, so the beat and
        the ledger line say the step was enqueued, not finished; neither
        waits for the device. The beat comes after the call, not before
        it: the first call holds the first step's set-up, which a
        watchdog armed by an earlier beat would read as a hang.

        Chaos sites (``runner.chaos``): ``step_start`` at the top of each
        step and ``batch_fetch`` on each drawn batch (its step is the
        train step the batch feeds).

        On any failure the ring's tail and the exception are flushed as a
        crash postmortem (``events.postmortem``, site ``fit`` or
        ``fit_finalize``) naming the step and, where it is exact, the
        batch: a failure while drawing names the batch being drawn (the
        dataset tags the exception), one in a step names that step's
        batch, and a divergence found at a ``log_every`` > 1 read names
        none (the batch that made the NaN lies anywhere in the window).
        The exception is marked ``_sparkdl_postmortemed`` so
        ``run_with_restarts`` does not overwrite the record."""
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
        self.put_replicated(state.model, state.optimizer)
        if dataset is not None:
            data_it = dataset.indexed()
        else:
            data_it = ((None, b) for b in iter(data))
        step_fn = self.make_train_step(
            loss_fn, explicit_collectives=explicit_collectives,
            mutable=mutable, with_rng=with_rng, remat=remat,
            accum_steps=accum_steps)
        eval_step = self.make_eval_step(eval_fn) if eval_fn else None
        meter = self.meter()
        meter.flops_per_step = flops_per_step
        # TensorBoard's scalars from rank 0 alone; every rank logs text
        logger = metrics_lib.MetricsLogger(self.log_dir if self.rank == 0
                                           else None)
        telemetry_lib.maybe_start_from_env()
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
        if profile_dir:
            metrics_lib.start_profiler_trace(
                profile_dir, cuda=self.device.type == "cuda")
        ckpt = self.checkpoints
        last_m = None
        i = start_step
        # cur_cursor names the batch of the step in flight (the
        # postmortem's attribution), last_cursor the one the last
        # completed step consumed (what the checkpoint keeps)
        cur_cursor: dict | None = None
        last_cursor: dict | None = None
        failed = False
        try:
            for i in range(start_step, num_steps):
                # cleared before anything this step can raise (the
                # step_start hook included), so a failure before the draw
                # never names the previous step's batch
                cur_cursor = None
                chaos.fire("step_start", step=i)
                try:
                    n_local, dev_batch, cur_cursor = next(staged_it)
                except StopIteration:
                    break
                # checked here, on the loop's thread: a lookahead stages
                # from worker threads, and collectives must keep one order
                self._check_rows(n_local)
                n = n_local * self.size  # the gang's rows this step
                with metrics_lib.step_annotation(i), \
                        events.span("step_compute", step=i) as sp:
                    state, m = step_fn(state, dev_batch)
                if i == start_step:
                    events.event("compile", step=i,
                                 dur_s=round(sp.seconds, 6))
                metrics_lib.touch_heartbeat(i)
                if cur_cursor is not None:
                    last_cursor = cur_cursor
                    data_lib.append_ledger(i, cur_cursor)
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
                                        self)
                    logger.log(i + 1, {f"eval_{k}": v for k, v in evm.items()})
        except BaseException as e:
            failed = True
            bi = getattr(e, "_sparkdl_batch_index", None)
            ep = getattr(e, "_sparkdl_batch_epoch", None)
            if bi is None and cur_cursor is not None and not (
                    isinstance(e, TrainingDivergedError)
                    and log_every != 1):
                bi = cur_cursor["batch_index"] - 1
                ep = cur_cursor.get("epoch")
            events.postmortem(e, site="fit", step=i, batch_index=bi,
                              epoch=ep)
            # the dying run's last telemetry snapshot is failure evidence
            # too (which stage was starving); a no-op when disarmed
            telemetry_lib.flush_snapshot()
            _mark_postmortemed(e)
            raise
        finally:
            staged_it.close()
            if profile_dir:
                metrics_lib.stop_profiler_trace(failed)
            if failed:
                self._close_checkpoints()
        try:
            if ckpt:
                # the final save waits; a step the loop just saved is not
                # written twice
                if last_m is not None:
                    _assert_finite_loss(last_m, state.step)
                if ckpt.latest_step() != state.step:  # waits for the writer
                    ckpt.save(state.step, state, wait=True,
                              data_cursor=last_cursor)
        except BaseException as e:
            events.postmortem(e, site="fit_finalize", step=i)
            _mark_postmortemed(e)
            self._close_checkpoints()
            raise
        summary = meter.summary()
        logger.log_summary(state.step, summary)
        logger.close()
        events.event("fit_end", final_step=state.step, steps=meter.steps,
                     mfu=summary.get("mfu"))
        # exact at the boundary, not one export interval stale
        telemetry_lib.flush_snapshot()
        return {"state": state, "meter": meter, "history": history}


def _staged(ctx: RunnerContext, data_it, crop, limit: int, start_step: int,
            lookahead: int):
    """``(rows, device_batch, cursor_after)`` for at most ``limit``
    batches: cropped, moved to the device inline or, with ``lookahead`` >
    0, that many batches ahead from worker threads. Nothing is drawn from
    ``data_it`` past ``limit``: a reused iterator sits where the inline
    feed leaves it.

    The rows are not checked against the gang's here (the loop does it
    on its own thread). On the card a worker first copies the batch into
    pinned host memory
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
                return n, _to_device(batch, ctx.device), cur
            pinned = _map(lambda x: torch.as_tensor(x).pin_memory(), batch)
            with torch.cuda.stream(side):
                return n, _to_device(pinned, ctx.device), cur

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
            batch = chaos.fire("batch_fetch", step=start_step + produced,
                               batch=batch)
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


def _mark_postmortemed(e: BaseException) -> None:
    """Mark ``e`` as already postmortemed by ``fit`` (with its step), so
    ``run_with_restarts`` does not overwrite the record."""
    try:
        e._sparkdl_postmortemed = True
    except Exception:
        pass  # exceptions with __slots__: the outer record is step-less


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


def _run_eval(eval_step, state, eval_data, ctx: RunnerContext):
    """Row-weighted means of ``eval_step``'s metrics over ``eval_data``;
    in a gang over every rank's rows (one host-side all-reduce)."""
    totals: dict[str, float] = {}
    n = 0
    for batch in eval_data:
        m = eval_step(state, ctx.shard_batch(batch))
        bs = _rows(batch)
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + float(v) * bs
        n += bs
    if ctx.gang:
        keys = sorted(totals)
        t = torch.tensor([totals[k] for k in keys] + [n],
                         dtype=torch.float64)
        dist.all_reduce(t, group=ctx.gang.host_group)
        totals, n = dict(zip(keys, t[:-1].tolist())), int(t[-1])
    return {k: v / max(n, 1) for k, v in totals.items()}


class XlaRunner:
    """``XlaRunner(np=1).run(main_fn, **kwargs)``: HorovodRunner's shape,
    one device a process.

    ``device``: where the context trains; None means ``cuda`` (and raises
    without a card), ``"cpu"`` asks for the CPU. ``checkpoint_dir``: where
    ``fit`` saves and resumes (none without it). ``axes``: the context's
    mesh over the gang (``core.runtime.make_mesh``, e.g. ``{"data": 2,
    "model": 2}``; the first axis is the data axis), default one ``data``
    axis. ``log_dir``: where ``fit`` writes TensorBoard scalars (rank 0;
    ``metrics.MetricsLogger``) and ``RunnerContext.trace`` its traces.

    ``np``: the devices to span, one a process; -1 (the default) means
    the gang's size, or 1 without a gang. A gang comes from
    ``launcher.launch`` (its ``SPARKDL_*`` env) or from ``coordinator``
    (``host:port`` of rank 0's rendezvous), ``num_processes`` and
    ``process_id``, and is joined here (:func:`_init_gang`): NCCL on the
    card, where rank r takes ``cuda:r`` and a gang larger than
    ``torch.cuda.device_count()`` raises ``ValueError`` before any
    rendezvous; gloo on the CPU. ``np > 1`` without a rendezvous raises
    ``ValueError``: one process drives one device here."""

    def __init__(self, np: int = -1, axes: dict[str, int] | None = None,
                 device=None, checkpoint_dir: str | None = None,
                 log_dir: str | None = None,
                 coordinator: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None):
        self.checkpoint_dir = checkpoint_dir
        self.axes = dict(axes) if axes else None
        self.log_dir = log_dir
        want = None if np in (-1, None) else int(np)
        rdv = _rendezvous(coordinator, num_processes, process_id)
        if rdv is None:
            if want not in (None, 1):
                raise ValueError(
                    f"np={want} needs a gang of {want} processes, one a "
                    f"device: start them with sparkdl_tpu_torch.runner."
                    f"launcher.launch(script, np={want}) (or pass "
                    f"coordinator=, num_processes=, process_id=). One "
                    f"process driving several devices (the reference's "
                    f"single controller) is not torch's form (ROADMAP.md, "
                    f"Queue C 2)")
            self.device = resolve_device(device)
            self.gang = None
            return
        coordinator, size, rank = rdv
        if want not in (None, size):
            raise ValueError(f"np={want}, but the gang has {size} "
                             f"processes (one a device)")
        dev = resolve_device(device)
        if dev.type == "cuda":
            visible = torch.cuda.device_count()
            if size > visible:
                raise ValueError(
                    f"np={size} exceeds visible devices ({visible}): rank "
                    f"r of a one-host gang takes cuda:r, and NCCL runs one "
                    f"rank a card")
            dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
            backend = "nccl"
        elif dev.type == "cpu":
            backend = "gloo"
        else:
            raise ValueError(f"no gang backend for device {dev}")
        self.device = dev
        self.gang = _init_gang(coordinator, size, rank, backend)

    def make_context(self) -> RunnerContext:
        return RunnerContext(device=self.device,
                             checkpoint_dir=self.checkpoint_dir,
                             gang=self.gang, axes=self.axes,
                             log_dir=self.log_dir)

    def run(self, main_fn: Callable, **kwargs) -> Any:
        """Invoke ``main_fn(ctx, **kwargs)`` with a fresh context (the
        current one, for ``runner.api``, while it runs). The ``worker``
        chaos site fires first."""
        chaos.fire("worker")
        ctx = self.make_context()
        _CURRENT_CONTEXT.append(ctx)
        try:
            return main_fn(ctx, **kwargs)
        finally:
            _CURRENT_CONTEXT.pop()

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
        first. A failure it re-raises gets a crash postmortem (site
        ``run_with_restarts``) unless ``fit`` already wrote one naming
        its step."""
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
                    if not getattr(e, "_sparkdl_postmortemed", False):
                        events.postmortem(e, site="run_with_restarts",
                                          kind=kind, attempt=attempt)
                    raise
                metrics_lib.run_stats.record_restart()
                events.event("restart", attempt=attempt, kind=kind,
                             error=f"{type(e).__name__}: {e}"[:300])
                log.exception("run failed (%s); restart %d/%d", kind,
                              attempt, max_restarts)
                time.sleep(backoff_s * attempt)
