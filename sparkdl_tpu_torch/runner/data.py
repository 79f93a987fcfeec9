"""Checkpointable training data plane: replayable batch sources with a
cursor.

The port's copy of ``sparkdl_tpu/runner/data.py`` (see its docstring for
the exactly-once design): :class:`CheckpointableDataset`,
:class:`ListDataset`, :class:`FactoryDataset`, :class:`ArrowDataset` (over
``core.frame.DataFrame.iterBatches``, with :func:`record_batch_to_numpy`),
:func:`as_dataset` and :func:`env_skip_list`. A dataset yields
``(cursor_after, batch)`` pairs from :meth:`CheckpointableDataset.indexed`;
``fit`` streams them, saves the cursor of the last completed step with
each checkpoint (``runner/checkpoint.py``) and, on resume, restores the
dataset there. ``shard=True`` cuts each rank's rows from the global
stream in a data-parallel gang. The ``data_fetch`` chaos site fires as
each batch is drawn, with the batch index as its step, so a fault can
target one batch across restarts; with ``SPARKDL_BATCH_LEDGER`` set,
``fit`` appends one line a completed step to the **batch ledger**
(:func:`append_ledger`, :func:`read_ledger`), the exactly-once audit
trail across restarts.

A **skip-list** (``SPARKDL_SKIP_BATCHES``, a JSON list of batch indices)
names batches that are consumed but never yielded, nor examined.

Import surface: stdlib + numpy; :class:`ArrowDataset` reads a DataFrame
(pyarrow), which its caller brings.
"""

from __future__ import annotations

import inspect
import json
import logging
import os
import time
from typing import Any, Callable, Iterable, Iterator

from . import chaos, events

__all__ = ["CheckpointableDataset", "ListDataset", "FactoryDataset",
           "ArrowDataset", "record_batch_to_numpy", "as_dataset",
           "env_skip_list", "append_ledger", "read_ledger", "SKIP_ENV",
           "LEDGER_ENV"]

log = logging.getLogger("sparkdl_tpu_torch.runner")

SKIP_ENV = "SPARKDL_SKIP_BATCHES"
LEDGER_ENV = "SPARKDL_BATCH_LEDGER"


def _tag_batch(exc: BaseException, epoch: int, batch_index: int):
    """Attach the (epoch, batch_index) being drawn when ``exc`` was
    raised, so a draw-time failure names its batch."""
    try:
        exc._sparkdl_batch_epoch = epoch
        exc._sparkdl_batch_index = batch_index
    except Exception:
        pass  # exceptions with __slots__: lose the tag, not the raise


class CheckpointableDataset:
    """Base class: deterministic, restartable, skip-list-aware batch source.

    Subclasses implement :meth:`_epoch_iter` — a FRESH iterator over one
    epoch's batches, identical on every call with the same ``epoch`` (this
    is what makes replay from a cursor exact). ``epochs=None`` loops
    forever; ``epochs=k`` stops after k passes.

    ``shard=True`` opts into per-rank row sharding: the dataset yields
    the GLOBAL batch stream and each rank of the launcher's gang
    (``SPARKDL_NUM_PROCESSES``, ``SPARKDL_PROCESS_ID``) takes its
    contiguous share of every batch's rows, so one cursor and one
    skip-list describe the whole gang. The default (``False``) keeps
    ``fit``'s gang contract: the batches are ALREADY this rank's rows and
    are never re-sliced. Remainder rows are cropped, so every rank keeps
    an equal leading dim; leaves that cannot be sliced (scalars, 0-d
    arrays) are replicated.
    """

    def __init__(self, epochs: int | None = 1, shard: bool = False,
                 skip_list: Iterable[int] | None = None):
        self.epochs = epochs
        self.skip_list: set[int] = {int(i) for i in (skip_list or ())}
        self._epoch = 0
        self._start_index = 0  # next in-epoch batch index to draw
        self._shard = shard

    # -- subclass contract -------------------------------------------------
    def _epoch_iter(self, epoch: int) -> Iterator[Any]:
        raise NotImplementedError

    # -- cursor ------------------------------------------------------------
    def state(self) -> dict:
        """Small JSON-able cursor: position before the next batch to draw."""
        return {"epoch": self._epoch, "batch_index": self._start_index,
                "skip_list": sorted(self.skip_list)}

    def restore(self, state: dict):
        """Reposition iteration at ``state`` (union its skip-list in).
        Call before :meth:`indexed` — a live iterator is not rewound."""
        self._epoch = int(state.get("epoch", 0))
        self._start_index = int(state.get("batch_index", 0))
        self.extend_skip(state.get("skip_list") or ())

    def extend_skip(self, indices: Iterable[int]):
        self.skip_list.update(int(i) for i in indices)

    # -- iteration ---------------------------------------------------------
    def indexed(self) -> Iterator[tuple[dict, Any]]:
        """Yield ``(cursor_after, batch)``: the batch plus the state that
        replays everything after it. Fast-forward past an earlier restore
        point is draw-and-discard; skip-listed indices are consumed but
        not yielded (a ``train_batch_skipped`` event marks each), and the
        ``data_fetch`` chaos site fires per yielded batch with its index
        (a fault it raises is tagged with that batch)."""
        epoch, start = self._epoch, self._start_index
        while self.epochs is None or epoch < self.epochs:
            drew = 0
            it = enumerate(self._epoch_iter(epoch))
            while True:
                try:
                    idx, batch = next(it)
                except StopIteration:
                    break
                except BaseException as e:
                    # the failing index == the number of draws so far
                    _tag_batch(e, epoch, drew)
                    raise
                drew += 1
                if idx < start:
                    continue
                self._epoch, self._start_index = epoch, idx + 1
                if idx in self.skip_list:
                    events.event("train_batch_skipped", epoch=epoch,
                                 batch_index=idx)
                    continue
                try:
                    batch = chaos.fire("data_fetch", step=idx, batch=batch)
                except BaseException as e:
                    _tag_batch(e, epoch, idx)
                    raise
                yield ({"epoch": epoch, "batch_index": idx + 1,
                        "skip_list": sorted(self.skip_list)},
                       self._shard_rows(batch))
            if not drew:
                return  # empty epoch: a looping source must not spin
            epoch, start = epoch + 1, 0
            self._epoch, self._start_index = epoch, 0

    def __iter__(self) -> Iterator[Any]:
        return (batch for _, batch in self.indexed())

    def _shard_rows(self, batch):
        """This rank's contiguous share of ``batch``'s rows (the batch
        itself without ``shard`` or outside a gang)."""
        world = int(os.environ.get("SPARKDL_NUM_PROCESSES", "1"))
        if not self._shard or world <= 1:
            return batch
        rank = int(os.environ.get("SPARKDL_PROCESS_ID", "0"))

        def cut(x):
            if isinstance(x, dict):
                return {k: cut(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(cut(v) for v in x)
            try:
                per = len(x) // world
            except TypeError:
                return x  # a scalar or 0-d leaf: replicated
            return x[rank * per:(rank + 1) * per]

        return cut(batch)


class ListDataset(CheckpointableDataset):
    """In-memory list of batches. ``shuffle_seed`` reshuffles per epoch
    with a deterministic permutation (``RandomState(seed + epoch)``), so
    restore replays the identical order; the seed rides in the cursor.

    Skip-list positions are per epoch: with ``shuffle_seed`` and several
    epochs a skipped position shields a different batch each epoch (a
    warning logs when the two are combined)."""

    def __init__(self, batches: list, epochs: int | None = 1,
                 shuffle_seed: int | None = None, **kw):
        super().__init__(epochs=epochs, **kw)
        self._batches = list(batches)
        self.shuffle_seed = shuffle_seed
        self._warned_shuffle_skip = False
        self._warn_shuffle_skip()

    def extend_skip(self, indices: Iterable[int]):
        super().extend_skip(indices)
        self._warn_shuffle_skip()

    def _warn_shuffle_skip(self):
        if self._warned_shuffle_skip or self.shuffle_seed is None \
                or self.epochs == 1 or not self.skip_list:
            return
        self._warned_shuffle_skip = True
        log.warning(
            "ListDataset: skip-list positions are per-epoch; with "
            "shuffle_seed and multiple epochs a skipped position "
            "shields a different batch each epoch (see docstring)")

    def _epoch_iter(self, epoch: int) -> Iterator[Any]:
        order: Iterable[int] = range(len(self._batches))
        if self.shuffle_seed is not None:
            import numpy as np
            order = np.random.RandomState(
                (self.shuffle_seed + epoch) % (2 ** 32)).permutation(
                    len(self._batches))
        return (self._batches[int(i)] for i in order)

    def state(self) -> dict:
        d = super().state()
        if self.shuffle_seed is not None:
            d["shuffle_seed"] = self.shuffle_seed
        return d

    def restore(self, state: dict):
        # A cursor saved under another permutation schedule maps its
        # positions to other batches: restore, but on record.
        saved = state.get("shuffle_seed")
        if saved is not None and saved != self.shuffle_seed:
            log.warning(
                "ListDataset.restore: cursor was saved with "
                "shuffle_seed=%s but this dataset uses %s — positions "
                "map to different batches; restoring anyway, on record",
                saved, self.shuffle_seed)
            events.event("unverified_data_cursor",
                         reason=f"shuffle_seed mismatch: cursor has "
                                f"{saved}, dataset has {self.shuffle_seed}")
        super().restore(state)


class FactoryDataset(CheckpointableDataset):
    """Wrap a generator *factory*: ``factory()`` (or ``factory(epoch)``
    when the callable takes a required positional argument) returns a
    fresh batch iterator per epoch. The factory must be deterministic —
    same epoch, same batches."""

    def __init__(self, factory: Callable, epochs: int | None = 1, **kw):
        super().__init__(epochs=epochs, **kw)
        self._factory = factory
        try:
            # a defaulted parameter (lambda n=100: ...) is configuration,
            # not the epoch
            params = [
                p for p in inspect.signature(factory).parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is inspect.Parameter.empty]
            self._epoch_aware = len(params) >= 1
        except (TypeError, ValueError):
            self._epoch_aware = False

    def _epoch_iter(self, epoch: int) -> Iterator[Any]:
        it = self._factory(epoch) if self._epoch_aware else self._factory()
        return iter(it)


def record_batch_to_numpy(rb) -> dict:
    """Arrow RecordBatch → ``{column: numpy array}`` (the host-batch shape
    ``fit()`` consumes). Numeric columns convert zero-copy where Arrow
    allows; nested list columns fall back through ``to_pylist`` (2-D when
    rectangular)."""
    import numpy as np
    out = {}
    for name, col in zip(rb.schema.names, rb.columns):
        try:
            arr = col.to_numpy(zero_copy_only=False)
        except Exception:
            arr = np.asarray(col.to_pylist())
        if getattr(arr, "dtype", None) is not None and arr.dtype == object:
            arr = np.asarray(col.to_pylist())
        out[name] = arr
    return out


class ArrowDataset(CheckpointableDataset):
    """Adapter over ``DataFrame.iterBatches(batch_size)`` — a DataFrame
    becomes a checkpointable trainer input. ``convert`` (default
    :func:`record_batch_to_numpy`) maps each RecordBatch to the host-numpy
    batch dict the step function expects."""

    def __init__(self, df, batch_size: int, convert: Callable | None = None,
                 epochs: int | None = 1, **kw):
        super().__init__(epochs=epochs, **kw)
        self._df = df
        self._batch_size = int(batch_size)
        self._convert = convert or record_batch_to_numpy

    def _epoch_iter(self, epoch: int) -> Iterator[Any]:
        # Skip-listed indices yield the RAW RecordBatch, never converted:
        # indexed() discards skipped values unexamined, so a record whose
        # decode is the poison is skippable without touching it.
        return (rb if i in self.skip_list else self._convert(rb)
                for i, rb in enumerate(
                    self._df.iterBatches(self._batch_size)))


def as_dataset(data) -> CheckpointableDataset | None:
    """Coerce ``fit(data=...)``'s argument to a checkpointable dataset:
    a :class:`CheckpointableDataset` passes through, a callable becomes a
    :class:`FactoryDataset`, a list or tuple of batches a one-pass
    :class:`ListDataset`; anything else (a bare iterator, consumable
    once) returns None and ``fit`` streams it without a cursor."""
    if isinstance(data, CheckpointableDataset):
        return data
    if callable(data):
        return FactoryDataset(data)
    if isinstance(data, (list, tuple)):
        return ListDataset(list(data))
    return None


def env_skip_list(environ=None) -> list[int]:
    """Decode ``SPARKDL_SKIP_BATCHES`` (a JSON int list). Malformed values
    log and return [] — a bad env var must degrade to no-skip, not kill
    the worker."""
    text = (environ if environ is not None else os.environ).get(SKIP_ENV)
    if not text:
        return []
    try:
        return [int(i) for i in json.loads(text)]
    except (ValueError, TypeError):
        log.warning("ignoring unparseable %s=%r", SKIP_ENV, text)
        return []


def append_ledger(step: int, cursor: dict | None):
    """Batch ledger: one JSON line a step, ``{step, epoch, batch_index,
    skip_list, world, t}``, appended to ``ledger_rank{i}.jsonl`` under
    ``SPARKDL_BATCH_LEDGER`` (a no-op when unset or without a cursor).
    The step is ledgered when it has been enqueued, which may precede a
    divergence found at a later read of the loss; a replayed attempt
    supersedes it, so an audit takes the last line per step. Append
    mode: the file survives a kill up to the last step and accumulates
    across restart attempts (the exactly-once audit needs them all).
    ``world`` is the gang's size when the batch was drawn; the skip-list
    in force lets an audit tell a legal remap (a batch quarantined in
    between) from a replay that diverged."""
    d = os.environ.get(LEDGER_ENV)
    if not d or cursor is None:
        return
    rank = os.environ.get("SPARKDL_PROCESS_ID", "0")
    try:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"ledger_rank{rank}.jsonl"), "a") as f:
            f.write(json.dumps({
                "step": int(step),
                "epoch": cursor.get("epoch"),
                "batch_index": int(cursor.get("batch_index", 0)) - 1,
                "skip_list": cursor.get("skip_list") or [],
                "world": int(os.environ.get("SPARKDL_NUM_PROCESSES", "1")),
                "t": round(time.time(), 3)}) + "\n")
    except OSError:
        pass  # a torn-down tmpdir must not kill the train loop


def read_ledger(directory: str, rank: int = 0) -> list[dict]:
    """Parse one rank's batch ledger (torn tail lines skipped)."""
    path = os.path.join(directory, f"ledger_rank{rank}.jsonl")
    out = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue  # torn tail line from a killed rank
    except OSError:
        pass
    return out
