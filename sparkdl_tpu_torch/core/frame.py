"""Arrow-native columnar DataFrame — the data plane of the framework.

The port's copy of ``sparkdl_tpu/core/frame.py`` (jax-free there too),
carried over unchanged but for its comments. The data plane is pyarrow
RecordBatches, partitioned, with a lazy per-batch op chain —
``mapBatches`` is the ``mapPartitions`` analogue and the single primitive
every transformer lowers to.

Laziness model: narrow ops (select/withColumn/filter/mapBatches) append to
an op chain and are applied per-partition on materialization; this keeps a
chain of transformers single-pass over the data.

This module imports pyarrow and pandas. Nothing the package imports
eagerly imports it: ``import sparkdl_tpu_torch`` works without pyarrow,
and ``sparkdl_tpu_torch.DataFrame`` loads this module on first use.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import pandas as pd
import pyarrow as pa


class Row(dict):
    """Dict with attribute access, mirroring pyspark.sql.Row ergonomics."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def asDict(self):
        return dict(self)


def _to_arrow_array(values, length: int) -> pa.Array:
    if isinstance(values, (pa.Array, pa.ChunkedArray)):
        arr = values.combine_chunks() if isinstance(values, pa.ChunkedArray) else values
    elif isinstance(values, np.ndarray):
        if values.ndim == 1:
            arr = pa.array(values)
        else:
            # N-d numpy → nested lists so tensor columns keep their shape.
            arr = pa.array(values.tolist())
    else:
        arr = pa.array(list(values))
    if len(arr) != length:
        raise ValueError(f"Column length {len(arr)} != batch length {length}")
    return arr


class DataFrame:
    """A partitioned, lazily-transformed collection of Arrow RecordBatches."""

    def __init__(self, partitions: Sequence[pa.RecordBatch],
                 ops: tuple[Callable[[pa.RecordBatch], pa.RecordBatch], ...] = ()):
        self._partitions = list(partitions)
        self._ops = tuple(ops)

    # -- constructors ------------------------------------------------------
    @classmethod
    def fromPandas(cls, df: pd.DataFrame, numPartitions: int = 1) -> "DataFrame":
        table = pa.Table.from_pandas(df, preserve_index=False)
        return cls.fromArrow(table, numPartitions)

    @classmethod
    def fromArrow(cls, table: pa.Table, numPartitions: int = 1) -> "DataFrame":
        n = max(1, len(table))
        numPartitions = max(1, min(numPartitions, n))
        per = -(-n // numPartitions)
        parts = []
        for start in range(0, n, per):
            chunk = table.slice(start, per).combine_chunks()
            if len(chunk):
                parts.append(chunk.to_batches(max_chunksize=per)[0])
            else:
                parts.append(pa.RecordBatch.from_arrays(
                    [pa.array([], type=f.type) for f in table.schema],
                    schema=table.schema))
        return cls(parts)

    @classmethod
    def fromPydict(cls, data: dict[str, Any], numPartitions: int = 1) -> "DataFrame":
        cols = {}
        for k, v in data.items():
            if isinstance(v, np.ndarray) and v.ndim > 1:
                cols[k] = pa.array(v.tolist())
            else:
                cols[k] = pa.array(v) if not isinstance(v, pa.Array) else v
        return cls.fromArrow(pa.table(cols), numPartitions)

    @classmethod
    def fromRows(cls, rows: Sequence[dict], numPartitions: int = 1) -> "DataFrame":
        if not rows:
            raise ValueError("fromRows needs at least one row")
        keys = list(rows[0].keys())
        return cls.fromPydict({k: [r[k] for r in rows] for k in keys},
                              numPartitions)

    # -- schema ------------------------------------------------------------
    @property
    def schema(self) -> pa.Schema:
        if not self._partitions:
            return pa.schema([])
        probe = self._apply_ops(self._partitions[0].slice(0, min(
            1, self._partitions[0].num_rows)))
        return probe.schema

    @property
    def columns(self) -> list[str]:
        return list(self.schema.names)

    # -- lazy narrow ops ---------------------------------------------------
    def mapBatches(self, fn: Callable[[pa.RecordBatch], pa.RecordBatch]) -> "DataFrame":
        """The mapPartitions analogue — everything lowers to this."""
        return DataFrame(self._partitions, self._ops + (fn,))

    def mapStream(self, fn: Callable[[Iterator[pa.RecordBatch]],
                                     Iterator[pa.RecordBatch]],
                  changes_length: bool = False) -> "DataFrame":
        """Stream-level mapBatches: ``fn`` sees the iterator of ALL
        partition batches at materialization time and yields exactly one
        output batch per input batch, in order — same-length unless
        ``changes_length`` (a quarantining scorer drops dead-lettered
        rows, so ``limit``/``count`` must give up their lazy fast paths).

        This is the primitive behind the streaming inference engine: a
        per-batch op (``mapBatches``) is re-invoked per partition, so any
        device pipeline inside it drains its in-flight window at every
        partition boundary; a stream op is invoked ONCE per materialization
        and can keep one continuous batch stream flowing through the
        device across partitions. Still lazy — the op chain composes and
        runs single-pass like every other narrow op."""
        return DataFrame(self._partitions,
                         self._ops + (_StreamOp(fn, changes_length),))

    def select(self, *cols: str) -> "DataFrame":
        names = list(cols)
        return self.mapBatches(_row_wise_op(lambda b: b.select(names)))

    def drop(self, *cols: str) -> "DataFrame":
        dropped = set(cols)

        def op(b: pa.RecordBatch) -> pa.RecordBatch:
            keep = [c for c in b.schema.names if c not in dropped]
            return b.select(keep)

        return self.mapBatches(_row_wise_op(op))

    def withColumn(self, name: str, fn: Callable[..., Any],
                   inputCols: Sequence[str] | None = None) -> "DataFrame":
        """Row-wise column: fn(*row_values) per row. Convenience path — hot
        paths should use withColumnBatch."""
        in_cols = list(inputCols) if inputCols else None

        def op(b: pa.RecordBatch) -> pa.RecordBatch:
            srcs = in_cols if in_cols is not None else b.schema.names
            pylists = [b.column(c).to_pylist() for c in srcs]
            out = [fn(*vals) for vals in zip(*pylists)] if pylists else []
            return _set_column(b, name, pa.array(out))

        return self.mapBatches(_row_wise_op(op))

    def withColumnBatch(self, name: str, fn: Callable[..., Any],
                        inputCols: Sequence[str]) -> "DataFrame":
        """Vectorized column: fn(*arrow_arrays) → array-like of batch length."""
        in_cols = list(inputCols)

        def op(b: pa.RecordBatch) -> pa.RecordBatch:
            out = fn(*[b.column(c) for c in in_cols])
            return _set_column(b, name, _to_arrow_array(out, b.num_rows))

        return self.mapBatches(_length_preserving(op))

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        def op(b: pa.RecordBatch) -> pa.RecordBatch:
            names = [new if c == old else c for c in b.schema.names]
            return pa.RecordBatch.from_arrays(list(b.columns), names=names)

        return self.mapBatches(_row_wise_op(op))

    def filter(self, predicate: Callable[[Row], bool]) -> "DataFrame":
        def op(b: pa.RecordBatch) -> pa.RecordBatch:
            mask = pa.array([bool(predicate(Row(r)))
                             for r in b.to_pylist()], type=pa.bool_())
            return b.filter(mask)

        op._changes_length = True
        op._row_wise = True  # per-chunk == per-partition for row predicates
        return self.mapBatches(op)

    # -- materialization ---------------------------------------------------
    def _apply_ops_stream(self, stream: Iterator[pa.RecordBatch]
                          ) -> Iterator[pa.RecordBatch]:
        """Compose the op chain over a batch stream: per-batch ops map
        batch-wise, stream ops wrap the whole iterator (each output batch
        still corresponds 1:1, in order, to an input batch). Lazy —
        nothing runs until the returned iterator is pulled."""
        for op in self._ops:
            if isinstance(op, _StreamOp):
                stream = op.fn(stream)
            else:
                stream = map(op, stream)
        return stream

    def _apply_ops(self, batch: pa.RecordBatch) -> pa.RecordBatch:
        out = None
        for out in self._apply_ops_stream(iter([batch])):
            pass
        if out is None:
            raise ValueError("stream op yielded no batch for its input")
        return out

    def iterPartitions(self) -> Iterator[pa.RecordBatch]:
        yield from self._apply_ops_stream(iter(self._partitions))

    def _streamable(self) -> bool:
        """True when every pending op is tagged ROW-WISE (each output row
        depends only on its own input row: select/withColumn/filter/decode),
        so applying it per sub-partition chunk equals per-partition.
        Length-preserving alone is NOT sufficient — a withColumnBatch fn may
        aggregate across its batch (e.g. mean-centering) and must keep
        partition granularity."""
        return all(getattr(op, "_row_wise", False) for op in self._ops)

    def _iter_materialized(self, chunk_rows: int | None) -> Iterator[pa.RecordBatch]:
        """Materialized stream at the smallest safe granularity.

        When the op chain is streamable and a chunk size is given, raw
        partitions are sliced BEFORE ops run, so a partition of N rows never
        holds more than ``chunk_rows`` decoded/processed rows in memory at
        once — the lazy data plane that lets readImages→featurize score 1M
        images in O(batchSize) host memory. User
        ``mapBatches`` fns are untagged → conservatively partition-at-a-time.
        """
        if chunk_rows is not None and self._ops and self._streamable():
            for p in self._partitions:
                for start in range(0, p.num_rows, chunk_rows):
                    yield self._apply_ops(p.slice(start, chunk_rows))
        else:
            yield from self.iterPartitions()

    def iterBatches(self, batchSize: int) -> Iterator[pa.RecordBatch]:
        """Re-chunked stream of materialized batches — the feeder input.

        Partition boundaries are erased: output batches are exactly
        ``batchSize`` rows except possibly the last, which is what a static-
        shape XLA program wants (pad-and-mask handled downstream).

        The carry is a deque of zero-copy batch slices, drained head-first
        per emitted batch — each row is concatenated exactly once, so the
        re-chunking cost stays linear in rows however many tiny partitions
        feed it (the old table-carry re-concatenated the whole remainder
        per partition: quadratic on many-small-partition datasets).
        """
        buf: collections.deque[pa.RecordBatch] = collections.deque()
        buffered = 0

        def emit(n: int) -> pa.RecordBatch:
            nonlocal buffered
            take, taken = [], 0
            while taken < n:
                b = buf.popleft()
                need = n - taken
                if b.num_rows > need:
                    buf.appendleft(b.slice(need))  # zero-copy remainder
                    b = b.slice(0, need)
                take.append(b)
                taken += b.num_rows
            buffered -= n
            if len(take) == 1 and take[0].num_rows == n:
                return take[0]
            if hasattr(pa, "concat_batches"):
                # Single-copy splice: the spanning batch's rows
                # land once in fresh contiguous buffers — no intermediate
                # Table + combine_chunks round-trip — so the downstream
                # zero-copy column views (imageColumnNHWCView) see the
                # back-to-back layout they need.
                return pa.concat_batches(take)
            t = pa.Table.from_batches(take).combine_chunks()
            return t.to_batches(max_chunksize=n)[0]

        for part in self._iter_materialized(batchSize):
            if not part.num_rows:
                continue
            buf.append(part)
            buffered += part.num_rows
            while buffered >= batchSize:
                yield emit(batchSize)
        if buffered:
            yield emit(buffered)

    def cache(self) -> "DataFrame":
        """Materialize the op chain now (eager) — analogous to df.cache()."""
        return DataFrame(list(self.iterPartitions()))

    def repartition(self, numPartitions: int) -> "DataFrame":
        return DataFrame.fromArrow(self.toArrow(), numPartitions)

    @property
    def numPartitions(self) -> int:
        return len(self._partitions)

    def randomSplit(self, weights: Sequence[float],
                    seed: int = 0) -> list["DataFrame"]:
        """Random row split by ``weights`` (Spark API; normalizes weights).
        Materializes the table once, permutes rows with the seeded PRNG."""
        import numpy as np
        if not weights or any(w <= 0 for w in weights):
            raise ValueError(f"weights must be positive, got {weights}")
        table = self.toArrow()
        n = table.num_rows
        perm = np.random.RandomState(seed).permutation(n)
        total = float(sum(weights))
        bounds = np.cumsum([w / total for w in weights])[:-1]
        cuts = [int(round(b * n)) for b in bounds]
        out = []
        for idxs in np.split(perm, cuts):
            out.append(DataFrame.fromArrow(
                table.take(pa.array(np.sort(idxs)))))
        return out

    @classmethod
    def fromParquet(cls, path: str, numPartitions: int | None = None
                    ) -> "DataFrame":
        """Read a parquet file OR dataset directory. Row groups become
        partitions (across every file of a directory) unless
        ``numPartitions`` forces a re-split — the durable interchange
        format for feature columns (the Spark reference read/wrote
        DataFrames via parquet natively)."""
        import pyarrow.dataset as ds
        import pyarrow.parquet as pq
        if numPartitions is None:
            parts = []
            for frag in ds.dataset(path, format="parquet").get_fragments():
                for rg in frag.split_by_row_group():
                    t = rg.to_table().combine_chunks()
                    parts.extend(t.to_batches(max_chunksize=max(1, len(t))))
            if parts:
                return cls(parts)
        table = pq.read_table(path)
        return cls.fromArrow(table, numPartitions or 1)

    def toParquet(self, path: str) -> None:
        """Write all partitions as one parquet file, one row group per
        non-empty partition (fromParquet then round-trips that
        partitioning; zero-row partitions are dropped — their degenerate
        column types cannot be written, exactly as toArrow drops them).
        One streaming pass: the op chain runs once, one partition
        resident at a time."""
        import pyarrow.parquet as pq
        writer = None
        first = None  # schema fallback for an all-empty frame
        try:
            for b in self.iterPartitions():
                if first is None:
                    first = b
                if not b.num_rows:
                    continue
                if writer is None:
                    # schema from the first NON-empty batch: an empty
                    # batch may carry degenerate null-typed op columns
                    # that would poison the file schema
                    writer = pq.ParquetWriter(path, b.schema)
                writer.write_table(pa.Table.from_batches([b]))
            if writer is None and first is not None:
                writer = pq.ParquetWriter(path, first.schema)
        finally:
            if writer is not None:
                writer.close()

    def toArrow(self) -> pa.Table:
        batches = [b for b in self.iterPartitions()]
        # Zero-row batches can carry degenerate column types (an op cannot
        # infer its output type from no rows); they contribute nothing, so
        # drop them whenever a non-empty batch fixes the schema.
        nonempty = [b for b in batches if b.num_rows]
        if nonempty:
            return pa.Table.from_batches(nonempty)
        if batches:
            return pa.Table.from_batches(batches[:1])
        return pa.table({})

    def toPandas(self) -> pd.DataFrame:
        return self.toArrow().to_pandas()

    def collect(self) -> list[Row]:
        return [Row(r) for r in self.toArrow().to_pylist()]

    def take(self, n: int) -> list[Row]:
        out: list[Row] = []
        for part in self.iterPartitions():
            for r in part.slice(0, n - len(out)).to_pylist():
                out.append(Row(r))
            if len(out) >= n:
                break
        return out

    def first(self) -> Row:
        rows = self.take(1)
        if not rows:
            raise ValueError("DataFrame is empty")
        return rows[0]

    def limit(self, n: int) -> "DataFrame":
        if not any(_op_changes_length(o) for o in self._ops):
            # Fast path: ops preserve row count, so slicing raw partitions is
            # exactly equivalent and stays lazy.
            rows_remaining = n
            parts = []
            for p in self._partitions:
                if rows_remaining <= 0:
                    break
                take = min(rows_remaining, p.num_rows)
                parts.append(p.slice(0, take))
                rows_remaining -= take
            return DataFrame(parts, self._ops)
        # Length-changing ops (filter) must run before the limit applies.
        rows_remaining = n
        parts = []
        for part in self.iterPartitions():
            if rows_remaining <= 0:
                break
            take = min(rows_remaining, part.num_rows)
            parts.append(part.slice(0, take))
            rows_remaining -= take
        return DataFrame(parts)

    def count(self) -> int:
        if not any(_op_changes_length(o) for o in self._ops):
            return sum(p.num_rows for p in self._partitions)
        return sum(b.num_rows for b in self.iterPartitions())

    def show(self, n: int = 20, truncate: int = 20) -> None:
        """Spark-style table print of the first ``n`` rows. ``truncate``:
        max cell width; 0/False disables, True means the Spark default of
        20 (bool is an int subclass — without normalizing, True would hit
        the <4 prefix branch and cut every cell to one char).
        Materializes only ``take(n)``."""
        if truncate is True:
            truncate = 20
        elif truncate is False:
            truncate = 0
        rows = self.take(n)
        cols = self.columns

        def cell(v) -> str:
            s = str(v)
            if truncate and len(s) > truncate:
                # Spark semantics: truncate < 4 is a plain prefix (no room
                # for an ellipsis inside the width budget)
                s = (s[:truncate] if truncate < 4
                     else s[:truncate - 3] + "...")
            return s

        data = [[cell(r.get(c)) for c in cols] for r in rows]
        widths = [max(len(c), *(len(d[i]) for d in data)) if data
                  else len(c) for i, c in enumerate(cols)]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        print(sep)
        print("|" + "|".join(f" {c:<{w}} "
                             for c, w in zip(cols, widths)) + "|")
        print(sep)
        for d in data:
            print("|" + "|".join(f" {v:<{w}} "
                                 for v, w in zip(d, widths)) + "|")
        print(sep)

    def __repr__(self) -> str:
        try:
            cols = ", ".join(f"{f.name}:{f.type}" for f in self.schema)
        except Exception:
            cols = "?"
        return (f"DataFrame[{cols}] "
                f"({self.numPartitions} partition(s), {len(self._ops)} pending op(s))")


class _StreamOp:
    """A stream-level op (see :meth:`DataFrame.mapStream`): ``fn`` maps the
    whole partition-batch iterator, one output batch per input batch.
    Length-preserving by default (so ``limit``/``count`` keep their lazy
    fast paths); a quarantining scorer passes ``changes_length=True``.
    Never row-wise: it must see partition-sized batches, not
    sub-partition slices."""

    __slots__ = ("fn", "_changes_length")

    def __init__(self, fn, changes_length: bool = False):
        self.fn = fn
        self._changes_length = changes_length


def _op_changes_length(op) -> bool:
    # Ops built by filter() are tagged; user mapBatches fns are untagged and
    # conservatively treated as length-changing (they may re-chunk or drop).
    return getattr(op, "_changes_length", None) is not False


def _length_preserving(op):
    op._changes_length = False
    return op


def _row_wise_op(op):
    """Length-preserving AND row-wise: eligible for streamed (sub-partition)
    application — see DataFrame._streamable."""
    op._changes_length = False
    op._row_wise = True
    return op


def _set_column(batch: pa.RecordBatch, name: str, array: pa.Array) -> pa.RecordBatch:
    names = list(batch.schema.names)
    arrays = list(batch.columns)
    if name in names:
        arrays[names.index(name)] = array
    else:
        names.append(name)
        arrays.append(array)
    return pa.RecordBatch.from_arrays(arrays, names=names)
