"""Feature-engineering stages: VectorAssembler, StringIndexer,
StandardScaler, IndexToString.

The reference's pipelines leaned on Spark MLlib feature stages around the
deep-learning transformers (StringIndexer for labels, VectorAssembler to
join feature columns before a shallow learner — e.g. the upstream README's
``Pipeline([featurizer, lr])`` flows; SURVEY.md §1-L3). There is no JVM
MLlib here, so the framework carries the stages those flows need,
with the same Params surface and fit/transform semantics.

The port's copy of ``sparkdl_tpu/transformers/feature.py``. pyarrow and
the DataFrame module load inside the functions that use them, so
importing the port needs neither (a card path runs without pyarrow).
"""

from __future__ import annotations

import numpy as np

from ..core.params import (HasInputCol, HasOutputCol, Param, Params,
                           TypeConverters, keyword_only)
from ..core.pipeline import Estimator, Model, Transformer


def _check_no_nulls(arr, stage: str, col: str) -> None:
    """handleInvalid='error' guard. Top-level null_count misses a null
    *element inside* a list value (the list itself is non-null), which
    would silently become NaN through ``to_numpy(zero_copy_only=False)``
    — so list-typed columns are also checked flattened."""
    import pyarrow as pa

    n = arr.null_count
    if not n and (pa.types.is_list(arr.type)
                  or pa.types.is_large_list(arr.type)
                  or pa.types.is_fixed_size_list(arr.type)):
        flat = (arr.combine_chunks() if isinstance(arr, pa.ChunkedArray)
                else arr).flatten()
        n = flat.null_count
    if n:
        raise ValueError(
            f"{stage}: column {col!r} contains null values; clean or "
            f"filter nulls first")


def _toHandleInvalid(value):
    """Param converter: config errors surface at set() time on the driver
    (the core/params.py contract), not at transform time on a worker."""
    value = TypeConverters.toString(value)
    if value not in ("error", "keep"):
        raise TypeError(
            f"handleInvalid must be 'error' or 'keep', got {value!r} "
            "('skip' is not supported: the data plane's indexing op is "
            "length-preserving)")
    return value


class VectorAssembler(Transformer, HasOutputCol):
    """Concatenate numeric / vector columns into one flat feature vector
    (Spark MLlib surface: inputCols → outputCol)."""

    inputCols = Param(Params, "inputCols", "columns to concatenate",
                      TypeConverters.toListString)

    @keyword_only
    def __init__(self, inputCols=None, outputCol=None):
        super().__init__()
        self._setDefault(outputCol="features")
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCols=None, outputCol=None):
        return self._set(**self._input_kwargs)

    def _transform(self, dataset: DataFrame) -> DataFrame:
        cols = (self.getOrDefault(self.inputCols)
                if self.isDefined(self.inputCols) else None)
        if not cols:
            raise ValueError("VectorAssembler needs inputCols")
        out_col = self.getOutputCol()
        from ..core.frame import _row_wise_op, _set_column

        def op(batch: pa.RecordBatch) -> pa.RecordBatch:
            from .tensor import columnToNdarray
            pieces = []
            for c in cols:
                arr = batch.column(c)
                # Spark's handleInvalid='error' default: a null would
                # otherwise silently become NaN in the feature vector.
                # (No row index: this op sees streamed sub-batches, so
                # a local index would mislead.)
                _check_no_nulls(arr, "VectorAssembler", c)
                # zero-copy Arrow→ndarray (shared with the tensor
                # transformers); float64 end-to-end — the output column
                # type — so no silent float32 rounding; scalar columns
                # promote to (N, 1)
                pieces.append(columnToNdarray(arr, None, dtype=np.float64,
                                              atleast_2d=True))
            flat = np.concatenate(pieces, axis=1)
            # packed list<double> straight from the flat buffer (shared
            # with the scoring engine's output encode) — no per-row Python
            # list materialization on a column that may be the widest in
            # the pipeline
            from .xla_image import arrayColumnToArrow
            return _set_column(batch, out_col, arrayColumnToArrow(flat))

        # row-wise: each output row depends only on its own input row, so
        # the chain stays streamable (O(batchSize) host memory upstream)
        return dataset.mapBatches(_row_wise_op(op))


class StringIndexer(Estimator, HasInputCol, HasOutputCol):
    """Fit a label → index mapping over a string (or any hashable) column;
    indices are assigned by descending frequency, ties lexicographic —
    Spark's ``frequencyDesc`` order. Nulls are invalid values governed by
    ``handleInvalid`` (Spark semantics), never folded into a "None"
    label."""

    handleInvalid = Param(Params, "handleInvalid",
                          "'error' (default) or 'keep' (unseen/null → "
                          "n_labels)", _toHandleInvalid)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, handleInvalid=None):
        super().__init__()
        self._setDefault(handleInvalid="error")
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol=None, outputCol=None, handleInvalid=None):
        return self._set(**self._input_kwargs)

    def _fit(self, dataset: DataFrame) -> "StringIndexerModel":
        col = self.getInputCol()
        keep = self.getOrDefault(self.handleInvalid) == "keep"
        counts: dict = {}
        # non-null values coerce through str() on both fit and transform —
        # Spark casts the input column to string, and the labels Param
        # stores strings
        for batch in dataset.iterPartitions():
            for v in batch.column(col).to_pylist():
                if v is None:
                    if keep:
                        continue  # invalid value, excluded from the fit
                    raise ValueError(
                        f"StringIndexer: null in column {col!r} (set "
                        f"handleInvalid='keep' to bucket nulls with "
                        f"unseen labels)")
                counts[str(v)] = counts.get(str(v), 0) + 1
        labels = sorted(counts, key=lambda v: (-counts[v], v))
        model = StringIndexerModel(labels=labels)
        model._set(inputCol=col, outputCol=self.getOutputCol(),
                   handleInvalid=self.getOrDefault(self.handleInvalid))
        return model


class StringIndexerModel(Model, HasInputCol, HasOutputCol):
    handleInvalid = Param(Params, "handleInvalid",
                          "'error' (default) or 'keep' (unseen/null → "
                          "n_labels)", _toHandleInvalid)
    labels = Param(Params, "labels", "index → label mapping",
                   TypeConverters.toListString)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, handleInvalid=None,
                 labels=None):
        super().__init__()
        self._setDefault(handleInvalid="error")
        self._set(**self._input_kwargs)

    def _transform(self, dataset: DataFrame) -> DataFrame:
        col = self.getInputCol()
        out_col = self.getOutputCol()
        labels = self.getOrDefault(self.labels)
        index = {v: i for i, v in enumerate(labels)}
        keep = self.getOrDefault(self.handleInvalid) == "keep"
        unseen = len(labels)

        def to_index(v):
            if v is None:  # invalid value, not a "None" label
                if keep:
                    return unseen
                raise ValueError(
                    f"StringIndexerModel: null in column {col!r} (set "
                    f"handleInvalid='keep' to map nulls to {unseen})")
            v = str(v)
            if v in index:
                return index[v]
            if keep:
                return unseen
            raise ValueError(
                f"StringIndexerModel: unseen label {v!r} (set "
                f"handleInvalid='keep' to map unseen labels to "
                f"{unseen})")

        return dataset.withColumn(out_col, to_index, [col])


class StandardScaler(Estimator, HasInputCol, HasOutputCol):
    """Fit per-dimension mean/std over a vector column; transform
    standardizes (Spark MLlib surface: withMean/withStd flags, std uses
    the unbiased N-1 denominator like Spark)."""

    withMean = Param(Params, "withMean", "subtract the mean",
                     TypeConverters.toBoolean)
    withStd = Param(Params, "withStd", "divide by the std",
                    TypeConverters.toBoolean)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, withMean=None,
                 withStd=None):
        super().__init__()
        self._setDefault(withMean=False, withStd=True)
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol=None, outputCol=None, withMean=None,
                  withStd=None):
        return self._set(**self._input_kwargs)

    def _fit(self, dataset: DataFrame) -> "StandardScalerModel":
        from .tensor import columnToNdarray
        col = self.getInputCol()
        # single streaming pass, Welford/Chan parallel merge — a raw
        # sum-of-squares accumulator cancels catastrophically for
        # large-mean data (timestamp-scale values would fit std=0)
        n = 0
        mean = None
        m2 = None
        for batch in dataset.iterPartitions():
            if batch.num_rows == 0:
                continue
            arr = batch.column(col)
            _check_no_nulls(arr, "StandardScaler", col)
            x = columnToNdarray(arr, None, dtype=np.float64,
                                atleast_2d=True)
            bn = len(x)
            bmean = x.mean(0)
            bm2 = ((x - bmean) ** 2).sum(0)
            if n == 0:
                n, mean, m2 = bn, bmean, bm2
            else:
                delta = bmean - mean
                tot = n + bn
                mean = mean + delta * (bn / tot)
                m2 = m2 + bm2 + delta * delta * (n * bn / tot)
                n = tot
        if n == 0:
            raise ValueError("Cannot fit StandardScaler on an empty "
                             "DataFrame")
        var = m2 / max(n - 1, 1)  # unbiased (N-1), like Spark
        std = np.sqrt(np.maximum(var, 0.0))
        model = StandardScalerModel(mean=mean.tolist(), std=std.tolist())
        model._set(inputCol=col, outputCol=self.getOutputCol(),
                   withMean=self.getOrDefault(self.withMean),
                   withStd=self.getOrDefault(self.withStd))
        return model


class StandardScalerModel(Model, HasInputCol, HasOutputCol):
    withMean = Param(Params, "withMean", "subtract the mean",
                     TypeConverters.toBoolean)
    withStd = Param(Params, "withStd", "divide by the std",
                    TypeConverters.toBoolean)
    mean = Param(Params, "mean", "per-dimension mean",
                 TypeConverters.toListFloat)
    std = Param(Params, "std", "per-dimension std (N-1)",
                TypeConverters.toListFloat)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, withMean=None,
                 withStd=None, mean=None, std=None):
        super().__init__()
        self._setDefault(withMean=False, withStd=True)
        self._set(**self._input_kwargs)

    def _transform(self, dataset: DataFrame) -> DataFrame:
        from .tensor import columnToNdarray
        col = self.getInputCol()
        out_col = self.getOutputCol()
        mean = np.asarray(self.getOrDefault(self.mean))
        std = np.asarray(self.getOrDefault(self.std))
        sub_mean = self.getOrDefault(self.withMean)
        div_std = self.getOrDefault(self.withStd)
        # Spark semantics: a zero-std dimension SCALES BY 0 (output 0.0),
        # it does not pass the raw value through.
        factor = np.divide(1.0, std, out=np.zeros_like(std),
                           where=std > 0)
        import pyarrow as pa

        from ..core.frame import _row_wise_op, _set_column

        def op(batch: pa.RecordBatch) -> pa.RecordBatch:
            if batch.num_rows == 0:
                return _set_column(batch, out_col, pa.array(
                    [], type=pa.list_(pa.float64())))
            arr = batch.column(col)
            _check_no_nulls(arr, "StandardScalerModel", col)
            x = columnToNdarray(arr, None, dtype=np.float64,
                                atleast_2d=True)
            if x.shape[1:] != mean.shape:
                raise ValueError(
                    f"StandardScalerModel fitted on {mean.shape[0]} dims, "
                    f"got {x.shape[1:]} in column {col!r}")
            if sub_mean:
                x = x - mean
            if div_std:
                x = x * factor
            # packed list<double> from the flat buffer (see VectorAssembler)
            from .xla_image import arrayColumnToArrow
            return _set_column(batch, out_col, arrayColumnToArrow(x))

        return dataset.mapBatches(_row_wise_op(op))


class IndexToString(Transformer, HasInputCol, HasOutputCol):
    """Inverse of StringIndexer: index column → label strings."""

    labels = Param(Params, "labels", "index → label mapping",
                   TypeConverters.toListString)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, labels=None):
        super().__init__()
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol=None, outputCol=None, labels=None):
        return self._set(**self._input_kwargs)

    def _transform(self, dataset: DataFrame) -> DataFrame:
        labels = self.getOrDefault(self.labels)

        def to_label(i):
            i = int(i)
            if not 0 <= i < len(labels):
                raise ValueError(f"index {i} out of range for "
                                 f"{len(labels)} labels")
            return labels[i]

        return dataset.withColumn(self.getOutputCol(), to_label,
                                  [self.getInputCol()])
