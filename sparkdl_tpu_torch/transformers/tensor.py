"""XlaTransformer — apply a torch function to a numeric array column;
KerasTransformer — the same with a saved Keras model.

The port's ``sparkdl_tpu/transformers/tensor.py``. The reference's
``TFTransformer`` role: a **torch callable**
``fn(batch)`` over ``(N, ...)`` float32 batches (a tensor on the
transformer's device) runs in one device step per chunk, on the same
:class:`~..core.runtime.BatchRunner` and streaming scorer as the image
transformers. The name is kept for the reference's API; there is no XLA.
:class:`KerasTransformer` runs a saved Keras model on Keras's torch
backend (``keras_utils``; keras is imported when the model is loaded).

pyarrow is imported inside the functions that read a DataFrame, so this
module, and the runner it builds (``_get_runner()``, the card's device
step), import without it.
"""

from __future__ import annotations

from ..core import ingest
from ..core.ingest import columnToNdarray
from ..core.params import (HasBatchSize, HasDevice, HasInputCol, HasOnError,
                           HasOutputCol, Param, Params, TypeConverters,
                           keyword_only)
from ..core.pipeline import Transformer
from ..core.runtime import BatchRunner
from .keras_utils import keras_file_to_fn
from .payloads import BundlesModelFile, PicklesCallableParams


class XlaTransformer(PicklesCallableParams, Transformer, HasInputCol,
                     HasOutputCol, HasBatchSize, HasOnError, HasDevice):
    """Applies ``fn(batch)`` (a torch callable, float32 tensor in, tensor
    out) to a numeric array column (the TFTransformer analogue).
    ``onError='quarantine'`` dead-letters rows whose payload fails to
    decode (ragged or mis-shaped arrays) instead of killing the job.
    ``device``: unset → the card; ``"cpu"`` must be asked for."""

    fn = Param(Params, "fn", "torch callable over (N, ...) float32 batches",
               TypeConverters.toCallable)
    inputShape = Param(Params, "inputShape",
                       "per-row shape to reshape flat list columns to "
                       "(optional; flat rows default to (N, D))",
                       TypeConverters.toShape)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, fn=None,
                 inputShape=None, batchSize=None, onError=None, device=None):
        super().__init__()
        self._setDefault(batchSize=64, onError="raise")
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol=None, outputCol=None, fn=None,
                  inputShape=None, batchSize=None, onError=None, device=None):
        return self._set(**self._input_kwargs)

    def _make_fn(self):
        return self.getOrDefault(self.fn)

    def _runner_key(self) -> tuple:
        return (self.getBatchSize(), self.getDevice(),
                id(self._paramMap.get(self.fn)))

    def _get_runner(self) -> BatchRunner:
        """One BatchRunner per (batch size, device, fn): the device step,
        which ``.run(host float32 batches)`` drives without a
        DataFrame."""
        key = self._runner_key()
        cached = getattr(self, "_runner_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        runner = BatchRunner(self._make_fn(), self.getBatchSize(),
                             device=self.getDevice())
        self._runner_cache = (key, runner)
        return runner

    def _transform(self, dataset):
        import pyarrow as pa

        from .streaming import StreamScorer
        from .xla_image import arrayColumnToArrow, emptyVectorColumn
        in_col = self.getInputCol()
        batch_size = self.getBatchSize()
        shape = (self.getOrDefault(self.inputShape)
                 if self.isDefined(self.inputShape) else None)
        runner = self._get_runner()

        def make_decoder(batch):
            # one device chunk at a time (zero-copy Arrow → ndarray per
            # slice): peak host memory O(batchSize); the quarantine
            # fallback calls the same decoder per row
            col = batch.column(in_col)

            def decode(start: int, length: int):
                return columnToNdarray(col.slice(start, length), shape)

            return decode

        def decoder_spec(batch):
            # the process decode backend: a module-level factory and a
            # compacted slice a chunk (picklable)
            col = batch.column(in_col)

            def spec(start: int, length: int) -> tuple:
                chunk = pa.concat_arrays([col.slice(start, length)])
                return ingest.decode_array_chunk, (chunk, shape)

            return spec

        on_error = self.getOnError()
        scorer = StreamScorer(runner, self.getOutputCol(), make_decoder,
                              arrayColumnToArrow, emptyVectorColumn,
                              chunk_rows=batch_size, on_error=on_error,
                              decoder_spec=decoder_spec)
        self._quarantine_sink = scorer.sink
        return dataset.mapStream(scorer,
                                 changes_length=on_error == "quarantine")

    _pickled_params = ("fn",)


class KerasTransformer(BundlesModelFile, XlaTransformer):
    """Applies a saved Keras model (Keras 3 on its torch backend) to a
    numeric array column — the reference's KerasTransformer (single
    input/output tensor contract), on ``device`` (unset → the card).
    save() bundles the model file with the stage (BundlesModelFile)."""

    modelFile = Param(Params, "modelFile",
                      "path to a saved Keras model (.keras/.h5)",
                      TypeConverters.toString)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, modelFile=None,
                 inputShape=None, batchSize=None, device=None):
        super(XlaTransformer, self).__init__()
        self._setDefault(batchSize=64, onError="raise")
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol=None, outputCol=None, modelFile=None,
                  inputShape=None, batchSize=None, device=None):
        return self._set(**self._input_kwargs)

    def _make_fn(self):
        return keras_file_to_fn(self.getOrDefault(self.modelFile),
                                device=self.getDevice())

    def _runner_key(self) -> tuple:
        return (self.getBatchSize(), self.getOrDefault(self.modelFile),
                self.getDevice())

    _pickled_params = ()
