"""KerasImageFileTransformer — URI column → loaded image → Keras model output.

The counterpart of ``sparkdl_tpu/transformers/keras_image.py``.
Reference: ``python/sparkdl/transformers/keras_image.py``: a DataFrame
column of image URIs is loaded/preprocessed by a user function and pushed
through a saved Keras model. Loading happens batched on the host while
the previous batch computes on the device (the BatchRunner prefetch
overlap); the model runs on Keras's torch backend
(``keras_utils``), on the stage's ``device`` (unset → the card;
``"cpu"`` must be asked for).

pyarrow is imported inside the functions that read a DataFrame, keras
inside the ones that load a model, so this module imports without either.
"""

from __future__ import annotations

import numpy as np

from ..core.params import (HasBatchSize, HasDevice, HasInputCol, HasOnError,
                           HasOutputCol, Param, Params, TypeConverters,
                           keyword_only)
from ..core.pipeline import Transformer
from ..core.runtime import BatchRunner
from .keras_utils import keras_file_to_fn
from .payloads import BundlesModelFile, PicklesCallableParams


def defaultImageLoader(size: tuple[int, int]):
    """uri → float32 HWC RGB array resized to ``size`` (no model preprocess)."""
    def load(uri: str) -> np.ndarray:
        from PIL import Image
        img = Image.open(uri).convert("RGB").resize((size[1], size[0]),
                                                    Image.BILINEAR)
        return np.asarray(img, dtype=np.float32)

    return load


def loadImageBatch(loader, uris, workers: int = 0) -> np.ndarray:
    """Decode a URI batch through a thread pool → one stacked NHWC array.

    PIL decode/resize releases the GIL, so a pool of threads keeps every
    host core decoding. ``workers=0`` (auto) rides the process-wide shared
    decode executor (``image.imageIO._decode_pool`` — no per-batch thread
    churn); an explicit N gets a dedicated N-thread pool for this batch
    (for loaders only N-thread-safe)."""
    uris = list(uris)
    if len(uris) <= 1 or workers == 1:
        return np.stack([loader(u) for u in uris])
    if workers <= 0:
        from ..image.imageIO import _decode_pool
        return np.stack(list(_decode_pool().map(loader, uris)))
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return np.stack(list(pool.map(loader, uris)))


class KerasImageFileTransformer(BundlesModelFile, PicklesCallableParams,
                                Transformer, HasInputCol, HasOutputCol,
                                HasBatchSize, HasOnError, HasDevice):
    """Loads images from a URI column via ``imageLoader`` and applies a saved
    Keras model (``modelFile``, Keras 3 on its torch backend) in one device
    step a batch. save() bundles the model file with the stage
    (BundlesModelFile), so fitted transformers persist durably.
    ``onError='quarantine'`` dead-letters rows whose URI fails to
    load/decode (missing file, truncated image) instead of killing the
    scoring job. ``device``: unset → the card; ``"cpu"`` must be asked
    for."""

    modelFile = Param(Params, "modelFile", "path to a saved Keras model "
                      "(.keras/.h5)", TypeConverters.toString)
    imageLoader = Param(Params, "imageLoader",
                        "callable uri -> float32 HWC array (loads AND "
                        "preprocesses, like the reference's loadImagesInternal)",
                        TypeConverters.toCallable)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, modelFile=None,
                 imageLoader=None, batchSize=None, onError=None,
                 device=None):
        super().__init__()
        self._setDefault(batchSize=32, onError="raise")
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol=None, outputCol=None, modelFile=None,
                  imageLoader=None, batchSize=None, onError=None,
                  device=None):
        return self._set(**self._input_kwargs)

    def _make_fn(self):
        return keras_file_to_fn(self.getOrDefault(self.modelFile),
                                device=self.getDevice())

    def _get_runner(self) -> BatchRunner:
        """One BatchRunner per (batch size, model file, device): the
        device step, which ``.run(host float32 batches)`` drives without
        a DataFrame."""
        key = (self.getBatchSize(), self.getOrDefault(self.modelFile),
               self.getDevice())
        cached = getattr(self, "_runner_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        runner = BatchRunner(self._make_fn(), self.getBatchSize(),
                             device=self.getDevice())
        self._runner_cache = (key, runner)
        return runner

    def _transform(self, dataset):
        from .streaming import StreamScorer
        from .xla_image import arrayColumnToArrow, emptyVectorColumn
        in_col = self.getInputCol()
        out_col = self.getOutputCol()
        batch_size = self.getBatchSize()
        loader = self.getOrDefault(self.imageLoader)
        runner = self._get_runner()

        def make_decoder(batch):
            uris = batch.column(in_col).to_pylist()

            # Load lazily per device chunk: each decode fans its URI batch
            # over the shared decode executor (loadImageBatch) AND the
            # chunks themselves pipeline on the scorer's decode pool —
            # chunk k+1 loads while the device computes chunk k, across
            # partition boundaries. Peak host memory is one chunk x the
            # in-flight window, not the whole partition. The quarantine
            # fallback calls the same decoder per row (length=1), so a bad
            # URI dead-letters just its own row.
            def decode(start: int, length: int) -> np.ndarray:
                return loadImageBatch(loader, uris[start:start + length])

            return decode

        on_error = self.getOnError()
        scorer = StreamScorer(runner, out_col, make_decoder,
                              arrayColumnToArrow, emptyVectorColumn,
                              chunk_rows=batch_size, on_error=on_error)
        self._quarantine_sink = scorer.sink
        return dataset.mapStream(scorer,
                                 changes_length=on_error == "quarantine")

    _pickled_params = ("imageLoader",)
