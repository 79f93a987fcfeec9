"""XlaImageTransformer — apply an arbitrary torch function to an image
column.

The port's ``sparkdl_tpu/transformers/xla_image.py``. The reference's
TFImageTransformer role: this transformer accepts an arbitrary **torch
callable** ``fn(batch)`` over NHWC float32 batches (a tensor on the
transformer's device) and runs it in one device step, fed by the streaming
scoring engine (``transformers/streaming.py``): parallel host decode →
pad/put → one continuous cross-partition device stream → overlap-worker
Arrow encode. The name is kept for the reference's API; there is no XLA.

The device step is the runner's: the input cast, the preprocess prologue
(:meth:`XlaImageTransformer._make_preprocess`) and ``fn``, on the
transformer's ``device`` (unset → the card; ``"cpu"`` must be asked for).
``numDevices`` other than 1 raises (ROADMAP.md, Queue A 8).
"""

from __future__ import annotations

import threading

import numpy as np

from ..core import ingest
from ..core.params import (HasBatchSize, HasDevice, HasInputCol,
                           HasOnError,
                           HasOutputCol, Param, Params, TypeConverters,
                           keyword_only)
from ..core.pipeline import Transformer
from ..core.runtime import BatchRunner
from ..image import imageIO
from .payloads import PicklesCallableParams
from .streaming import StreamScorer


def arrayColumnToArrow(result: np.ndarray) -> pa.Array:
    """N-d numpy → Arrow: 1-d as primitive array, N-d as list<primitive> rows.

    The nested case builds list<primitive> from the flat value buffer
    (zero-copy) instead of round-tripping through Python lists — the output
    column of a batch-scoring job can be hundreds of MB."""
    import pyarrow as pa
    if result.ndim == 1:
        return pa.array(result)
    flat = np.ascontiguousarray(result).reshape(len(result), -1)
    offsets64 = np.arange(len(flat) + 1, dtype=np.int64) * flat.shape[1]
    values = pa.array(flat.reshape(-1))
    if offsets64[-1] > np.iinfo(np.int32).max:
        # >2**31 total elements only fits large_list offsets.
        return pa.LargeListArray.from_arrays(pa.array(offsets64), values)
    return pa.ListArray.from_arrays(
        pa.array(offsets64.astype(np.int32)), values)


def emptyVectorColumn() -> pa.Array:
    import pyarrow as pa
    return pa.array([], type=pa.list_(pa.float32()))


class XlaImageTransformer(PicklesCallableParams, Transformer, HasInputCol,
                          HasOutputCol, HasBatchSize, HasOnError, HasDevice):
    """Applies ``fn`` (a torch callable, NHWC float32 tensor in, tensor out)
    to an image column.

    ``inputSize=(H, W)`` resizes every image to a static shape (one batch
    shape per runner; mixed-size columns are resized on the host feed
    path).
    ``onError='quarantine'`` dead-letters rows whose image payload fails
    to decode instead of killing the job (see README "Scoring failure
    semantics"; read them back via :meth:`deadLetters`).
    """

    fn = Param(Params, "fn", "torch callable applied to NHWC batches",
               TypeConverters.toCallable)
    inputSize = Param(Params, "inputSize", "static (H, W) every image is "
                      "resized to before entering the device step",
                      TypeConverters.toShape)
    channelOrder = Param(Params, "channelOrder",
                         "channel order fed to fn: RGB (default) or BGR",
                         TypeConverters.toString)
    outputMode = Param(Params, "outputMode",
                       "output column content: 'vector' (list<float>) or "
                       "'image' (uint8 image struct)", TypeConverters.toString)
    numDevices = Param(Params, "numDevices",
                       "devices to shard inference batches over: 1 "
                       "(default, the only value ported; others raise)",
                       TypeConverters.toInt)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, fn=None, inputSize=None,
                 batchSize=None, channelOrder=None, outputMode=None,
                 numDevices=None, onError=None, device=None):
        super().__init__()
        self._setDefault(batchSize=32, channelOrder="RGB", outputMode="vector",
                         inputCol="image", numDevices=1, onError="raise")
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol=None, outputCol=None, fn=None, inputSize=None,
                  batchSize=None, channelOrder=None, outputMode=None,
                  numDevices=None, onError=None, device=None):
        return self._set(**self._input_kwargs)

    def _make_fn(self):
        """Hook for subclasses that derive fn from other params."""
        return self.getOrDefault(self.fn)

    def _num_devices(self) -> int:
        # subclasses with their own __init__ may never have set the default
        return (self.getOrDefault(self.numDevices)
                if self.isSet("numDevices") or self.hasDefault("numDevices")
                else 1)

    def _runner_key(self) -> tuple:
        """Cache key for the runner; subclasses add model identity."""
        return (self.getBatchSize(), self._num_devices(), self.getDevice(),
                id(self._paramMap.get(self.fn)) if self.hasParam("fn") else 0)

    def _mesh(self):
        n = self._num_devices()
        if n != 1:
            raise NotImplementedError(
                f"numDevices={n}: sharding a scoring stream over several "
                "cards is not ported yet (ROADMAP.md, Queue A 8)")
        return None

    def _feed_key(self) -> tuple:
        """The feed-side configuration the compiled program depends on:
        fused mode changes the step's prologue, size/order change what it
        does — a runner compiled for one must not serve another."""
        size = (tuple(self.getOrDefault(self.inputSize))
                if self.isDefined(self.inputSize) else None)
        return (ingest.fused_preprocess_default(), size,
                self.getOrDefault(self.channelOrder).upper())

    def _make_preprocess(self):
        """Fused on-device preprocess prologue: with
        ``SPARKDL_FUSED_PREPROCESS`` on (default), the host ships
        storage-dtype **BGR** batches (zero-copy views at native size
        when the column layout allows — see ``imageIO.imageColumnFeed``)
        and the device step does the rest: cast (the runner's
        ``input_cast``), BGR→RGB flip, and :func:`runtime.resize_nhwc`
        (the counterpart of ``jax.image.resize``, bilinear) to the static input
        size when the wire size differs. Each distinct wire size is a new
        runner signature (a ``recompile`` event), and a wire size equal to
        the target skips the resize entirely (bit-identical to the
        host-resized feed).

        Fused mode requires a STATIC ``inputSize``: without one the target
        shape is pinned per partition at decode time, which this prologue
        cannot know — a native-size chunk would ship and never be resized.
        No ``inputSize`` → no prologue, and the feed stays on the legacy
        host pack path."""
        if not ingest.fused_preprocess_default() \
                or not self.isDefined(self.inputSize):
            return None
        size = self.getOrDefault(self.inputSize)
        h, w = int(size[0]), int(size[1])
        flip = self.getOrDefault(self.channelOrder).upper() == "RGB"
        import torch

        from ..core.runtime import resize_nhwc

        def prologue(x):
            if flip and x.shape[-1] >= 3:
                x = x.flip(-1) if x.shape[-1] == 3 else torch.cat(
                    [x[..., 2::-1], x[..., 3:]], dim=-1)
            if x.shape[1] != h or x.shape[2] != w:
                x = resize_nhwc(x, h, w)
            return x

        return prologue

    def _get_runner(self) -> BatchRunner:
        """One BatchRunner per param configuration.

        transform() is called repeatedly on the same stage (fit then
        transform, batch scoring jobs, ...); rebuilding the runner each
        time would lose its signature accounting and wire-shape budget.
        The runner is also the card's device step: ``.run(uint8 BGR
        batches)`` scores host batches without a DataFrame."""
        key = (self._runner_key(), self._feed_key())
        cached = getattr(self, "_runner_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        import torch
        # Host batches are fed as uint8 (4x fewer bytes over the
        # host→device link); the runner casts to f32 on the device.
        # ``fn`` still sees float32 NHWC (RGB when channelOrder says so —
        # in fused mode the prologue owns the flip and the resize; see
        # _make_preprocess).
        runner = BatchRunner(self._make_fn(), self.getBatchSize(),
                             mesh=self._mesh(), input_cast=torch.float32,
                             preprocess=self._make_preprocess(),
                             device=self.getDevice())
        self._runner_cache = (key, runner)
        return runner

    def _transform(self, dataset):
        import pyarrow as pa
        in_col = self.getInputCol()
        out_col = self.getOutputCol()
        size = (self.getOrDefault(self.inputSize)
                if self.isDefined(self.inputSize) else (None, None))
        order = self.getOrDefault(self.channelOrder)
        out_mode = self.getOrDefault(self.outputMode)
        batch_size = self.getBatchSize()
        runner = self._get_runner()

        # Fused feed only when the prologue exists to own flip/resize —
        # i.e. a static inputSize is defined (see _make_preprocess).
        fused = ingest.fused_preprocess_default() \
            and self.isDefined(self.inputSize)

        # Wire-shape budget: every distinct native size this stage ships
        # is one new signature of the device step, so a many-sized dataset
        # (per-directory dumps, size-sorted scans) must not re-plan
        # unboundedly where the host-pack feed planned once. Shared by the thread decoder
        # and the process spec (evaluated in the parent — pool children
        # are stateless); metadata-only, no pixel work. The budget lives
        # WITH the runner (one set per runner, like _runner_cache), not
        # per transform() call: the signatures it bounds are cumulative
        # across calls, so the budget must be too.
        if getattr(self, "_wire_budget_for", None) is not runner:
            self._wire_budget = set()
            self._wire_budget_lock = threading.Lock()
            self._wire_budget_for = runner
        wire_shapes = self._wire_budget
        wire_lock = self._wire_budget_lock
        max_wire = ingest.max_wire_shapes_default()

        def chunk_native_ok(chunk_col, length, h, w):
            """Wire-shape-budget verdict for one chunk: ``(native_ok,
            uniform_meta)`` — may the feed ship it zero-copy at its
            native size? A budget slot is consumed only for a chunk the
            view can ACTUALLY deliver (the view attempt below): metadata
            uniformity alone is not deliverability, and a slot burned for
            a chunk whose view then declines (truncated payloads, exotic
            storage) would strand that slot for the runner's lifetime on
            a shape that only ever packs."""
            if not fused or length <= 1:
                return True, None  # 1-row chunks pack (fallback parity)
            meta = imageIO.imageColumnUniformSize(chunk_col)
            if meta is None:
                return True, None  # not view-shippable; the feed packs
            mh, mw = meta[0], meta[1]
            if (mh, mw) == (h, w) or mh * mw > h * w:
                return True, meta  # target-shaped / packs anyway
            if imageIO.imageColumnNHWCView(chunk_col, uniform=meta) is None:
                return True, meta  # layout declines; the feed packs
            # Key on the FULL meta: the mode determines the view's
            # storage DTYPE, and each distinct (shape, dtype) signature
            # is its own device-step signature — (h, w, c) alone would let a
            # u8/f32 mix compile 2x the budgeted programs.
            with wire_lock:
                if meta in wire_shapes:
                    return True, meta
                if len(wire_shapes) < max_wire:
                    wire_shapes.add(meta)
                    return True, meta
                return False, meta

        def chunk_verdicts(col, num_rows, h, w) -> dict:
            """native_ok per chunk start, evaluated HERE on the consumer
            thread in stream order BEFORE any chunk decodes: pool workers
            racing for the last budget slots would make native-vs-pack
            assignment — and therefore the resize path and output bits —
            depend on thread timing, and diverge between the thread and
            process backends. Mirrors StreamScorer's chunking
            (``chunk_rows=batch_size`` below); decode falls back to the
            pack path for any unaligned start (the quarantine
            row-fallback's 1-row decodes pack regardless)."""
            if not fused:
                return {}
            out = {}
            for s in range(0, num_rows, batch_size):
                length = min(batch_size, num_rows - s)
                out[s] = chunk_native_ok(col.slice(s, length), length, h, w)
            return out

        def feed_params(col: pa.Array) -> tuple:
            h, w = size
            if h is None or w is None:
                # No static inputSize: pin the partition-wide target shape
                # from row 0 BEFORE chunking, or mixed-size partitions would
                # produce per-chunk shapes (and recompiles/concat failures).
                h = int(col.field("height")[0].as_py()) if h is None else h
                w = int(col.field("width")[0].as_py()) if w is None else w
            # uint8 feed (the runner casts on-device — 4x fewer bytes over
            # the host→device link) when every row stores uint8 pixels;
            # float-mode (CV_32F*) columns keep a float32 feed, which the
            # runner's on-device cast to f32 passes through untouched.
            modes = col.field("mode").to_numpy(zero_copy_only=False)
            feed_dtype = (np.uint8 if all(
                imageIO.ocvTypeByMode(int(m)).dtype == "uint8"
                for m in np.unique(modes)) else np.float32)
            return h, w, feed_dtype

        def make_decoder(batch: pa.RecordBatch):
            # One Arrow partition may exceed the device batch: decode AND
            # run per device-chunk, so peak host memory is O(batchSize)
            # decoded pixels, not O(partition).
            # Each chunk decode runs on the parallel decode pool
            # (SPARKDL_DECODE_WORKERS) while earlier chunks execute; the
            # quarantine fallback calls the same decoder per row. In fused
            # mode imageColumnFeed ships the cheapest batch the
            # policy allows (zero-copy native-size storage-dtype views
            # when the layout permits) and the runner's prologue does
            # flip/cast/resize on device.
            col = batch.column(in_col)
            h, w, feed_dtype = feed_params(col)
            native = chunk_verdicts(col, batch.num_rows, h, w)

            def decode(start: int, length: int) -> np.ndarray:
                ok, uniform = native.get(start, (False, None))
                return imageIO.imageColumnFeed(
                    col.slice(start, length), h, w, channelOrder=order,
                    dtype=feed_dtype, fused=fused, native_ok=ok,
                    uniform=uniform)

            return decode

        def decoder_spec(batch: pa.RecordBatch):
            # Process-backend eligibility (SPARKDL_DECODE_BACKEND=process):
            # per-chunk picklable tasks — the module-level factory plus a
            # COMPACTED Arrow slice (concat_arrays truncates the buffers;
            # a bare slice would pickle the whole partition per chunk).
            col = batch.column(in_col)
            h, w, feed_dtype = feed_params(col)
            dtype_name = np.dtype(feed_dtype).name
            native = chunk_verdicts(col, batch.num_rows, h, w)

            def spec(start: int, length: int) -> tuple:
                # the pool child re-derives the (cheap) uniform scan from
                # the compacted chunk; only the budget VERDICT — parent
                # state — ships in the payload
                chunk = pa.concat_arrays([col.slice(start, length)])
                return ingest.decode_image_chunk, \
                    (chunk, h, w, order, dtype_name, fused,
                     native.get(start, (False, None))[0])

            return spec

        # Each device chunk converts to its FINAL Arrow representation on
        # the scorer's overlap worker as it lands — the float32 model
        # output for a whole partition never materializes on the host, and
        # the device feed never waits on the conversion.
        if out_mode == "image":
            def encode(result: np.ndarray) -> pa.Array:
                structs = imageIO.nhwcToStructs(
                    np.clip(result, 0, 255).astype(np.uint8),
                    channelOrder=order)
                return pa.array(structs, type=imageIO.imageSchema)

            def empty_array() -> pa.Array:
                return pa.array([], type=imageIO.imageSchema)
        else:
            encode = arrayColumnToArrow
            empty_array = emptyVectorColumn

        on_error = self.getOnError()
        scorer = StreamScorer(runner, out_col, make_decoder, encode,
                              empty_array, chunk_rows=batch_size,
                              on_error=on_error, decoder_spec=decoder_spec)
        # Dead letters of the most recent materialized transform, read
        # back through HasOnError.deadLetters() after collect().
        self._quarantine_sink = scorer.sink
        return dataset.mapStream(scorer,
                                 changes_length=on_error == "quarantine")

    _pickled_params = ("fn",)
