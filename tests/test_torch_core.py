"""The port's core layer against its reference: twins of
``tests/test_params.py`` (the Params contract), ``tests/test_pipeline.py``
(Transformer / Estimator / Pipeline and persistence), the feed and decode
half of ``tests/test_ingest.py`` (zero-copy NHWC views, the fused feed
policy, the chunk-decode protocol) and
``tests/test_failures.py``'s classification, over
``sparkdl_tpu_torch.core`` and ``sparkdl_tpu_torch.runner.failures``.
The bodies are the reference's; the CUDA error texts the port adds are
classified at the end. Framework-free apart from the DataFrame's pyarrow.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import numpy as np
import pyarrow as pa
import pytest

from sparkdl_tpu_torch.core import ingest
from sparkdl_tpu_torch.core.frame import DataFrame
from sparkdl_tpu_torch.core.params import (HasBatchSize, HasInputCol,
                                           HasOutputCol, Param, Params,
                                           TypeConverters, keyword_only)
from sparkdl_tpu_torch.core.pipeline import (Estimator, MLWritable, Model,
                                             Pipeline, PipelineModel,
                                             Transformer)
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.runner.failures import (TrainingDivergedError,
                                               classify_exception,
                                               classify_text, is_retryable)


# --- the Params contract (tests/test_params.py) ----------------------------

class Stage(HasInputCol, HasOutputCol, HasBatchSize):
    threshold = Param(Params, "threshold", "a float knob", TypeConverters.toFloat)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, batchSize=None,
                 threshold=None):
        super().__init__()
        self._setDefault(batchSize=32, threshold=0.5)
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol=None, outputCol=None, batchSize=None,
                  threshold=None):
        return self._set(**self._input_kwargs)


def test_defaults_and_set():
    s = Stage(inputCol="image")
    assert s.getInputCol() == "image"
    assert s.getBatchSize() == 32
    assert s.getOrDefault("threshold") == 0.5
    s.setParams(threshold=0.9, outputCol="features")
    assert s.getOrDefault(s.threshold) == 0.9
    assert s.getOutputCol() == "features"
    assert s.isSet(s.threshold) and not s.isSet(s.batchSize)
    assert s.isDefined(s.batchSize) and s.hasDefault("batchSize")


def test_type_converters_validate_eagerly():
    s = Stage()
    s.set("threshold", 1)  # int → float coercion
    assert isinstance(s.getOrDefault("threshold"), float)
    with pytest.raises(TypeError):
        s.set("threshold", "hot")
    with pytest.raises(TypeError):
        s.set("batchSize", 3.5)
    with pytest.raises(TypeError):
        TypeConverters.toShape([4, -1])
    assert TypeConverters.toShape([4, 224, 224, 3]) == (4, 224, 224, 3)
    with pytest.raises(TypeError):
        TypeConverters.toInt(True)


def test_keyword_only_rejects_positional():
    with pytest.raises(TypeError):
        Stage("image")


def test_copy_preserves_uid_and_isolates_maps():
    s = Stage(inputCol="a", threshold=0.7)
    c = s.copy({s.threshold: 0.1})
    assert c.uid == s.uid
    assert c.getOrDefault("threshold") == 0.1
    assert s.getOrDefault("threshold") == 0.7
    c.set("inputCol", "b")
    assert s.getInputCol() == "a"


def test_params_listing_and_explain():
    s = Stage(inputCol="x")
    names = [p.name for p in s.params]
    assert names == sorted(names)
    assert {"inputCol", "outputCol", "batchSize", "threshold"} <= set(names)
    text = s.explainParams()
    assert "threshold" in text and "default: 0.5" in text
    assert "current: x" in s.explainParam("inputCol")


def test_extract_param_map_with_extra():
    s = Stage(inputCol="a")
    m = s.extractParamMap({s.threshold: 0.3})
    assert m[s.threshold] == 0.3
    assert m[s.inputCol] == "a"
    assert m[s.batchSize] == 32


def test_foreign_param_rejected():
    s1, s2 = Stage(), Stage()
    with pytest.raises(ValueError):
        s1.set(s2.threshold, 0.2)


def test_param_uids_unique():
    assert Stage().uid != Stage().uid

# --- Transformer / Estimator / Pipeline (tests/test_pipeline.py) --------

class AddConst(Transformer, HasInputCol, HasOutputCol):
    amount = Param(Params, "amount", "value to add", TypeConverters.toFloat)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, amount=None):
        super().__init__()
        self._setDefault(amount=1.0)
        self._set(**self._input_kwargs)

    def _transform(self, dataset):
        a = self.getOrDefault(self.amount)
        return dataset.withColumnBatch(
            self.getOutputCol(), lambda x: np.asarray(x, dtype=np.float64) + a,
            inputCols=[self.getInputCol()])


class MeanModel(Model, HasInputCol, HasOutputCol):
    def __init__(self, mean=0.0, inputCol=None, outputCol=None):
        super().__init__()
        self.mean = mean
        self._set(inputCol=inputCol, outputCol=outputCol)

    def _transform(self, dataset):
        return dataset.withColumnBatch(
            self.getOutputCol(),
            lambda x: np.asarray(x, dtype=np.float64) - self.mean,
            inputCols=[self.getInputCol()])

    def _save_payload(self, path):
        import json, os
        with open(os.path.join(path, "payload.json"), "w") as f:
            json.dump({"mean": self.mean}, f)

    def _load_payload(self, path, meta):
        import json, os
        with open(os.path.join(path, "payload.json")) as f:
            self.mean = json.load(f)["mean"]


class Center(Estimator, HasInputCol, HasOutputCol):
    @keyword_only
    def __init__(self, inputCol=None, outputCol=None):
        super().__init__()
        self._set(**self._input_kwargs)

    def _fit(self, dataset):
        vals = np.asarray([r[self.getInputCol()] for r in dataset.collect()])
        return MeanModel(float(vals.mean()), self.getInputCol(),
                         self.getOutputCol())


def data():
    return DataFrame.fromPydict({"v": [1.0, 2.0, 3.0, 4.0]}, numPartitions=2)


def test_transform_with_param_override():
    t = AddConst(inputCol="v", outputCol="o", amount=2.0)
    out = t.transform(data())
    assert [r.o for r in out.collect()] == [3.0, 4.0, 5.0, 6.0]
    out2 = t.transform(data(), {t.amount: 10.0})
    assert [r.o for r in out2.collect()] == [11.0, 12.0, 13.0, 14.0]
    assert t.getOrDefault("amount") == 2.0  # original untouched


def test_estimator_fit_and_fit_multiple():
    est = Center(inputCol="v", outputCol="c")
    model = est.fit(data())
    assert model.mean == 2.5
    out = model.transform(data())
    assert [r.c for r in out.collect()] == [-1.5, -0.5, 0.5, 1.5]

    t = AddConst(inputCol="v", outputCol="o")
    maps = [{t.amount: 1.0}, {t.amount: 2.0}]

    class AmountEst(Estimator):
        def __init__(self):
            super().__init__()
            self.amount = Param(self, "amount", "", TypeConverters.toFloat)
            self._setDefault(amount=0.0)

        def _fit(self, dataset):
            return MeanModel(self.getOrDefault("amount"), "v", "o")

    e = AmountEst()
    results = dict(e.fitMultiple(data(), [{e.amount: 5.0}, {e.amount: 7.0}]))
    assert results[0].mean == 5.0 and results[1].mean == 7.0
    models = e.fit(data(), [{e.amount: 1.0}, {e.amount: 2.0}])
    assert sorted(m.mean for m in models) == [1.0, 2.0]


def test_pipeline_fit_transform():
    pipe = Pipeline(stages=[
        AddConst(inputCol="v", outputCol="a", amount=1.0),
        Center(inputCol="a", outputCol="c"),
    ])
    pm = pipe.fit(data())
    assert isinstance(pm, PipelineModel)
    out = pm.transform(data())
    assert [r.c for r in out.collect()] == [-1.5, -0.5, 0.5, 1.5]


def test_pipeline_model_persistence(tmp_path):
    pipe = Pipeline(stages=[
        AddConst(inputCol="v", outputCol="a", amount=1.0),
        Center(inputCol="a", outputCol="c"),
    ])
    pm = pipe.fit(data())
    p = str(tmp_path / "pm")
    pm.save(p)
    loaded = MLWritable.load(p)
    assert isinstance(loaded, PipelineModel)
    out = loaded.transform(data())
    assert [r.c for r in out.collect()] == [-1.5, -0.5, 0.5, 1.5]
    assert loaded.uid == pm.uid
    assert loaded.stages[1].mean == 3.5


def test_transformer_persistence_roundtrip(tmp_path):
    t = AddConst(inputCol="v", outputCol="o", amount=4.0)
    p = str(tmp_path / "t")
    t.save(p)
    loaded = MLWritable.load(p)
    assert loaded.getOrDefault("amount") == 4.0
    assert loaded.getInputCol() == "v"
    out = loaded.transform(data())
    assert [r.o for r in out.collect()] == [5.0, 6.0, 7.0, 8.0]


def test_pipeline_estimator_persistence(tmp_path):
    pipe = Pipeline(stages=[AddConst(inputCol="v", outputCol="a", amount=1.0)])
    p = str(tmp_path / "pipe")
    pipe.save(p)
    loaded = MLWritable.load(p)
    assert isinstance(loaded, Pipeline)
    assert len(loaded.getStages()) == 1
    pm = loaded.fit(data())
    assert [r.a for r in pm.transform(data()).collect()] == [2.0, 3.0, 4.0, 5.0]


def test_fit_empty_param_maps():
    class E(Estimator):
        def _fit(self, dataset):
            return 1

    assert E().fit(data(), []) == []


def test_abstract_stages_not_instantiable():
    import pytest
    with pytest.raises(TypeError):
        Transformer()
    with pytest.raises(TypeError):
        Estimator()


class WithFn(Transformer, HasInputCol):
    fn = Param(Params, "fn", "a callable", TypeConverters.toCallable)

    def _transform(self, dataset):
        return dataset


def test_load_fails_loudly_on_unrestored_payload_params(tmp_path):
    import pytest

    t = WithFn()
    t._set(fn=lambda x: x)
    p = str(tmp_path / "fn")
    t.save(p)
    with pytest.raises(ValueError, match="fn"):
        MLWritable.load(p)


def test_pipeline_propagates_stage_params():
    # Spark contract: fit(df, params={stage.param: v}) reaches the stage.
    add = AddConst(inputCol="v", outputCol="a", amount=1.0)
    pipe = Pipeline(stages=[add])
    pm = pipe.fit(data(), params={add.amount: 10.0})
    assert [r.a for r in pm.transform(data()).collect()] == \
        [11.0, 12.0, 13.0, 14.0]
    assert add.getOrDefault("amount") == 1.0  # original untouched

    # PipelineModel.transform(df, params={stage.param: v}) too
    pm2 = Pipeline(stages=[add]).fit(data())
    out = pm2.transform(data(), params={add.amount: 5.0})
    assert [r.a for r in out.collect()] == [6.0, 7.0, 8.0, 9.0]


def test_copy_ignores_foreign_params():
    a, b = AddConst(), AddConst()
    c = a.copy({b.amount: 9.0})  # foreign param silently ignored (Spark)
    assert not c.isSet(c.amount)

# --- host ingest: views, feed policy, staging, chunk decode ------------

def image_column(n=6, h=4, w=5, seed=0):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(n)]
    structs = [imageIO.imageArrayToStruct(im, origin=f"m{i}")
               for i, im in enumerate(imgs)]
    return pa.array(structs, type=imageIO.imageSchema), imgs


# ---------------------------------------------------------------------------
# imageColumnNHWCView — the zero-copy fast path
# ---------------------------------------------------------------------------

def test_nhwc_view_matches_packed_and_is_zero_copy():
    col, _ = image_column()
    view = imageIO.imageColumnNHWCView(col)
    assert view is not None and view.dtype == np.uint8
    # at-rest layout is BGR: the packed BGR batch is the ground truth
    packed = imageIO.imageColumnToNHWC(col, 4, 5, dtype=np.uint8,
                                       channelOrder="BGR")
    np.testing.assert_array_equal(view, packed)
    # genuinely a view: read-only, aliasing the Arrow values buffer
    assert not view.flags.writeable
    assert view.base is not None


def test_nhwc_view_respects_slices():
    col, _ = image_column(n=8)
    full = imageIO.imageColumnNHWCView(col)
    part = imageIO.imageColumnNHWCView(col.slice(3, 4))
    np.testing.assert_array_equal(part, full[3:7])


def test_nhwc_view_declines_nonuniform_columns():
    rng = np.random.default_rng(1)
    structs = [imageIO.imageArrayToStruct(
        rng.integers(0, 256, (h, 4, 3), np.uint8)) for h in (4, 4, 6)]
    col = pa.array(structs, type=imageIO.imageSchema)
    assert imageIO.imageColumnNHWCView(col) is None      # mixed heights
    col2, _ = image_column(n=3)
    with_null = pa.concat_arrays(
        [col2, pa.array([None], type=imageIO.imageSchema)])
    assert imageIO.imageColumnNHWCView(with_null) is None  # null row


# ---------------------------------------------------------------------------
# imageColumnFeed — the fused feed policy
# ---------------------------------------------------------------------------

def test_feed_fused_ships_native_u8_view_when_upscaling():
    col, _ = image_column(h=4, w=5)
    out = imageIO.imageColumnFeed(col, 8, 8, fused=True)
    assert out.dtype == np.uint8 and out.shape == (6, 4, 5, 3)
    np.testing.assert_array_equal(out, imageIO.imageColumnNHWCView(col))


def test_feed_fused_packs_when_stored_exceeds_target():
    # downsampling on device would INFLATE wire bytes — pack at target,
    # still BGR (the device prologue owns the flip in fused mode)
    col, _ = image_column(h=8, w=8)
    out = imageIO.imageColumnFeed(col, 4, 4, dtype=np.float32, fused=True)
    assert out.dtype == np.float32 and out.shape == (6, 4, 4, 3)
    np.testing.assert_array_equal(
        out, imageIO.imageColumnToNHWC(col, 4, 4, dtype=np.float32,
                                       channelOrder="BGR"))


def test_feed_legacy_path_packs_on_host():
    col, _ = image_column(h=4, w=5)
    out = imageIO.imageColumnFeed(col, 8, 8, dtype=np.float32,
                                  channelOrder="RGB", fused=False)
    np.testing.assert_array_equal(
        out, imageIO.imageColumnToNHWC(col, 8, 8, dtype=np.float32,
                                       channelOrder="RGB"))


def test_fused_preprocess_env_gate(monkeypatch):
    assert ingest.fused_preprocess_default() is True
    monkeypatch.setenv("SPARKDL_FUSED_PREPROCESS", "0")
    assert ingest.fused_preprocess_default() is False


# ---------------------------------------------------------------------------
# decode_chunk — the ONE copy of chunk-then-row-fallback semantics
# ---------------------------------------------------------------------------

def _flaky_decoder(bad):
    def decode(start, length):
        rows = range(start, start + length)
        if any(r in bad for r in rows):
            raise ValueError(f"bad row in {list(rows)}")
        return np.full((length, 2), float(start), np.float32)
    return decode


def test_decode_chunk_clean_and_raise_modes():
    arr, info = ingest.decode_chunk(_flaky_decoder(set()), 0, 4, True)
    assert arr.shape == (4, 2) and info == {"length": 4, "dead": []}
    with pytest.raises(ValueError):
        ingest.decode_chunk(_flaky_decoder({1}), 0, 4, False)


def test_decode_chunk_row_fallback_dead_letters():
    arr, info = ingest.decode_chunk(_flaky_decoder({1, 3}), 0, 4, True)
    assert arr.shape == (2, 2)
    assert [d[0] for d in info["dead"]] == [1, 3]
    assert all(d[1] == "ValueError" for d in info["dead"])


def test_decode_backend_env_resolution(monkeypatch):
    monkeypatch.delenv("SPARKDL_DECODE_BACKEND", raising=False)
    assert ingest.decode_backend_default() == "thread"
    monkeypatch.setenv("SPARKDL_DECODE_BACKEND", "process")
    assert ingest.decode_backend_default() == "process"
    monkeypatch.setenv("SPARKDL_DECODE_BACKEND", "bogus")
    assert ingest.decode_backend_default() == "thread"

# --- failure classification (tests/test_failures.py) --------------------

class TestClassify:
    @pytest.mark.parametrize("exc", [
        ValueError("bad shape"),
        TypeError("not a pytree"),
        KeyError("missing"),
        AssertionError("nope"),
        RuntimeError("INVALID_ARGUMENT: mismatched dims"),
        RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),
    ])
    def test_fatal(self, exc):
        assert classify_exception(exc) == "fatal"
        assert not is_retryable(exc)

    @pytest.mark.parametrize("exc", [
        RuntimeError("UNAVAILABLE: TPU backend setup/compile error"),
        RuntimeError("DEADLINE_EXCEEDED: collective timed out"),
        RuntimeError("ABORTED: coordination service lost worker 3"),
        ConnectionError("failed to connect to coordinator"),
        TimeoutError("rendezvous"),
        OSError("socket closed"),
        RuntimeError("slice 0 unhealthy: preempted"),
        RuntimeError("some unrecognized runtime condition"),
    ])
    def test_retryable(self, exc):
        assert classify_exception(exc) == "retryable"
        assert is_retryable(exc)

    def test_keyboard_interrupt_fatal(self):
        assert classify_exception(KeyboardInterrupt()) == "fatal"

    def test_training_diverged_fatal(self):
        e = TrainingDivergedError(17, float("nan"))
        assert classify_exception(e) == "fatal"
        assert e.step == 17
        assert "step 17" in str(e)


# Realistic runtime / gRPC message strings pinning the retryable/fatal
# POLICY: a regex edit that silently flips any of these rows is a
# restart-budget bug, not a refactor. The texts are those the reference's
# table carries (runtime errors, coordination-service and gRPC transport
# errors); the port classifies text the same way.
_REALISTIC = [
    ("UNAVAILABLE: failed to connect to all addresses; last error: "
     "UNKNOWN: ipv4:10.130.0.31:8476: Failed to connect to remote host: "
     "Connection refused", "retryable"),
    ("UNAVAILABLE: Socket closed", "retryable"),
    ("DEADLINE_EXCEEDED: Barrier timed out. Barrier_id: "
     "PjRT_Client_Connect. Timed out task names: "
     "/job:jax_worker/replica:0/task:3", "retryable"),
    ("ABORTED: The task /job:jax_worker/replica:0/task:1 is not "
     "registered with the coordination service", "retryable"),
    ("Coordination service agent is in ERROR: Heartbeat timeout from "
     "task /job:jax_worker/replica:0/task:1", "retryable"),
    ("UNAVAILABLE: SliceHealthCheck: slice 0 unhealthy: worker was "
     "preempted by a higher-priority job", "retryable"),
    ("INTERNAL: TPU backend setup failed: device or resource busy",
     "retryable"),
    ("RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
     "17179869184 bytes", "fatal"),
    ("INVALID_ARGUMENT: Executable expected parameter 0 of shape "
     "f32[8,128] but got f32[8,64]", "fatal"),
    ("FAILED_PRECONDITION: BatchNorm running stats not initialized",
     "fatal"),
    ("UNIMPLEMENTED: dynamic-slice op lowering not supported on this "
     "backend", "fatal"),
]


class TestRealisticMessages:
    """Table-driven policy pins over both classification entry points."""

    @pytest.mark.parametrize("msg,expected", _REALISTIC,
                             ids=[m[:32] for m, _ in _REALISTIC])
    def test_classify_exception_policy(self, msg, expected):
        # XlaRuntimeError is not importable without jaxlib internals;
        # classification goes by message text for RuntimeError-shaped
        # errors, which is exactly how the real one is handled.
        assert classify_exception(RuntimeError(msg)) == expected

    @pytest.mark.parametrize("msg,expected", _REALISTIC,
                             ids=[m[:32] for m, _ in _REALISTIC])
    def test_classify_text_policy(self, msg, expected):
        assert classify_text(
            f"Traceback (most recent call last):\n ...\n"
            f"jaxlib.xla_extension.XlaRuntimeError: {msg}") == expected

    def test_plain_python_errors_fatal_in_both(self):
        assert classify_exception(ValueError("bad operand")) == "fatal"
        assert classify_text("Traceback (most recent call last):\n"
                             "  File \"train.py\", line 3, in <module>\n"
                             "ValueError: bad operand") == "fatal"

    def test_text_fatal_wins_over_teardown_noise(self):
        """A run that died on a program error spews incidental CANCELLED/
        coordination lines during teardown — fatal evidence (status codes
        AND Python traceback names) must win over the noise, or supervise
        relaunches a deterministic user bug until the budget is gone."""
        noisy = ("E0801 coordination_service_agent.cc CANCELLED: "
                 "Cancelled by orchestrator\n"
                 "jaxlib.xla_extension.XlaRuntimeError: INVALID_ARGUMENT: "
                 "shape mismatch")
        assert classify_text(noisy) == "fatal"
        py_noisy = ("E0801 coordination_service_agent.cc CANCELLED: "
                    "Cancelled by orchestrator\n"
                    "Traceback (most recent call last):\n"
                    "  File \"train.py\", line 3, in <module>\n"
                    "ValueError: operands could not be broadcast")
        assert classify_text(py_noisy) == "fatal"

    def test_text_unknown_defaults_retryable(self):
        assert classify_text("worker killed by signal 9") == "retryable"
        assert classify_text("") == "retryable"

# --- the CUDA texts the port adds -------------------------------------------

_CUDA_FATAL = [
    "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.10 GiB "
    "total capacity; 77.20 GiB already allocated)",
    "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 512 MiB",
    "CUDA error: an illegal memory access was encountered\nCUDA kernel "
    "errors might be asynchronously reported at some other API call",
]


@pytest.mark.parametrize("msg", _CUDA_FATAL, ids=["oom", "oom-type",
                                                   "illegal-access"])
def test_cuda_device_faults_are_fatal(msg):
    assert classify_exception(RuntimeError(msg)) == "fatal"
    assert not is_retryable(RuntimeError(msg))
    assert classify_text(f"Traceback (most recent call last):\n ...\n"
                         f"RuntimeError: {msg}") == "fatal"


def test_cuda_oom_exception_type_is_fatal():
    import torch
    exc = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 20.00 MiB")
    assert classify_exception(exc) == "fatal"


# --- what a dead peer leaves in a survivor under torch.distributed ----------

_DIST_RETRYABLE = [
    "[rank0]:[E1018 00:19:22.000000000 ProcessGroupNCCL.cpp:632] [Rank 0] "
    "Watchdog caught collective operation timeout: WorkNCCL(SeqNum=7, "
    "OpType=ALLREDUCE, NumelIn=25557032, NumelOut=25557032, "
    "Timeout(ms)=600000) ran for 600018 milliseconds before timing out.",
    "torch.distributed.DistBackendError: NCCL communicator was aborted on "
    "rank 0.",
    "torch.distributed.DistNetworkError: failed to recv, got 0 bytes",
    "torch.distributed.DistStoreError: Timed out after 901 seconds waiting "
    "for clients. 1/2 clients joined.",
    "RuntimeError: [../third_party/gloo/gloo/transport/tcp/pair.cc:534] "
    "Connection closed by peer [127.0.0.1]:61745",
    "RuntimeError: [../third_party/gloo/gloo/transport/tcp/pair.cc:598] "
    "Connection reset by peer",
]


@pytest.mark.parametrize("msg", _DIST_RETRYABLE,
                         ids=["nccl-watchdog", "nccl-aborted",
                              "dist-network", "dist-store", "gloo-closed",
                              "gloo-reset"])
def test_dead_peer_texts_are_retryable(msg):
    """A survivor's stderr after its peer died restarts the gang, as text
    and as an exception (whose type name is the torch.distributed one)."""
    assert classify_text("Traceback (most recent call last):\n ...\n"
                         + msg) == "retryable"
    name, _, text = msg.rpartition(": ") if msg.startswith("torch.") \
        else ("", "", msg)
    exc_type = type(name.rsplit(".", 1)[-1] or "RuntimeError",
                    (RuntimeError,), {})
    assert classify_exception(exc_type(text)) == "retryable"


_DIST_FATAL_MIXES = [
    "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB"
    "\ntorch.distributed.DistBackendError: NCCL communicator was aborted on "
    "rank 0.",
    "CUDA error: an illegal memory access was encountered\n"
    "[Rank 0] Watchdog caught collective operation timeout: WorkNCCL("
    "SeqNum=3, OpType=ALLREDUCE) ran for 600012 milliseconds",
    "Traceback (most recent call last):\n  File \"train.py\", line 3\n"
    "ValueError: operands could not be broadcast\n[Rank 1] Watchdog caught "
    "collective operation timeout: WorkNCCL(SeqNum=3, OpType=ALLREDUCE)",
]


@pytest.mark.parametrize("text", _DIST_FATAL_MIXES,
                         ids=["oom-and-abort", "illegal-and-watchdog",
                              "valueerror-and-watchdog"])
def test_fatal_evidence_wins_over_dead_peer_texts(text):
    """Fatal first: a program error beside a dead peer's noise stays
    fatal, or the supervisor would relaunch a deterministic bug."""
    assert classify_text(text) == "fatal"


def test_torch_dist_store_error_type_is_retryable():
    import torch.distributed as dist
    exc = dist.DistStoreError("Timed out after 901 seconds waiting for "
                              "clients. 1/2 clients joined.")
    assert classify_exception(exc) == "retryable"


# --- stack traces around a run (tests/test_failures.py) --------------------

def test_diagnose_context_runs(tmp_path, monkeypatch):
    """Twin of tests/test_failures.py's ``test_diagnose_context_runs``,
    which also reads what it wrote: armed, the context emits ``diagnose``
    with its file under the event directory, and after an interval of 1 s
    the file holds this thread's stack; on exit the timer is cancelled
    (the file stops growing) and ``run_with_restarts(diagnose=True)``
    returns ``main_fn``'s result from inside it."""
    import os
    import time

    from sparkdl_tpu_torch.runner import XlaRunner, events
    from sparkdl_tpu_torch.runner.failures import diagnose_context

    monkeypatch.setenv("SPARKDL_EVENT_DIR", str(tmp_path))
    monkeypatch.delenv("SPARKDL_PROCESS_ID", raising=False)
    rec = events.reset()
    with diagnose_context(interval_s=1) as path:
        x = 1 + 1
        time.sleep(1.4)
    assert x == 2
    assert path == str(tmp_path / "stack_traces_rank0.txt")
    text = open(path).read()
    assert "Timeout (0:00:01)!" in text
    assert "test_diagnose_context_runs" in text
    ev = [e for e in rec.tail() if e["name"] == "diagnose"]
    assert ev and ev[0]["path"] == path and ev[0]["interval_s"] == 1
    size = os.path.getsize(path)
    time.sleep(1.2)
    assert os.path.getsize(path) == size
    out = XlaRunner(device="cpu").run_with_restarts(
        lambda ctx: "ok", diagnose=True)
    assert out == "ok"
    assert sum(e["name"] == "diagnose" for e in rec.tail()) == 2
    monkeypatch.delenv("SPARKDL_EVENT_DIR")
    events.reset()  # the next test's recorder streams nowhere
