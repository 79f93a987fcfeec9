"""The port's image transformers, streaming scorer and LogisticRegression
(``sparkdl_tpu_torch.transformers`` / ``.estimators``) against the JAX
package's, on the CPU (``device="cpu"``), over the same synthetic image
DataFrames (numpy-seeded uint8 pixels).

Weights are carried across: the flax variables are made from a numpy seed
(``test_torch_image_models.flax_variables``) and installed in both
featurizers with ``setWeights``. Tolerances, each stated where it is used:
- f32 features: |Δ| ≤ 1e-5·max(1, max|ref|) + 1e-4·|ref| (the model
  rule of ``test_torch_image_models``; here the bilinear resize runs
  first, which adds nothing measurable at f32);
- bf16 features: |Δ| ≤ 2^-5·max|ref|;
- a user ``fn`` over resized pixels: |Δ| ≤ 0.01 on the 0-255 scale (the
  resize rule of ``test_torch_image_runtime``: downscale 1e-2);
- predictions equal wherever the reference's top-2 probability margin
  exceeds 1e-3 (two f32 Adam runs in different summation orders agree to
  ~1e-5 in probability here); coefficients |Δ| ≤ 1e-3·max|w_ref| + 1e-3.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp
import sparkdl_tpu as sdl
import sparkdl_tpu_torch as tdl
from sparkdl_tpu.image import imageIO as JIO
from sparkdl_tpu_torch.image import imageIO as TIO
from sparkdl_tpu_torch.runner import metrics
from test_torch_image_models import flax_variables

BF16_RULE = 2.0 ** -5
FN_ATOL = 1e-2
MARGIN = 1e-3


def image_table(imgs, labels=None, IO=TIO, origins=None):
    structs = [IO.imageArrayToStruct(im, origin=(origins[i] if origins
                                                 else f"mem://{i}"))
               for i, im in enumerate(imgs)]
    cols = {"image": pa.array(structs, type=IO.imageSchema)}
    if labels is not None:
        cols["label"] = pa.array(labels)
    return pa.table(cols)


def twin_dfs(imgs, labels=None, parts=2):
    """The same rows as a JAX-package DataFrame and a port DataFrame."""
    return (sdl.DataFrame.fromArrow(image_table(imgs, labels, JIO),
                                    numPartitions=parts),
            tdl.DataFrame.fromArrow(image_table(imgs, labels, TIO),
                                    numPartitions=parts))


def rand_imgs(n, h=40, w=40, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(n)]


def col(rows, name):
    return np.asarray([getattr(r, name) for r in rows], np.float32)


def assert_f32_close(got, ref):
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol)


@pytest.fixture(scope="module")
def resnet18_vars():
    return flax_variables("ResNet18", 224, seed=3)


def featurizers(variables, dtype="float32", model="ResNet18", **kw):
    j = sdl.DeepImageFeaturizer(inputCol="image", outputCol="features",
                                modelName=model, batchSize=4,
                                computeDtype=dtype, **kw).setWeights(
        variables)
    t = tdl.DeepImageFeaturizer(inputCol="image", outputCol="features",
                                modelName=model, batchSize=4,
                                computeDtype=dtype, device="cpu",
                                **kw).setWeights(variables)
    return j, t


def test_xla_image_transformer_matches_jax_on_a_downscale():
    jdf, tdf = twin_dfs(rand_imgs(6))
    j = sdl.XlaImageTransformer(inputCol="image", outputCol="feat",
                                fn=lambda b: jnp.mean(b, axis=(1, 2)),
                                inputSize=(16, 16), batchSize=4)
    t = tdl.XlaImageTransformer(inputCol="image", outputCol="feat",
                                fn=lambda b: b.mean(dim=(1, 2)),
                                inputSize=(16, 16), batchSize=4,
                                device="cpu")
    ref = col(j.transform(jdf).collect(), "feat")
    got = col(t.transform(tdf).collect(), "feat")
    assert got.shape == (6, 3)
    np.testing.assert_allclose(got, ref, atol=FN_ATOL, rtol=0)


def test_xla_image_transformer_alias_and_image_output():
    assert tdl.TFImageTransformer is tdl.XlaImageTransformer
    _, tdf = twin_dfs(rand_imgs(3), parts=1)
    t = tdl.XlaImageTransformer(
        inputCol="image", outputCol="out", fn=lambda b: b * 0.5,
        inputSize=(8, 8), batchSize=2, outputMode="image", device="cpu")
    rows = t.transform(tdf).collect()
    assert rows[0].out["height"] == 8 and rows[0].out["nChannels"] == 3


def test_featurizer_f32_matches_jax(resnet18_vars):
    jdf, tdf = twin_dfs(rand_imgs(5), parts=2)
    j, t = featurizers(resnet18_vars)
    ref = col(j.transform(jdf).collect(), "features")
    got = col(t.transform(tdf).collect(), "features")
    assert got.shape == (5, 512) and t.featureDim() == 512
    assert_f32_close(got, ref)


def test_featurizer_bf16_matches_jax_bf16(resnet18_vars):
    jdf, tdf = twin_dfs(rand_imgs(4, seed=2), parts=1)
    j, t = featurizers(resnet18_vars, dtype="bfloat16")
    ref = col(j.transform(jdf).collect(), "features")
    got = col(t.transform(tdf).collect(), "features")
    assert np.abs(got - ref).max() <= BF16_RULE * np.abs(ref).max()


def test_inception_v3_featurizer_matches_jax():
    """The config-1 model, at its 299x299 input, from 64x64 wire images
    (upscaled in the prologue)."""
    variables = flax_variables("InceptionV3", 299, seed=4)
    jdf, tdf = twin_dfs(rand_imgs(2, 64, 64, seed=5), parts=1)
    j, t = featurizers(variables, model="InceptionV3")
    ref = col(j.transform(jdf).collect(), "features")
    got = col(t.transform(tdf).collect(), "features")
    assert got.shape == (2, 2048)
    assert_f32_close(got, ref)


def test_predictor_decoded_matches_jax(resnet18_vars):
    jdf, tdf = twin_dfs(rand_imgs(3, seed=6), parts=1)
    kw = dict(inputCol="image", outputCol="pred", modelName="ResNet18",
              batchSize=4, decodePredictions=True, topK=3)
    j = sdl.DeepImagePredictor(**kw).setWeights(resnet18_vars)
    t = tdl.DeepImagePredictor(device="cpu", **kw).setWeights(resnet18_vars)
    ref = [r.pred for r in j.transform(jdf).collect()]
    got = [r.pred for r in t.transform(tdf).collect()]
    assert [[p["class"] for p in r] for r in got] == \
        [[p["class"] for p in r] for r in ref]
    np.testing.assert_allclose([[p["score"] for p in r] for r in got],
                               [[p["score"] for p in r] for r in ref],
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("size", [(40, 40), (224, 224)],
                         ids=["downscale", "same-size"])
def test_fused_feed_matches_packed_feed(monkeypatch, resnet18_vars, size):
    """The fused prologue (uint8 wire, flip + resize on the device) against
    the host-packed feed (``SPARKDL_FUSED_PREPROCESS=0``, the native
    packer resizing on the host). At the model's own size the prologue
    skips the resize and the two feeds are bit-identical."""
    imgs = rand_imgs(4, *size, seed=7)
    _, tdf = twin_dfs(imgs, parts=1)
    outs = []
    for fused in ("1", "0"):
        monkeypatch.setenv("SPARKDL_FUSED_PREPROCESS", fused)
        _, t = featurizers(resnet18_vars)
        outs.append(col(t.transform(tdf).collect(), "features"))
    if size == (224, 224):
        np.testing.assert_array_equal(outs[0], outs[1])
    else:
        # the host packer rounds its resize to uint8 levels: the features
        # of the two feeds differ by the model's gain on ≤ 0.5 level
        rel = np.abs(outs[0] - outs[1]).max() / np.abs(outs[1]).max()
        assert rel < 2e-2, rel


def test_quarantine_dead_letters_match_jax():
    imgs = [np.full((6, 6, 3), i * 10, np.uint8) for i in range(8)]
    tables = []
    for IO in (JIO, TIO):
        structs = [IO.imageArrayToStruct(im, origin=f"m{i}")
                   for i, im in enumerate(imgs)]
        structs[3] = dict(structs[3], data=structs[3]["data"][:17])
        structs[6] = dict(structs[6], data=b"\x00" * 5)
        tables.append(pa.table({"image": pa.array(structs,
                                                  type=IO.imageSchema)}))
    jdf = sdl.DataFrame.fromArrow(tables[0], numPartitions=2)
    tdf = tdl.DataFrame.fromArrow(tables[1], numPartitions=2)
    kw = dict(inputCol="image", outputCol="out", inputSize=(6, 6),
              batchSize=4, onError="quarantine")
    j = sdl.XlaImageTransformer(fn=lambda b: b.mean(axis=(1, 2)), **kw)
    t = tdl.XlaImageTransformer(fn=lambda b: b.mean(dim=(1, 2)),
                                device="cpu", **kw)
    metrics.run_stats.reset()
    ref = j.transform(jdf).collect()
    got = t.transform(tdf).collect()
    assert [r.image["origin"] for r in got] == \
        [r.image["origin"] for r in ref] == \
        [f"m{i}" for i in range(8) if i not in (3, 6)]
    np.testing.assert_array_equal(col(got, "out"), col(ref, "out"))
    dead, jdead = t.deadLetters(), j.deadLetters()
    assert dead.num_rows == jdead.num_rows == 2
    assert dead.column("error_class").to_pylist() == \
        jdead.column("error_class").to_pylist()
    assert [r["origin"] for r in dead.column("image").to_pylist()] == \
        ["m3", "m6"]
    assert metrics.run_stats.rows_quarantined == 2
    metrics.run_stats.reset()


def test_quarantine_circuit_breaker_is_fatal():
    from sparkdl_tpu_torch.runner.failures import (QuarantineOverflowError,
                                                   classify_exception)
    imgs = [np.full((6, 6, 3), i, np.uint8) for i in range(4)]
    structs = [TIO.imageArrayToStruct(im) for im in imgs]
    structs = [dict(s, data=b"\x00") if i else s
               for i, s in enumerate(structs)]
    df = tdl.DataFrame.fromArrow(
        pa.table({"image": pa.array(structs, type=TIO.imageSchema)}))
    t = tdl.XlaImageTransformer(inputCol="image", outputCol="o",
                                fn=lambda b: b.mean(dim=(1, 2)),
                                inputSize=(6, 6), batchSize=4,
                                onError="quarantine", device="cpu")
    with pytest.raises(QuarantineOverflowError) as ei:
        t.transform(df).collect()
    assert classify_exception(ei.value) == "fatal"
    metrics.run_stats.reset()


def test_save_load_gives_bit_identical_features(tmp_path, resnet18_vars):
    _, tdf = twin_dfs(rand_imgs(3, seed=8), parts=1)
    _, t = featurizers(resnet18_vars)
    a = col(t.transform(tdf).collect(), "features")
    p = str(tmp_path / "feat")
    t.save(p)
    loaded = tdl.load(p)
    assert loaded.getDevice() == "cpu"
    b = col(loaded.transform(tdf).collect(), "features")
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_config1_pipeline_matches_jax(tmp_path, resnet18_vars, dtype):
    """``Pipeline([DeepImageFeaturizer, LogisticRegression])``: fit and
    transform on the same synthetic DataFrame (two classes of different
    mean colour) in both packages, with the same carried weights."""
    rng = np.random.default_rng(10)
    labels = [i % 2 for i in range(12)]
    imgs = [np.clip(rng.normal(80 + 90 * y, 40, (40, 40, 3)), 0, 255
                    ).astype(np.uint8) for y in labels]
    jdf, tdf = twin_dfs(imgs, labels, parts=2)
    jf, tf = featurizers(resnet18_vars, dtype=dtype)
    lr = dict(maxIter=40, stepSize=0.1, regParam=1e-3,
              probabilityCol="prob")
    jpm = sdl.Pipeline(stages=[jf, sdl.LogisticRegression(**lr)]).fit(jdf)
    tpm = tdl.Pipeline(stages=[
        tf, tdl.LogisticRegression(device="cpu", **lr)]).fit(tdf)
    ref = jpm.transform(jdf).collect()
    got = tpm.transform(tdf).collect()
    pref = col(ref, "prob")
    margin = np.abs(pref[:, 1] - pref[:, 0])
    keep = margin > MARGIN
    assert keep.sum() >= len(ref) // 2
    assert [r.prediction for r, k in zip(got, keep) if k] == \
        [r.prediction for r, k in zip(ref, keep) if k]
    assert np.mean([r.prediction == r.label for r in got]) > 0.9
    if dtype == "float32":
        w_ref = jpm.stages[1].weights
        np.testing.assert_allclose(tpm.stages[1].weights, w_ref, rtol=0,
                                   atol=1e-3 * np.abs(w_ref).max() + 1e-3)
    p = str(tmp_path / "pm")
    tpm.save(p)
    loaded = tdl.load(p)
    again = loaded.transform(tdf).collect()
    np.testing.assert_array_equal(col(again, "features"),
                                  col(got, "features"))
    assert [r.prediction for r in again] == [r.prediction for r in got]


def test_logistic_regression_fit_arrays_matches_jax():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 4)).astype(np.float32)
    y = (X[:, 0] + 2 * X[:, 1] > 0).astype(np.int32)
    df = sdl.DataFrame.fromPydict({"features": X.tolist(),
                                   "label": y.tolist()}, numPartitions=3)
    ref = sdl.LogisticRegression(maxIter=200, stepSize=0.2,
                                 regParam=1e-3).fit(df)
    model = tdl.LogisticRegression(maxIter=200, stepSize=0.2, regParam=1e-3,
                                   device="cpu")._fit_arrays(X, y)
    np.testing.assert_allclose(model.weights, ref.weights, rtol=0,
                               atol=1e-3 * np.abs(ref.weights).max() + 1e-3)
    np.testing.assert_allclose(model.bias, ref.bias, atol=1e-3)
    pred, prob = model.predict_arrays(X)
    assert np.mean(pred == y) > 0.95
    np.testing.assert_allclose(prob.sum(-1), 1.0, atol=1e-5)


def test_logistic_regression_dataframe_fit_and_empty():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(60, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int32)
    df = tdl.DataFrame.fromPydict({"features": X.tolist(),
                                   "label": y.tolist()}, numPartitions=3)
    model = tdl.LogisticRegression(maxIter=100, stepSize=0.2,
                                   probabilityCol="prob",
                                   device="cpu").fit(df)
    rows = model.transform(df).collect()
    assert np.mean([r.prediction == r.label for r in rows]) > 0.9
    assert abs(sum(rows[0].prob) - 1.0) < 1e-5 and model.numClasses == 2
    with pytest.raises(ValueError, match="empty"):
        tdl.LogisticRegression(device="cpu").fit(
            tdl.DataFrame.fromPydict({"features": [], "label": []}))


def test_runner_cached_across_transform_calls(resnet18_vars):
    _, tdf = twin_dfs(rand_imgs(2), parts=1)
    _, t = featurizers(resnet18_vars)
    t.transform(tdf).collect()
    r1 = t._get_runner()
    t.transform(tdf).collect()
    assert t._get_runner() is r1


def test_empty_partition_passthrough():
    _, tdf = twin_dfs(rand_imgs(4), parts=2)
    emptied = tdf.filter(lambda r: r.image["origin"] in ("mem://0",
                                                        "mem://1"))
    t = tdl.XlaImageTransformer(inputCol="image", outputCol="f",
                                fn=lambda b: b.mean(dim=(1, 2, 3)),
                                inputSize=(8, 8), batchSize=2, device="cpu")
    assert len(t.transform(emptied).collect()) == 2


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """Unset ``device`` means the card: without one, the featurizer, the
    image transformer and the estimator raise (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tdf = twin_dfs(rand_imgs(2), parts=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdl.DeepImageFeaturizer(inputCol="image", outputCol="f",
                                modelName="ResNet18").transform(tdf).collect()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdl.XlaImageTransformer(inputCol="image", outputCol="f",
                                fn=lambda b: b, inputSize=(8, 8)
                                ).transform(tdf).collect()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdl.LogisticRegression()._fit_arrays(np.zeros((2, 3)),
                                             np.array([0, 1]))


def test_out_of_slice_surfaces_raise_naming_their_queue(tmp_path):
    jdf, tdf = twin_dfs(rand_imgs(2), parts=1)
    # numDevices above the devices there are raises what the reference
    # raises; outside a gang there is one (the gang is held in
    # tests/test_torch_moe_pipeline.py)
    with pytest.raises(ValueError, match="only 1 visible"):
        tdl.XlaImageTransformer(inputCol="image", outputCol="f",
                                fn=lambda b: b, inputSize=(8, 8),
                                numDevices=2, device="cpu"
                                ).transform(tdf).collect()
    # the weight files the reference reads are read, not refused: on a
    # file that is not there (or an .h5 of a family Keras has no layout
    # for) the port raises what the reference raises
    for path in ("w.h5", "w.hdf5", "w.msgpack", "w.safetensors"):
        errs = []
        for pkg, df, kw in ((sdl, jdf, {}), (tdl, tdf, {"device": "cpu"})):
            f = pkg.DeepImageFeaturizer(inputCol="image", outputCol="f",
                                        modelName="ResNet18",
                                        weightsPath=str(tmp_path / path),
                                        **kw)
            with pytest.raises(Exception) as ei:
                f.transform(df).collect()
            assert not isinstance(ei.value, NotImplementedError)
            errs.append((type(ei.value).__name__, str(ei.value)))
        assert errs[0] == errs[1], errs
    import sparkdl_tpu_torch.estimators as E
    import sparkdl_tpu_torch.transformers as T
    # Queue A 9's Keras names import now (the Keras path on Keras's torch
    # backend; tests/test_torch_keras.py holds them against the reference)
    from sparkdl_tpu_torch.estimators import keras_image_file_estimator
    from sparkdl_tpu_torch.transformers import keras_image, tensor
    for mod, name, home in ((T, "KerasTransformer", tensor),
                            (T, "KerasImageFileTransformer", keras_image),
                            (T, "defaultImageLoader", keras_image),
                            (E, "KerasImageFileEstimator",
                             keras_image_file_estimator)):
        assert getattr(mod, name) is getattr(home, name)
    # Queue A 4's names import now (model selection, evaluators, the
    # feature stages, the tokenizer)
    from sparkdl_tpu_torch.core import tuning
    from sparkdl_tpu_torch.models import ByteBPETokenizer
    for mod, name in ((T, "VectorAssembler"), (T, "StringIndexer"),
                      (T, "StandardScaler"), (T, "IndexToString"),
                      (E, "MulticlassClassificationEvaluator"),
                      (E, "RegressionEvaluator"),
                      (E, "BinaryClassificationEvaluator"),
                      (tuning, "CrossValidator"),
                      (tuning, "TrainValidationSplit"),
                      (tuning, "ParamGridBuilder")):
        assert isinstance(getattr(mod, name), type), name
    assert getattr(tdl, "ByteBPETokenizer") is ByteBPETokenizer
