"""The port's Keras path (Keras 3 on its torch backend) against the JAX
package's (Keras 3 on jax), on the CPU.

Twins of ``tests/test_keras_estimator.py`` (7), of
``tests/test_transformers.py``'s ``KerasTransformer`` /
``KerasImageFileTransformer`` test (``:188``) and ``loadImageBatch`` test
(``:401``), and ``registerKerasImageUDF`` over a ``.keras`` file.

Both packages read the **same** ``.keras`` files, written here by the
reference's keras. This process runs keras on jax (``tests/conftest.py``)
and a process's keras backend is fixed at its first import, so the
port's work runs in ONE subprocess for the file (the module fixture
``port``: ``sys.executable`` with ``KERAS_BACKEND=torch`` on
``_CHILD``, kept here), which returns its results as an npz (arrays) and
a json (the rest); the reference's runs here. The images come from
``_LOADER``, a loader seeded by the row index in the URI (the
reference test's ``hash(uri)`` differs between processes), defined once
and run in both.

Tolerances: outputs of the same model on the same inputs, float32, to
rtol 1e-5 and atol 1e-6 of the largest value (one forward in each
package; their convolutions and reductions sum in other orders). Two
``sgd`` steps of the estimator (one full batch, one padded with
zero-weight rows) are held weight by weight — trainable and BatchNorm
statistics — to 1e-5 of each variable's largest magnitude, and the
change each step made to ``STEP_SHARE`` of itself.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("keras")
PIL = pytest.importorskip("PIL.Image")

import sparkdl_tpu as jsdl  # noqa: E402
from sparkdl_tpu_torch.transformers import keras_image as TKI  # noqa: E402

STEP_SHARE = 1e-4

_LOADER = r'''
import numpy as np


def loader(uri):
    """'img_<label>_<i>' -> an 8x8x3 image whose pixels encode the label
    (linearly separable), seeded by the row index i."""
    _, label, i = uri.split("_")
    rng = np.random.RandomState(int(i))
    return (np.full((8, 8, 3), float(label))
            + rng.randn(8, 8, 3) * 0.1).astype(np.float32)


def rows(n):
    return [{"uri": f"img_{i % 2}_{i}", "label": i % 2} for i in range(n)]
'''
exec(_LOADER)  # noqa: S102 — the same source the child runs

_CHILD = r'''
import json, os, sys
import numpy as np
os.environ["KERAS_BACKEND"] = "torch"
sys.path.insert(0, sys.argv[1])
spec = json.loads(sys.argv[2])
exec(spec["loader_src"])
import torch
import sparkdl_tpu_torch as tdl
from sparkdl_tpu_torch.estimators.keras_image_file_estimator import (
    _KerasTrainModule)
from sparkdl_tpu_torch.transformers.keras_utils import (_keras,
                                                        load_keras_model)
port_imported_jax = "jax" in sys.modules
keras = _keras()
arrays, info = {}, {"port_imported_jax": port_imported_jax,
                    "backend": keras.backend.backend()}
CPU = {"device": "cpu"}


def df(n, parts):
    return tdl.DataFrame.fromRows(rows(n), numPartitions=parts)


def est(**kw):
    base = dict(inputCol="uri", outputCol="scores", labelCol="label",
                modelFile=spec["tiny"], imageLoader=loader, **CPU)
    base.update(kw)
    return tdl.KerasImageFileEstimator(**base)


def scores(model, frame, col="scores"):
    return np.stack([np.asarray(getattr(r, col), np.float32)
                     for r in model.transform(frame).collect()])


# fit learns (the reference's 48 rows, 3 partitions, 4 epochs, lr 5e-2)
frame = df(48, 3)
fitted = est(batchSize=16, epochs=4, learningRate=5e-2).fit(frame)
s = scores(fitted, frame)
info["fit_accuracy"] = float((s.argmax(-1) == np.arange(48) % 2).mean())
info["fitted_device"] = fitted.getDevice()

# partial batch: 40 rows in batches of 16 -> 16, 16, 8 padded
m = est(batchSize=16, epochs=1).fit(df(40, 3))
info["partial_model_file"] = os.path.exists(m.getOrDefault(m.modelFile))

import pyarrow as pa
empty_table = pa.table({"uri": pa.array([], pa.string()),
                        "label": pa.array([], pa.int64())})
for name, call in (("empty_rows", lambda: est().fit(
                        tdl.DataFrame.fromRows([], numPartitions=1))),
                   ("empty", lambda: est().fit(
                        tdl.DataFrame.fromArrow(empty_table))),
                   ("bad_optimizer", lambda: est(
                        outputCol="s", optimizer="lion9000").fit(df(16, 1)))):
    try:
        call()
        info[name] = None
    except Exception as e:
        info[name] = [type(e).__name__, str(e)]

# fit(df, maps): paramMaps order; map 0 equals a plain fit with epochs=1
frame = df(32, 3)
e = est(batchSize=16, epochs=1)
models = e.fit(frame, [{e.epochs: 1}, {e.epochs: 2}])
info["multiple_counts"] = [mm.transform(frame).count() for mm in models]
arrays["multiple_0"] = scores(models[0], frame)
arrays["multiple_1"] = scores(models[1], frame)
arrays["single_epochs1"] = scores(est(batchSize=16, epochs=1).fit(frame),
                                  frame)

# a fitted transformer survives the deletion of its model file
frame = df(16, 2)
fitted = est(outputCol="pred", batchSize=8, epochs=1,
             learningRate=0.05).fit(frame)
arrays["survive_before"] = scores(fitted, frame, "pred")
p = os.path.join(spec["dir"], "fitted")
fitted.save(p)
tmp_model = fitted.getOrDefault(fitted.modelFile)
os.remove(tmp_model)
loaded = tdl.load(p)
info["survive_model_file_moved"] = \
    loaded.getOrDefault(loaded.modelFile) != tmp_model
arrays["survive_after"] = scores(loaded, frame, "pred")

# two sgd steps (24 rows in batches of 16: one full, one padded) on the
# BatchNorm CNN; the trained file comes back for the weight comparison
trained = est(modelFile=spec["bn"], batchSize=16, epochs=1,
              optimizer="sgd", learningRate=0.05).fit(df(24, 2))
info["sgd_trained"] = trained.getOrDefault(trained.modelFile)

# gradients reach the trainable variables through stateless_call; the new
# BatchNorm statistics come back detached
km = load_keras_model(spec["bn"], **CPU)
module = _KerasTrainModule(km)
batch = {"image": torch.from_numpy(np.stack([loader(r["uri"])
                                             for r in rows(4)])),
         "label": torch.tensor([0, 1, 0, 1]), "weight": torch.ones(4)}
loss, _, new = est(modelFile=spec["bn"])._make_loss(km)(module, batch)
loss.backward()
info["grads_reach_all_trainable"] = all(
    t.grad is not None and bool(t.grad.abs().sum() > 0)
    for t in module.trainable)
info["new_state_detached"] = all(not t.requires_grad for t in new.values())
info["new_state_names"] = sorted(new) == sorted(module.names)

# KerasTransformer (Dense, no bias) and its save bundle
xs = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]
t = tdl.KerasTransformer(inputCol="x", outputCol="y",
                         modelFile=spec["dense"], batchSize=2, **CPU)
xdf = tdl.DataFrame.fromPydict({"x": xs})
arrays["keras_transformer"] = np.asarray(
    [r.y for r in t.transform(xdf).collect()], np.float32)
import shutil
src = os.path.join(spec["dir"], "bundle_src.keras")
shutil.copyfile(spec["dense"], src)
t2 = tdl.KerasTransformer(inputCol="x", outputCol="y", modelFile=src,
                          batchSize=2, **CPU)
want = [r.y for r in t2.transform(xdf).collect()]
p = os.path.join(spec["dir"], "stage")
t2.save(p)
os.remove(src)
got = [r.y for r in tdl.load(p).transform(xdf).collect()]
arrays["bundle_want"] = np.asarray(want, np.float32)
arrays["bundle_got"] = np.asarray(got, np.float32)

# KerasImageFileTransformer over PNGs with defaultImageLoader
kt = tdl.KerasImageFileTransformer(
    inputCol="uri", outputCol="out", modelFile=spec["gap"],
    imageLoader=tdl.transformers.defaultImageLoader((8, 8)), batchSize=2,
    **CPU)
arrays["image_file"] = np.asarray(
    [r.out for r in kt.transform(tdl.DataFrame.fromPydict(
        {"uri": spec["pngs"]})).collect()], np.float32)

# registerKerasImageUDF over the .keras file and over the model object
from sparkdl_tpu_torch.image import imageIO
imgs = np.load(spec["udf_images"])
structs = [imageIO.imageArrayToStruct(im, origin=f"mem://{i}")
           for i, im in enumerate(imgs)]
idf = tdl.DataFrame.fromArrow(pa.table(
    {"image": pa.array(structs, type=imageIO._image_schema())}),
    numPartitions=2)
tdl.registerKerasImageUDF("kudf", spec["udf"], batchSize=3, **CPU)
arrays["udf_file"] = np.asarray(
    [r.o for r in tdl.applyUDF(idf, "kudf", "image", "o").collect()],
    np.float32)
tdl.registerKerasImageUDF("kudf_obj", load_keras_model(spec["udf"], **CPU),
                          batchSize=3, **CPU)
arrays["udf_object"] = np.asarray(
    [r.o for r in tdl.applyUDF(idf, "kudf_obj", "image", "o").collect()],
    np.float32)

np.savez(os.path.join(spec["dir"], "port.npz"), **arrays)
with open(os.path.join(spec["dir"], "port.json"), "w") as f:
    json.dump(info, f)
'''


def _seq(keras, *layers):
    keras.utils.set_random_seed(0)
    return keras.Sequential(list(layers))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The models (written by the reference's keras, on jax), the PNGs and
    the UDF images, in one directory."""
    import keras
    d = tmp_path_factory.mktemp("keras_twins")
    L = keras.layers
    models = {
        "tiny": _seq(keras, keras.Input((8, 8, 3)), L.Flatten(),
                     L.Dense(16, activation="relu"), L.Dense(2)),
        # no conv bias before the BatchNorm: its gradient would be
        # rounding noise (the norm removes any per-channel shift)
        "bn": _seq(keras, keras.Input((8, 8, 3)),
                   L.Conv2D(4, 3, use_bias=False), L.BatchNormalization(), L.ReLU(), L.Flatten(),
                   L.Dense(2)),
        "dense": _seq(keras, L.Input((3,)), L.Dense(2, use_bias=False)),
        "gap": _seq(keras, L.Input((8, 8, 3)), L.GlobalAveragePooling2D()),
        "udf": _seq(keras, L.Input((8, 8, 3)),
                    L.Conv2D(3, 3, padding="same"),
                    L.GlobalAveragePooling2D(), L.Dense(4)),
    }
    spec = {"dir": str(d), "loader_src": _LOADER}
    for name, m in models.items():
        spec[name] = str(d / f"{name}.keras")
        m.save(spec[name])
    rng = np.random.default_rng(0)
    spec["pngs"] = []
    for i in range(3):
        f = str(d / f"im{i}.png")
        PIL.fromarray(rng.integers(0, 256, (10, 10, 3), np.uint8)).save(f)
        spec["pngs"].append(f)
    np.save(d / "udf_images.npy",
            rng.integers(0, 256, (5, 8, 8, 3), np.uint8))
    spec["udf_images"] = str(d / "udf_images.npy")
    return spec, models


@pytest.fixture(scope="module")
def port(files):
    """Runs ``_CHILD`` once: the port's half of every twin."""
    spec, _ = files
    env = dict(os.environ, KERAS_BACKEND="torch", OMP_NUM_THREADS="2")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _CHILD, root,
                          json.dumps(spec)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-6000:]
    with np.load(os.path.join(spec["dir"], "port.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(spec["dir"], "port.json")) as f:
        info = json.load(f)
    return arrays, info


def _close(got, ref):
    atol = 1e-6 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)


def _jdf(n, parts):
    return jsdl.DataFrame.fromRows(rows(n), numPartitions=parts)


def _jest(spec, **kw):
    base = dict(inputCol="uri", outputCol="scores", labelCol="label",
                modelFile=spec["tiny"], imageLoader=loader)
    base.update(kw)
    return jsdl.KerasImageFileEstimator(**base)


# ------------------------------------------ tests/test_keras_estimator.py --

def test_fit_learns_and_returns_transformer(port):
    arrays, info = port
    assert info["backend"] == "torch" and not info["port_imported_jax"]
    assert info["fit_accuracy"] >= 0.9, info["fit_accuracy"]
    assert info["fitted_device"] == "cpu"


def test_partial_batch_padding_matches_drop(port, files):
    """40 rows in batches of 16 (16, 16, 8 padded) train without shape
    errors in both packages."""
    _, info = port
    assert info["partial_model_file"]
    spec, _ = files
    assert _jest(spec, batchSize=16, epochs=1).fit(_jdf(40, 3)) is not None


def test_fit_empty_raises(port):
    """The reference test's call raises in ``fromRows`` in both packages
    (the same message); an empty frame with the schema reaches ``fit``,
    which raises."""
    _, info = port
    with pytest.raises(ValueError) as ei:
        jsdl.DataFrame.fromRows([], numPartitions=1)
    assert info["empty_rows"] == ["ValueError", str(ei.value)]
    assert info["empty"][0] == "ValueError"
    assert "empty DataFrame" in info["empty"][1]


def test_fit_multiple_order(port):
    """fit(df, [maps]) returns models in paramMaps order: model 0 (one
    epoch) scores exactly as a plain one-epoch fit, model 1 (two) not."""
    arrays, info = port
    assert info["multiple_counts"] == [32, 32]
    np.testing.assert_array_equal(arrays["multiple_0"],
                                  arrays["single_epochs1"])
    assert not np.array_equal(arrays["multiple_1"], arrays["multiple_0"])


def test_bad_optimizer_raises(port):
    _, info = port
    assert info["bad_optimizer"][0] == "ValueError"
    assert "lion9000" in info["bad_optimizer"][1]


def test_fitted_transformer_survives_model_file_deletion(port):
    arrays, info = port
    assert info["survive_model_file_moved"]
    np.testing.assert_allclose(arrays["survive_after"],
                               arrays["survive_before"], rtol=1e-5,
                               atol=1e-6)


def test_keras_transformer_save_bundles_model(port):
    arrays, _ = port
    np.testing.assert_allclose(arrays["bundle_got"], arrays["bundle_want"],
                               rtol=1e-6)


# --------------------------------------------- the weights after 2 steps --

def test_two_sgd_steps_match_the_reference_weight_by_weight(port, files):
    """The same BatchNorm CNN, rows and loader through both estimators
    (sgd, lr 0.05, 24 rows in batches of 16: a full step and a padded
    one): every variable of the trained files — kernels, biases, gamma,
    beta, moving mean and variance — agrees to 1e-5 of its largest
    magnitude, and to STEP_SHARE of the change the reference's two steps
    made to it."""
    import keras
    spec, models = files
    _, info = port
    ref_t = _jest(spec, modelFile=spec["bn"], batchSize=16, epochs=1,
                  optimizer="sgd", learningRate=0.05).fit(_jdf(24, 2))
    ref = keras.models.load_model(ref_t.getOrDefault(ref_t.modelFile),
                                  compile=False)
    got = keras.models.load_model(info["sgd_trained"], compile=False)
    before = keras.models.load_model(spec["bn"], compile=False)
    names = [v.path for v in ref.variables]
    assert names == [v.path for v in got.variables]
    assert len(names) == 7  # conv (1), BatchNorm (4), dense (2)
    for r, g, b, name in zip(ref.variables, got.variables,
                             before.variables, names):
        r, g, b = (np.asarray(v.numpy()) for v in (r, g, b))
        change = np.abs(r - b).max()
        assert change > 0, name
        err = np.abs(g - r).max()
        assert err <= 1e-5 * np.abs(r).max(), (name, err)
        assert err <= STEP_SHARE * change, (name, err, change)


def test_gradients_reach_stateless_call_and_statistics_come_detached(port):
    _, info = port
    assert info["grads_reach_all_trainable"]
    assert info["new_state_detached"] and info["new_state_names"]


# ------------------------------------------ tests/test_transformers.py --

def test_keras_transformer_and_image_file_transformer(port, files):
    """``:188``: the Dense model's rows come out as its kernel's rows, as
    the reference's do; the GAP model over PNGs through
    ``defaultImageLoader((8, 8))`` equals the reference's output."""
    arrays, _ = port
    spec, models = files
    w = np.asarray(models["dense"].layers[0].kernel.value)
    jdf = jsdl.DataFrame.fromPydict({"x": [[1.0, 0.0, 0.0],
                                           [0.0, 1.0, 0.0]]})
    ref = np.asarray([r.y for r in jsdl.KerasTransformer(
        inputCol="x", outputCol="y", modelFile=spec["dense"],
        batchSize=2).transform(jdf).collect()], np.float32)
    _close(arrays["keras_transformer"], ref)
    np.testing.assert_allclose(arrays["keras_transformer"], w[:2],
                               rtol=1e-5)
    kt = jsdl.KerasImageFileTransformer(
        inputCol="uri", outputCol="out", modelFile=spec["gap"],
        imageLoader=jsdl.transformers.defaultImageLoader((8, 8)),
        batchSize=2)
    ref = np.asarray([r.out for r in kt.transform(
        jsdl.DataFrame.fromPydict({"uri": spec["pngs"]})).collect()],
        np.float32)
    assert arrays["image_file"].shape == (3, 3)
    _close(arrays["image_file"], ref)


def test_keras_image_parallel_loader_equivalence(tmp_path):
    """``:401``: thread-pool URI loading (loadImageBatch) produces the
    same batch as the serial path, in order, and the reference's."""
    from sparkdl_tpu.transformers import keras_image as JKI
    rng = np.random.default_rng(0)
    uris = []
    for i in range(7):
        p = str(tmp_path / f"im{i}.png")
        PIL.fromarray(rng.integers(0, 256, (9, 9, 3), np.uint8)).save(p)
        uris.append(p)
    ld = TKI.defaultImageLoader((9, 9))
    serial = np.stack([ld(u) for u in uris])
    for workers in (4, 0):
        pooled = TKI.loadImageBatch(ld, uris, workers=workers)
        np.testing.assert_array_equal(pooled, serial)
    np.testing.assert_array_equal(
        serial, JKI.loadImageBatch(JKI.defaultImageLoader((9, 9)), uris,
                                   workers=4))


# --------------------------------------------- registerKerasImageUDF --

def test_register_keras_image_udf_over_a_keras_file(port, files):
    """The same ``.keras`` file and image rows (8 x 8, the model's size,
    so no resize) through both packages' ``registerKerasImageUDF``; a
    model object registers the same UDF."""
    import pyarrow as pa
    from sparkdl_tpu.image import imageIO as JIO
    from sparkdl_tpu.udf import registry as jreg
    arrays, _ = port
    spec, _ = files
    imgs = np.load(spec["udf_images"])
    structs = [JIO.imageArrayToStruct(im, origin=f"mem://{i}")
               for i, im in enumerate(imgs)]
    jdf = jsdl.DataFrame.fromArrow(pa.table(
        {"image": pa.array(structs, type=JIO.imageSchema)}), numPartitions=2)
    jreg.registerKerasImageUDF("kudf", spec["udf"], batchSize=3)
    try:
        ref = np.asarray([r.o for r in jreg.applyUDF(
            jdf, "kudf", "image", "o").collect()], np.float32)
    finally:
        jreg.unregisterUDF("kudf")
    assert arrays["udf_file"].shape == (5, 4)
    _close(arrays["udf_file"], ref)
    np.testing.assert_array_equal(arrays["udf_object"], arrays["udf_file"])
