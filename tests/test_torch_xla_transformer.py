"""The port's ``XlaTransformer`` (``sparkdl_tpu_torch.transformers.tensor``)
and the numeric and image UDFs (``registerUDF``, ``registerImageUDF``,
``registerKerasImageUDF``'s named-model branch) against the JAX package's,
on the CPU (``device="cpu"``).

Twins of ``tests/test_transformers.py``'s ``test_xla_transformer_vector_
column``, ``test_column_to_ndarray_ragged_raises``, ``test_compat_aliases_
and_direct_image_udf``, ``test_udf_registry_roundtrip`` and
``test_register_named_model_image_udf``: the same seeded contents go
through the reference's stage or UDF (on its own DataFrame) and the
port's. Tolerances, each stated where it is used:
- a torch function over a numeric column: equal to the reference's output
  (the same f32 arithmetic on small integers);
- a function over resized pixels: |Δ| ≤ 0.01 on the 0-255 scale (the
  resize rule of ``tests/test_torch_image_transformers.py``);
- a named model's logits, the weights carried across from the flax
  variables: |Δ| ≤ 1e-5·max(1, max|ref|) + 1e-4·|ref| (the f32 model rule
  of that file).
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp
import sparkdl_tpu as sdl
import sparkdl_tpu_torch as tdl
from sparkdl_tpu.models import registry as JR
from sparkdl_tpu.transformers.tensor import columnToNdarray as jax_to_nd
from sparkdl_tpu_torch.models import registry as TR
from sparkdl_tpu_torch.transformers.tensor import columnToNdarray
from test_torch_image_models import flax_variables
from test_torch_image_transformers import (FN_ATOL, assert_f32_close,
                                           rand_imgs, twin_dfs)


def _vectors(rows, parts=2):
    return (sdl.DataFrame.fromPydict({"x": rows}, numPartitions=parts),
            tdl.DataFrame.fromPydict({"x": rows}, numPartitions=parts))


def test_xla_transformer_vector_column():
    jdf, tdf = _vectors([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    j = sdl.XlaTransformer(inputCol="x", outputCol="y",
                           fn=lambda b: b @ jnp.array([[1.0], [10.0]]),
                           batchSize=2)
    t = tdl.XlaTransformer(inputCol="x", outputCol="y",
                           fn=lambda b: b @ torch.tensor([[1.0], [10.0]]),
                           batchSize=2, device="cpu")
    ref = [r.y for r in j.transform(jdf).collect()]
    got = [r.y for r in t.transform(tdf).collect()]
    assert [y[0] for y in got] == [21.0, 43.0, 65.0]
    assert got == ref


def test_xla_transformer_input_shape_and_quarantine():
    """``inputShape`` reshapes flat rows before ``fn``; with
    ``onError='quarantine'`` a row that does not fit it is dead-lettered
    and the rest scored, as in the reference."""
    rows = [[float(i)] * 6 for i in range(5)]
    rows[2] = [1.0, 2.0, 3.0]
    jdf, tdf = _vectors(rows)
    kw = dict(inputCol="x", outputCol="y", inputShape=(2, 3), batchSize=2,
              onError="quarantine")
    j = sdl.XlaTransformer(fn=lambda b: b.sum(axis=2), **kw)
    t = tdl.XlaTransformer(fn=lambda b: b.sum(dim=2), device="cpu", **kw)
    ref = j.transform(jdf).collect()
    got = t.transform(tdf).collect()
    assert [r.y for r in got] == [r.y for r in ref] == [
        [3.0 * i] * 2 for i in (0, 1, 3, 4)]
    dead, jdead = t.deadLetters(), j.deadLetters()
    assert dead.num_rows == jdead.num_rows == 1
    assert dead.column("x").to_pylist() == [[1.0, 2.0, 3.0]]
    assert dead.column("error_class").to_pylist() == \
        jdead.column("error_class").to_pylist()


def test_column_to_ndarray_ragged_raises():
    col = pa.array([[1.0, 2.0], [3.0]])
    for fn in (jax_to_nd, columnToNdarray):
        with pytest.raises(ValueError, match="Ragged"):
            fn(col, None)


def test_compat_aliases_and_direct_image_udf():
    """The TF-era names are aliases, and ``registerImageUDF`` works on its
    own: the mean per channel of each image resized to 8x8, equal to the
    reference's within the resize rule."""
    assert tdl.TFTransformer is tdl.XlaTransformer
    assert tdl.transformers.TensorTransformer is tdl.XlaTransformer
    assert isinstance(tdl.__version__, str) and tdl.__version__
    jdf, tdf = twin_dfs(rand_imgs(3), parts=1)
    sdl.registerImageUDF("half8", lambda b: jnp.mean(b, axis=(1, 2)),
                         inputSize=(8, 8), batchSize=2)
    tdl.registerImageUDF("half8", lambda b: b.mean(dim=(1, 2)),
                         inputSize=(8, 8), batchSize=2, device="cpu")
    try:
        ref = [r["m"] for r in sdl.applyUDF(jdf, "half8", "image",
                                            "m").collect()]
        got = [r["m"] for r in tdl.applyUDF(tdf, "half8", "image",
                                            "m").collect()]
    finally:
        sdl.udf.unregisterUDF("half8")
        tdl.udf.unregisterUDF("half8")
    assert len(got) == 3 and len(got[0]) == 3
    np.testing.assert_allclose(got, ref, atol=FN_ATOL, rtol=0)


def test_udf_registry_roundtrip():
    jdf, tdf = _vectors([[1.0], [2.0]], parts=1)
    sdl.registerUDF("double_it", lambda b: b * 2.0, batchSize=4)
    tdl.registerUDF("double_it", lambda b: b * 2.0, batchSize=4,
                    device="cpu")
    try:
        assert "double_it" in tdl.listUDFs()
        ref = [r.y for r in sdl.applyUDF(jdf, "double_it", "x",
                                         "y").collect()]
        got = [r.y for r in tdl.applyUDF(tdf, "double_it", "x",
                                         "y").collect()]
        assert [y[0] for y in got] == [2.0, 4.0] and got == ref
        with pytest.raises(ValueError, match="not registered"):
            tdl.applyUDF(tdf, "nope", "x", "y")
    finally:
        sdl.udf.unregisterUDF("double_it")
        tdl.udf.unregisterUDF("double_it")
    assert "double_it" not in tdl.listUDFs()


def test_register_named_model_image_udf(monkeypatch):
    """``registerKerasImageUDF("rn18", "ResNet18")``: 1000 logits a row,
    equal to the reference's UDF when both models hold the same flax
    variables (each package's random init carried over from one numpy
    seed; the packages' own inits draw different numbers)."""
    variables = flax_variables("ResNet18", 224, seed=3)
    monkeypatch.setattr(JR.NamedImageModel, "init_params",
                        lambda self, *a, **k: variables)
    build = TR.NamedImageModel.build
    monkeypatch.setattr(
        TR.NamedImageModel, "build",
        lambda self, *a, **k: TR.load_flax_variables(build(self, *a, **k),
                                                     variables))
    jdf, tdf = twin_dfs(rand_imgs(2, seed=4), parts=1)
    sdl.registerKerasImageUDF("rn18", "ResNet18", batchSize=2)
    tdl.registerKerasImageUDF("rn18", "ResNet18", batchSize=2,
                              device="cpu")
    try:
        ref = np.asarray([r.probs for r in sdl.applyUDF(
            jdf, "rn18", "image", "probs").collect()], np.float32)
        got = np.asarray([r.probs for r in tdl.applyUDF(
            tdf, "rn18", "image", "probs").collect()], np.float32)
    finally:
        sdl.udf.unregisterUDF("rn18")
        tdl.udf.unregisterUDF("rn18")
    assert got.shape == (2, 1000)
    assert_f32_close(got, ref)
