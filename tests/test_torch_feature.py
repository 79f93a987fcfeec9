"""The port's feature stages (``sparkdl_tpu_torch.transformers.feature``:
VectorAssembler, StringIndexer, StandardScaler, IndexToString) held
against the JAX package's: the twins of the twelve tests of
``tests/test_feature.py``. Each twin runs the same DataFrame through both
packages and requires the same output (float columns bitwise: both stages
compute in float64 numpy on the host; errors with the same message),
beside the reference test's own checks on the port."""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import numpy as np
import pyarrow as pa
import pytest

import sparkdl_tpu as jsdl
import sparkdl_tpu_torch as sdl


def _both(body):
    """``body(pkg)`` for the port and the reference; the port's result,
    after checking the two are equal."""
    got, want = body(sdl), body(jsdl)
    np.testing.assert_equal(got, want)
    return got


def _raises_alike(body, exc, match):
    """``body(pkg)`` raises ``exc`` matching ``match`` in both packages,
    with the same message."""
    msgs = []
    for pkg in (sdl, jsdl):
        with pytest.raises(exc, match=match) as e:
            body(pkg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_vector_assembler_scalars_and_vectors():
    def body(pkg):
        df = pkg.DataFrame.fromPydict(
            {"a": [1.0, 2.0], "b": [10, 20],
             "v": [np.asarray([0.5, 0.6], np.float32),
                   np.asarray([0.7, 0.8], np.float32)]},
            numPartitions=2)
        va = pkg.VectorAssembler(inputCols=["a", "v", "b"], outputCol="feat")
        return [r["feat"] for r in va.transform(df).collect()]
    rows = _both(body)
    np.testing.assert_allclose(rows[0], [1.0, 0.5, 0.6, 10.0])
    np.testing.assert_allclose(rows[1], [2.0, 0.7, 0.8, 20.0])
    _raises_alike(lambda pkg: pkg.VectorAssembler(outputCol="f").transform(
        pkg.DataFrame.fromPydict({"a": [1.0]})), ValueError, "inputCols")


def test_string_indexer_frequency_order_and_inverse():
    def body(pkg):
        df = pkg.DataFrame.fromPydict(
            {"fruit": ["b", "a", "b", "c", "b", "a"]}, numPartitions=3)
        model = pkg.StringIndexer(inputCol="fruit", outputCol="idx").fit(df)
        out = model.transform(df)
        inv = pkg.IndexToString(inputCol="idx", outputCol="fruit2",
                                labels=model.getOrDefault(model.labels))
        return (model.getOrDefault(model.labels),
                [r["idx"] for r in out.collect()],
                [r["fruit2"] for r in inv.transform(out).collect()])
    labels, idx, back = _both(body)
    assert labels == ["b", "a", "c"]
    assert idx == [0, 1, 0, 2, 0, 1]
    assert back == ["b", "a", "b", "c", "b", "a"]


def test_vector_assembler_rejects_nulls_and_handles_fixed_size_list():
    def assemble(pkg, col, cols=("v",)):
        return pkg.VectorAssembler(inputCols=list(cols), outputCol="f") \
            .transform(pkg.DataFrame.fromArrow(pa.table(col))).collect()

    nested = pa.array([[1.0, None], [2.0, 3.0]], type=pa.list_(pa.float64()))
    fsln = pa.FixedSizeListArray.from_arrays(
        pa.array([1.0, None, 2.0, 3.0], pa.float64()), 2)
    for col in ({"a": pa.array([1.0, None])}, {"v": nested}, {"v": fsln}):
        _raises_alike(lambda pkg: assemble(pkg, col, list(col)), ValueError,
                      "contains null")
    _raises_alike(lambda pkg: pkg.StandardScaler(
        inputCol="v", outputCol="s").fit(
            pkg.DataFrame.fromArrow(pa.table({"v": nested}))),
        ValueError, "contains null")
    exact = 16777217.0  # 2**24 + 1: not representable in float32
    ll = pa.array([[exact]], type=pa.large_list(pa.float64()))
    assert _both(lambda pkg: assemble(pkg, {"v": ll})[0]["f"])[0] == exact
    fsl = pa.FixedSizeListArray.from_arrays(
        pa.array([1.0, 2.0, 3.0, 4.0], pa.float32()), 2)
    rows = _both(lambda pkg: [r["f"] for r in assemble(
        pkg, {"v": fsl, "s": [7.0, 8.0]}, ("v", "s"))])
    np.testing.assert_allclose(rows, [[1.0, 2.0, 7.0], [3.0, 4.0, 8.0]])


def test_vector_assembler_keeps_chain_streamable():
    def body(pkg):
        df = pkg.DataFrame.fromPydict(
            {"x": [float(i) for i in range(12)]}, numPartitions=1)
        out = pkg.VectorAssembler(inputCols=["x"],
                                  outputCol="f").transform(df)
        return out._streamable(), [b.num_rows for b in out.iterBatches(4)]
    assert _both(body) == (True, [4, 4, 4])


def test_string_indexer_handle_invalid_validated_at_set_time():
    _raises_alike(lambda pkg: pkg.StringIndexer(
        inputCol="s", outputCol="i", handleInvalid="skip"),
        TypeError, "handleInvalid")


def test_string_indexer_nulls_are_invalid_not_labels():
    def df(pkg):
        return pkg.DataFrame.fromPydict({"s": ["a", None, "a"]})
    _raises_alike(lambda pkg: pkg.StringIndexer(
        inputCol="s", outputCol="i").fit(df(pkg)), ValueError,
        "null in column 's'")

    def body(pkg):
        m = pkg.StringIndexer(inputCol="s", outputCol="i",
                              handleInvalid="keep").fit(df(pkg))
        return (m.getOrDefault(m.labels),
                [r["i"] for r in m.transform(df(pkg)).collect()])
    assert _both(body) == (["a"], [0, 1, 0])


def test_string_indexer_unseen_labels():
    def frames(pkg):
        return (pkg.DataFrame.fromPydict({"s": ["x", "y"]}),
                pkg.DataFrame.fromPydict({"s": ["x", "z"]}))

    def strict(pkg):
        train, test = frames(pkg)
        pkg.StringIndexer(inputCol="s", outputCol="i").fit(train) \
            .transform(test).collect()
    _raises_alike(strict, ValueError, "unseen label 'z'")

    def keep(pkg):
        train, test = frames(pkg)
        m = pkg.StringIndexer(inputCol="s", outputCol="i",
                              handleInvalid="keep").fit(train)
        return [r["i"] for r in m.transform(test).collect()]
    assert _both(keep) == [0, 2]


def test_feature_stages_persist(tmp_path):
    def body(pkg):
        d = tmp_path / pkg.__name__
        df = pkg.DataFrame.fromPydict({"s": ["a", "b", "a"]})
        model = pkg.StringIndexer(inputCol="s", outputCol="i").fit(df)
        model.save(str(d / "sim"))
        back = pkg.load(str(d / "sim"))
        pkg.VectorAssembler(inputCols=["x", "y"], outputCol="f").save(
            str(d / "va"))
        va2 = pkg.load(str(d / "va"))
        d2 = pkg.DataFrame.fromPydict({"x": [1.0], "y": [2.0]})
        return (back.getOrDefault(back.labels),
                [r["i"] for r in back.transform(df).collect()],
                list(va2.transform(d2).first()["f"]))
    labels, idx, f = _both(body)
    assert labels == ["a", "b"] and idx == [0, 1, 0] and f == [1.0, 2.0]


def test_standard_scaler():
    rng = np.random.RandomState(0)
    X = rng.randn(50, 3) * [2.0, 5.0, 0.0] + [1.0, -3.0, 7.0]
    big = 1.7e12 + rng.randn(100) * 987.5

    def df(pkg):
        return pkg.DataFrame.fromPydict(
            {"v": [np.asarray(x, np.float64) for x in X]}, numPartitions=4)

    def body(pkg):
        m = pkg.StandardScaler(inputCol="v", outputCol="s", withMean=True,
                               withStd=True).fit(df(pkg))
        out = np.stack([np.asarray(r["s"])
                        for r in m.transform(df(pkg)).collect()])
        m2 = pkg.StandardScaler(inputCol="v", outputCol="s").fit(df(pkg))
        out2 = np.stack([np.asarray(r["s"])
                         for r in m2.transform(df(pkg)).collect()])
        mb = pkg.StandardScaler(inputCol="v", outputCol="s").fit(
            pkg.DataFrame.fromPydict(
                {"v": [np.asarray([x], np.float64) for x in big]},
                numPartitions=5))
        empty = m.transform(df(pkg).filter(lambda r: False)).count()
        return (m.getOrDefault(m.mean), m.getOrDefault(m.std), out, out2,
                mb.getOrDefault(mb.std), empty)
    mean, std, out, out2, std_big, empty = _both(body)
    np.testing.assert_allclose(mean, X.mean(0), atol=1e-9)
    np.testing.assert_allclose(std, X.std(0, ddof=1), atol=1e-9)
    np.testing.assert_allclose(out.mean(0), [0, 0, 0], atol=1e-9)
    np.testing.assert_allclose(out.std(0, ddof=1)[:2], [1, 1], atol=1e-9)
    assert np.isfinite(out).all() and np.allclose(out[:, 2], 0.0)
    np.testing.assert_allclose(out2.mean(0)[:2],
                               X.mean(0)[:2] / X.std(0, ddof=1)[:2],
                               atol=1e-9)
    np.testing.assert_allclose(out2[:, 2], 0.0)
    np.testing.assert_allclose(std_big, [big.std(ddof=1)], rtol=1e-6)
    assert empty == 0

    def fitted(pkg):
        return pkg.StandardScaler(inputCol="v", outputCol="s",
                                  withMean=True).fit(df(pkg))
    _raises_alike(lambda pkg: fitted(pkg).transform(
        pkg.DataFrame.fromArrow(pa.table({"v": pa.array(
            [[1.0, 2.0, 3.0], None], type=pa.list_(pa.float64()))}))
    ).collect(), ValueError, "contains null")
    _raises_alike(lambda pkg: pkg.StandardScaler(
        inputCol="v", outputCol="s").fit(df(pkg).filter(lambda r: False)),
        ValueError, "empty")
    _raises_alike(lambda pkg: fitted(pkg).transform(
        pkg.DataFrame.fromPydict({"v": [np.zeros(5, np.float64)]})
    ).collect(), ValueError, "dims")


def test_standard_scaler_scalar_column():
    def body(pkg):
        df = pkg.DataFrame.fromPydict({"x": [1.0, 2.0, 3.0, 4.0]})
        m = pkg.StandardScaler(inputCol="x", outputCol="s",
                               withMean=True).fit(df)
        return np.asarray([r["s"] for r in m.transform(df).collect()])
    out = _both(body)
    np.testing.assert_allclose(out.mean(), 0.0, atol=1e-12)
    np.testing.assert_allclose(out.std(ddof=1), 1.0, atol=1e-12)


def test_standard_scaler_persists(tmp_path):
    def body(pkg):
        df = pkg.DataFrame.fromPydict(
            {"v": [np.asarray([1.0, 2.0]), np.asarray([3.0, 6.0])]})
        m = pkg.StandardScaler(inputCol="v", outputCol="s",
                               withMean=True).fit(df)
        p = str(tmp_path / pkg.__name__)
        m.save(p)
        back = pkg.load(p)
        return ([r["s"] for r in m.transform(df).collect()],
                [r["s"] for r in back.transform(df).collect()])
    a, b = _both(body)
    np.testing.assert_equal(a, b)


def test_indexer_in_pipeline_with_assembler():
    """StringIndexer labels + VectorAssembler features →
    LogisticRegression in one Pipeline (the port's learner on the CPU):
    the indexed labels and the features equal the reference's; accuracy
    ≥ 0.95 in both."""
    rng = np.random.RandomState(0)
    n = 40
    cls = ["cat" if i % 2 else "dog" for i in range(n)]
    feats = [rng.randn(3) + (2.0 if c == "cat" else -2.0) for c in cls]

    def body(pkg):
        df = pkg.DataFrame.fromPydict(
            {"name": cls, "f": [np.asarray(f, np.float32) for f in feats]})
        lr = pkg.LogisticRegression(
            maxIter=80, **({"device": "cpu"} if pkg is sdl else {}))
        model = pkg.Pipeline([
            pkg.StringIndexer(inputCol="name", outputCol="label"),
            pkg.VectorAssembler(inputCols=["f"], outputCol="features"),
            lr]).fit(df)
        rows = model.transform(df).collect()
        acc = np.mean([int(r["prediction"]) == r["label"] for r in rows])
        return ([r["label"] for r in rows], [list(r["features"])
                                             for r in rows]), acc
    (got, acc), (want, jacc) = body(sdl), body(jsdl)
    np.testing.assert_equal(got, want)
    assert acc >= 0.95 and jacc >= 0.95
