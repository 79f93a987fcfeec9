"""The port's model selection (``sparkdl_tpu_torch.core.tuning``) and
evaluators (``sparkdl_tpu_torch.estimators.evaluation``) held against the
JAX package's: the twins of the nine tests of ``tests/test_tuning.py``.
Every case runs the same data through both packages. Evaluator metrics
are equal as floats; the ``CrossValidator``'s and
``TrainValidationSplit``'s metrics and chosen model are equal (the port's
``LogisticRegression`` runs on the CPU, ``device="cpu"``), beside the
reference test's own checks."""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import numpy as np
import pytest

import sparkdl_tpu as jsdl
import sparkdl_tpu_torch as sdl


def _toy_classification(pkg, n=120, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    w = np.array([2.0, -1.0, 0.5, 0.0], np.float32)
    y = (x @ w + 0.3 * rng.randn(n) > 0).astype(np.int64)
    return pkg.DataFrame.fromPydict(
        {"features": [r.tolist() for r in x], "label": y.tolist()},
        numPartitions=2)


def _lr(pkg, **kw):
    if pkg is sdl:
        kw["device"] = "cpu"
    return pkg.LogisticRegression(**kw)


def test_param_grid_builder():
    for pkg in (sdl, jsdl):
        lr = _lr(pkg)
        grid = (pkg.ParamGridBuilder()
                .addGrid(lr.maxIter, [5, 10])
                .addGrid(lr.stepSize, [0.1, 0.5])
                .build())
        assert [{p.name: v for p, v in g.items()} for g in grid] == [
            {"maxIter": 5, "stepSize": 0.1}, {"maxIter": 5, "stepSize": 0.5},
            {"maxIter": 10, "stepSize": 0.1},
            {"maxIter": 10, "stepSize": 0.5}]
        based = (pkg.ParamGridBuilder()
                 .baseOn({lr.maxIter: 7})
                 .addGrid(lr.stepSize, [0.1, 0.2]).build())
        assert all(g[lr.maxIter] == 7 for g in based)


def test_random_split():
    df, jdf = _toy_classification(sdl, 100), _toy_classification(jsdl, 100)
    a, b = df.randomSplit([0.7, 0.3], seed=1)
    ja, jb = jdf.randomSplit([0.7, 0.3], seed=1)
    assert a.count() + b.count() == 100
    assert 60 <= a.count() <= 80
    assert [r.label for r in a.collect()] == [r.label for r in ja.collect()]
    assert [r.label for r in b.collect()] == [r.label for r in jb.collect()]
    with pytest.raises(ValueError, match="positive"):
        df.randomSplit([0.5, -0.5])


def test_multiclass_evaluator_metrics():
    data = {"label": [0, 0, 1, 1, 2, 2], "prediction": [0, 1, 1, 1, 2, 0]}
    df, jdf = (p.DataFrame.fromPydict(data) for p in (sdl, jsdl))
    for metric in ("accuracy", "f1", "weightedPrecision", "weightedRecall"):
        got = sdl.MulticlassClassificationEvaluator(
            metricName=metric).evaluate(df)
        assert got == jsdl.MulticlassClassificationEvaluator(
            metricName=metric).evaluate(jdf), metric
    assert sdl.MulticlassClassificationEvaluator().evaluate(df) == \
        pytest.approx(4 / 6)
    with pytest.raises(ValueError, match="Unknown metricName"):
        sdl.MulticlassClassificationEvaluator(metricName="nope").evaluate(df)


def test_regression_evaluator_metrics():
    data = {"label": [1.0, 2.0, 3.0], "prediction": [1.0, 2.0, 5.0]}
    df, jdf = (p.DataFrame.fromPydict(data) for p in (sdl, jsdl))
    for metric in ("mae", "rmse", "mse", "r2"):
        ev, jev = (p.RegressionEvaluator(metricName=metric)
                   for p in (sdl, jsdl))
        assert ev.evaluate(df) == jev.evaluate(jdf), metric
        assert ev.isLargerBetter() == jev.isLargerBetter()
    assert sdl.RegressionEvaluator(metricName="mae").evaluate(df) == \
        pytest.approx(2 / 3)
    assert sdl.RegressionEvaluator(metricName="rmse").evaluate(df) == \
        pytest.approx(np.sqrt(4 / 3))
    assert sdl.RegressionEvaluator(metricName="r2").isLargerBetter()


def test_binary_evaluator_auc():
    for probs, want in (([0.1, 0.4, 0.35, 0.8], 0.75),
                        ([0.1, 0.2, 0.8, 0.9], 1.0)):
        data = {"label": [0, 0, 1, 1], "probability": probs}
        df, jdf = (p.DataFrame.fromPydict(data) for p in (sdl, jsdl))
        got = sdl.BinaryClassificationEvaluator().evaluate(df)
        assert got == jsdl.BinaryClassificationEvaluator().evaluate(jdf)
        assert got == pytest.approx(want)


def _cv(pkg, df, steps, folds=3, iters=30):
    lr = _lr(pkg, maxIter=iters)
    grid = pkg.ParamGridBuilder().addGrid(lr.stepSize, steps).build()
    return pkg.CrossValidator(
        estimator=lr, estimatorParamMaps=grid,
        evaluator=pkg.MulticlassClassificationEvaluator(),
        numFolds=folds).fit(df)


def test_cross_validator_selects_reasonable_model():
    """avgMetrics equal the reference's, so the same grid point wins; the
    refit model predicts every training row as the reference's does."""
    df, jdf = _toy_classification(sdl), _toy_classification(jsdl)
    model, ref = _cv(sdl, df, [0.001, 0.5]), _cv(jsdl, jdf, [0.001, 0.5])
    assert model.avgMetrics == ref.avgMetrics
    assert model.avgMetrics[1] > model.avgMetrics[0]
    assert [r.prediction for r in model.transform(df).collect()] == \
        [r.prediction for r in ref.transform(jdf).collect()]
    acc = sdl.MulticlassClassificationEvaluator().evaluate(
        model.transform(df))
    assert acc == jsdl.MulticlassClassificationEvaluator().evaluate(
        ref.transform(jdf))
    assert acc > 0.8


def test_cross_validator_validation():
    lr = _lr(sdl)
    with pytest.raises(ValueError, match="must be set"):
        sdl.CrossValidator(estimator=lr).fit(_toy_classification(sdl, 20))
    cv = sdl.CrossValidator(
        estimator=lr, estimatorParamMaps=[{}],
        evaluator=sdl.MulticlassClassificationEvaluator(), numFolds=1)
    with pytest.raises(ValueError, match="numFolds"):
        cv.fit(_toy_classification(sdl, 20))


def test_train_validation_split():
    out = []
    for pkg in (sdl, jsdl):
        lr = _lr(pkg, maxIter=30)
        grid = pkg.ParamGridBuilder().addGrid(lr.stepSize,
                                              [0.001, 0.5]).build()
        out.append(pkg.TrainValidationSplit(
            estimator=lr, estimatorParamMaps=grid,
            evaluator=pkg.MulticlassClassificationEvaluator(),
            trainRatio=0.75).fit(_toy_classification(pkg)))
    model, ref = out
    assert model.validationMetrics == ref.validationMetrics
    assert model.validationMetrics[1] > model.validationMetrics[0]
    with pytest.raises(ValueError, match="trainRatio"):
        lr = _lr(sdl)
        sdl.TrainValidationSplit(
            estimator=lr,
            estimatorParamMaps=sdl.ParamGridBuilder().addGrid(
                lr.stepSize, [0.1]).build(),
            evaluator=sdl.MulticlassClassificationEvaluator(),
            trainRatio=1.5).fit(_toy_classification(sdl))


def test_cross_validator_model_persistence(tmp_path):
    df = _toy_classification(sdl, 60)
    model = _cv(sdl, df, [0.3, 0.5], folds=2, iters=20)
    ref = _cv(jsdl, _toy_classification(jsdl, 60), [0.3, 0.5], folds=2,
              iters=20)
    assert model.avgMetrics == ref.avgMetrics
    p = str(tmp_path / "cvm")
    model.save(p)
    loaded = sdl.load(p)
    assert loaded.avgMetrics == model.avgMetrics
    a = [r.prediction for r in model.transform(df).collect()]
    b = [r.prediction for r in loaded.transform(df).collect()]
    assert a == b
