"""Model selection: ParamGridBuilder, CrossValidator, TrainValidationSplit —
the port's copy of ``sparkdl_tpu/core/tuning.py`` (host code; ``_concat``
imports pyarrow only when a fold is assembled).

Reference surface: Spark ML's ``pyspark.ml.tuning`` — the tuning machinery
the reference's ``KerasImageFileEstimator.fitMultiple`` exists to serve
(SURVEY.md §2.1: "param-grid ready (`fitMultiple` for parallel
hyperparameter search)"). Grid points fan out through ``fitMultiple``, so
each trial is an independent device program and trials overlap host work with
device execution.
"""

from __future__ import annotations

import itertools
from typing import Any, Sequence

from .params import HasSeed, Param, Params
from .pipeline import Estimator, Evaluator, Model


class ParamGridBuilder:
    """Builds [{param: value}] grids (the Spark ML builder API)."""

    def __init__(self):
        self._grid: dict = {}

    def addGrid(self, param, values: Sequence[Any]) -> "ParamGridBuilder":
        self._grid[param] = list(values)
        return self

    def baseOn(self, *args) -> "ParamGridBuilder":
        pairs = args[0].items() if args and isinstance(args[0], dict) \
            else args
        for param, value in pairs:
            self.addGrid(param, [value])
        return self

    def build(self) -> list[dict]:
        keys = list(self._grid)
        return [dict(zip(keys, combo))
                for combo in itertools.product(
                    *[self._grid[k] for k in keys])]


class _ValidatorParams(HasSeed):
    estimator = Param(Params, "estimator", "estimator to tune")
    estimatorParamMaps = Param(Params, "estimatorParamMaps", "param grid")
    evaluator = Param(Params, "evaluator", "metric evaluator")

    def _check(self):
        for name in ("estimator", "estimatorParamMaps", "evaluator"):
            if not self.isSet(name):
                raise ValueError(f"{type(self).__name__}: {name} must be set")

    def _fit_and_score(self, train, val) -> list[float]:
        est: Estimator = self.getOrDefault(self.estimator)
        ev: Evaluator = self.getOrDefault(self.evaluator)
        maps = self.getOrDefault(self.estimatorParamMaps)
        scores = [0.0] * len(maps)
        for i, model in est.fitMultiple(train, list(maps)):
            scores[i] = float(ev.evaluate(model.transform(val)))
        return scores


class CrossValidator(Estimator, _ValidatorParams):
    """K-fold cross validation over a param grid; refits the best map on the
    full dataset."""

    numFolds = Param(Params, "numFolds", "number of folds")

    def __init__(self, estimator=None, estimatorParamMaps=None,
                 evaluator=None, numFolds=None, seed=None):
        super().__init__()
        self._setDefault(numFolds=3, seed=0)
        kw = {k: v for k, v in dict(
            estimator=estimator, estimatorParamMaps=estimatorParamMaps,
            evaluator=evaluator, numFolds=numFolds, seed=seed).items()
            if v is not None}
        self._set(**kw)

    def _fit(self, dataset):
        self._check()
        k = int(self.getOrDefault(self.numFolds))
        if k < 2:
            raise ValueError(f"numFolds must be >= 2, got {k}")
        folds = dataset.randomSplit([1.0] * k,
                                    seed=self.getSeed())
        maps = self.getOrDefault(self.estimatorParamMaps)
        ev: Evaluator = self.getOrDefault(self.evaluator)
        avg = [0.0] * len(maps)
        for held in range(k):
            train = _concat([f for i, f in enumerate(folds) if i != held])
            scores = self._fit_and_score(train, folds[held])
            avg = [a + s / k for a, s in zip(avg, scores)]
        best_idx = (max if ev.isLargerBetter() else min)(
            range(len(maps)), key=lambda i: avg[i])
        est: Estimator = self.getOrDefault(self.estimator)
        best = est.fit(dataset, dict(maps[best_idx]))
        return CrossValidatorModel(best, avgMetrics=avg)


class CrossValidatorModel(Model):
    def __init__(self, bestModel=None, avgMetrics=None):
        super().__init__()
        self.bestModel = bestModel
        self.avgMetrics = list(avgMetrics or [])

    def _transform(self, dataset):
        return self.bestModel.transform(dataset)

    def _save_payload(self, path: str):
        import json
        import os
        from .pipeline import _save_stages
        _save_stages(path, [self.bestModel])
        with open(os.path.join(path, "metrics.json"), "w") as f:
            json.dump(self.avgMetrics, f)

    def _load_payload(self, path: str, meta: dict):
        import json
        import os
        from .pipeline import _load_stages
        self.bestModel = _load_stages(path)[0]
        with open(os.path.join(path, "metrics.json")) as f:
            self.avgMetrics = json.load(f)


class TrainValidationSplit(Estimator, _ValidatorParams):
    """Single random train/validation split over a param grid."""

    trainRatio = Param(Params, "trainRatio", "fraction used for training")

    def __init__(self, estimator=None, estimatorParamMaps=None,
                 evaluator=None, trainRatio=None, seed=None):
        super().__init__()
        self._setDefault(trainRatio=0.75, seed=0)
        kw = {k: v for k, v in dict(
            estimator=estimator, estimatorParamMaps=estimatorParamMaps,
            evaluator=evaluator, trainRatio=trainRatio, seed=seed).items()
            if v is not None}
        self._set(**kw)

    def _fit(self, dataset):
        self._check()
        ratio = float(self.getOrDefault(self.trainRatio))
        if not 0.0 < ratio < 1.0:
            raise ValueError(f"trainRatio must be in (0, 1), got {ratio}")
        train, val = dataset.randomSplit(
            [ratio, 1.0 - ratio], seed=self.getSeed())
        maps = self.getOrDefault(self.estimatorParamMaps)
        ev: Evaluator = self.getOrDefault(self.evaluator)
        scores = self._fit_and_score(train, val)
        best_idx = (max if ev.isLargerBetter() else min)(
            range(len(maps)), key=lambda i: scores[i])
        est: Estimator = self.getOrDefault(self.estimator)
        best = est.fit(dataset, dict(maps[best_idx]))
        return TrainValidationSplitModel(best, validationMetrics=scores)


class TrainValidationSplitModel(CrossValidatorModel):
    def __init__(self, bestModel=None, validationMetrics=None):
        Model.__init__(self)
        self.bestModel = bestModel
        self.avgMetrics = list(validationMetrics or [])

    @property
    def validationMetrics(self):
        return self.avgMetrics


def _concat(dfs):
    import pyarrow as pa
    from .frame import DataFrame
    tables = [d.toArrow() for d in dfs]
    return DataFrame.fromArrow(pa.concat_tables(tables),
                               numPartitions=len(dfs))
