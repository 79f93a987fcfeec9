"""Concrete evaluators for tuning — the port's copy of
``sparkdl_tpu/estimators/evaluation.py`` (Spark ML ``pyspark.ml.evaluation``
surface — the metric side of the reference's param-grid workflows).
Metrics compute on-host over collected columns: evaluation is
O(rows), not a device-bound op."""

from __future__ import annotations

import numpy as np

from ..core.params import (HasLabelCol, HasPredictionCol, Param, Params,
                           TypeConverters, keyword_only)
from ..core.pipeline import Evaluator


def _col(dataset, name) -> np.ndarray:
    return np.asarray(
        [r[name] for r in dataset.select(name).collect()])


class MulticlassClassificationEvaluator(Evaluator, HasLabelCol,
                                        HasPredictionCol):
    metricName = Param(Params, "metricName",
                       "accuracy | f1 | weightedPrecision | weightedRecall",
                       TypeConverters.toString)

    @keyword_only
    def __init__(self, labelCol=None, predictionCol=None, metricName=None):
        super().__init__()
        self._setDefault(labelCol="label", predictionCol="prediction",
                         metricName="accuracy")
        self._set(labelCol=labelCol, predictionCol=predictionCol,
                  metricName=metricName)

    def _evaluate(self, dataset) -> float:
        y = _col(dataset, self.getLabelCol()).astype(np.int64)
        p = _col(dataset, self.getPredictionCol()).astype(np.int64)
        metric = self.getOrDefault(self.metricName)
        if metric == "accuracy":
            return float((y == p).mean())
        classes = np.unique(np.concatenate([y, p]))
        stats = []
        for c in classes:
            tp = float(((p == c) & (y == c)).sum())
            fp = float(((p == c) & (y != c)).sum())
            fn = float(((p != c) & (y == c)).sum())
            prec = tp / (tp + fp) if tp + fp else 0.0
            rec = tp / (tp + fn) if tp + fn else 0.0
            f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
            stats.append((float((y == c).mean()), prec, rec, f1))
        if metric == "weightedPrecision":
            return sum(w * s for w, s, _, _ in stats)
        if metric == "weightedRecall":
            return sum(w * s for w, _, s, _ in stats)
        if metric == "f1":
            return sum(w * s for w, _, _, s in stats)
        raise ValueError(f"Unknown metricName {metric!r}")


class RegressionEvaluator(Evaluator, HasLabelCol, HasPredictionCol):
    metricName = Param(Params, "metricName", "rmse | mse | mae | r2",
                       TypeConverters.toString)

    @keyword_only
    def __init__(self, labelCol=None, predictionCol=None, metricName=None):
        super().__init__()
        self._setDefault(labelCol="label", predictionCol="prediction",
                         metricName="rmse")
        self._set(labelCol=labelCol, predictionCol=predictionCol,
                  metricName=metricName)

    def _evaluate(self, dataset) -> float:
        y = _col(dataset, self.getLabelCol()).astype(np.float64)
        p = _col(dataset, self.getPredictionCol()).astype(np.float64)
        err = y - p
        metric = self.getOrDefault(self.metricName)
        if metric == "mse":
            return float((err ** 2).mean())
        if metric == "rmse":
            return float(np.sqrt((err ** 2).mean()))
        if metric == "mae":
            return float(np.abs(err).mean())
        if metric == "r2":
            ss_res = float((err ** 2).sum())
            ss_tot = float(((y - y.mean()) ** 2).sum())
            return 1.0 - ss_res / ss_tot if ss_tot else 0.0
        raise ValueError(f"Unknown metricName {metric!r}")

    def isLargerBetter(self) -> bool:
        return self.getOrDefault(self.metricName) == "r2"


class BinaryClassificationEvaluator(Evaluator, HasLabelCol):
    """areaUnderROC via the rank statistic (equivalent to the
    Mann-Whitney U), over a probability/score column."""

    rawPredictionCol = Param(Params, "rawPredictionCol",
                             "score/probability column",
                             TypeConverters.toString)
    metricName = Param(Params, "metricName", "areaUnderROC",
                       TypeConverters.toString)

    @keyword_only
    def __init__(self, labelCol=None, rawPredictionCol=None,
                 metricName=None):
        super().__init__()
        self._setDefault(labelCol="label", rawPredictionCol="probability",
                         metricName="areaUnderROC")
        self._set(labelCol=labelCol, rawPredictionCol=rawPredictionCol,
                  metricName=metricName)

    def _evaluate(self, dataset) -> float:
        if self.getOrDefault(self.metricName) != "areaUnderROC":
            raise ValueError("Only areaUnderROC is supported")
        y = _col(dataset, self.getLabelCol()).astype(np.int64)
        raw = _col(dataset,
                   self.getOrDefault(self.rawPredictionCol))
        # accept scalar scores or per-class probability vectors (take P[1])
        score = (raw[:, -1] if raw.ndim == 2 else raw).astype(np.float64)
        pos, neg = score[y == 1], score[y != 1]
        if len(pos) == 0 or len(neg) == 0:
            return 0.5
        # tie-averaged ranks, vectorized: O(n log n)
        uniq, inv, counts = np.unique(score, return_inverse=True,
                                      return_counts=True)
        ends = np.cumsum(counts)                       # rank after each tie
        starts = ends - counts + 1                     # rank before each tie
        ranks = ((starts + ends) / 2.0)[inv]
        u = ranks[y == 1].sum() - len(pos) * (len(pos) + 1) / 2
        return float(u / (len(pos) * len(neg)))
