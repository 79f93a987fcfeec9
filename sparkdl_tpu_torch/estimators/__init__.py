"""Estimators of the port: ``LogisticRegression`` (the shallow learner of
BASELINE config 1) and the evaluators of model selection
(``evaluation``). ``KerasImageFileEstimator`` is not ported yet
(ROADMAP.md, Queue A 9)."""

from .evaluation import (BinaryClassificationEvaluator,
                         MulticlassClassificationEvaluator,
                         RegressionEvaluator)
from .logistic_regression import LogisticRegression, LogisticRegressionModel

__all__ = ["LogisticRegression", "LogisticRegressionModel",
           "MulticlassClassificationEvaluator", "RegressionEvaluator",
           "BinaryClassificationEvaluator"]

_NOT_PORTED = {"KerasImageFileEstimator": "A 9"}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md, Queue "
            f"{_NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
