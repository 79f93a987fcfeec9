"""Estimators of the port: ``LogisticRegression`` (the shallow learner of
BASELINE config 1). The evaluators and ``KerasImageFileEstimator`` are not
ported yet (ROADMAP.md, Queue A 4 and A 9)."""

from .logistic_regression import LogisticRegression, LogisticRegressionModel

__all__ = ["LogisticRegression", "LogisticRegressionModel"]

_NOT_PORTED = {"MulticlassClassificationEvaluator": "A 4",
               "RegressionEvaluator": "A 4",
               "BinaryClassificationEvaluator": "A 4",
               "KerasImageFileEstimator": "A 9"}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md, Queue "
            f"{_NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
