"""Estimators of the port: ``LogisticRegression`` (the shallow learner of
BASELINE config 1), ``KerasImageFileEstimator`` (a Keras model trained
on an image-URI column, Keras on its torch backend) and the evaluators
of model selection (``evaluation``)."""

from .evaluation import (BinaryClassificationEvaluator,
                         MulticlassClassificationEvaluator,
                         RegressionEvaluator)
from .keras_image_file_estimator import KerasImageFileEstimator
from .logistic_regression import LogisticRegression, LogisticRegressionModel

__all__ = ["LogisticRegression", "LogisticRegressionModel",
           "KerasImageFileEstimator", "MulticlassClassificationEvaluator",
           "RegressionEvaluator", "BinaryClassificationEvaluator"]
