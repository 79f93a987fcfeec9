"""LogisticRegression — the shallow learner closing the transfer-learning loop.

The port's ``sparkdl_tpu/estimators/logistic_regression.py``. BASELINE
config 1 is ``Pipeline([DeepImageFeaturizer, LogisticRegression])`` on the
featurizer's bottleneck vectors: full-batch softmax regression with an L2
term, on standardized features whose scaling is folded back into the
coefficients. The optimizer is Adam (``runner.train_state.adam``, optax's
update) run for ``maxIter`` full-batch steps on the estimator's ``device``
(unset → the card; ``"cpu"`` must be asked for). :meth:`LogisticRegression._fit_arrays`
is the array part, callable without a DataFrame; pyarrow is imported only
where Arrow data is read or built.
"""

from __future__ import annotations

import numpy as np

from ..core.params import (HasDevice, HasLabelCol, HasPredictionCol, Param,
                           Params, TypeConverters, keyword_only)
from ..core.pipeline import Estimator, Model


class _LRParams(Params):
    featuresCol = Param(Params, "featuresCol", "input feature-vector column",
                        TypeConverters.toString)
    maxIter = Param(Params, "maxIter", "training steps (full-batch)",
                    TypeConverters.toInt)
    stepSize = Param(Params, "stepSize", "learning rate",
                     TypeConverters.toFloat)
    regParam = Param(Params, "regParam", "L2 regularization",
                     TypeConverters.toFloat)
    probabilityCol = Param(Params, "probabilityCol",
                           "optional output column of class probabilities",
                           TypeConverters.toString)
    standardization = Param(Params, "standardization",
                            "standardize features before fitting (Spark MLlib "
                            "default; scaling is folded back into the coefs)",
                            TypeConverters.toBoolean)


class LogisticRegression(Estimator, _LRParams, HasLabelCol, HasPredictionCol,
                         HasDevice):
    @keyword_only
    def __init__(self, featuresCol=None, labelCol=None, predictionCol=None,
                 probabilityCol=None, maxIter=None, stepSize=None,
                 regParam=None, standardization=None, device=None):
        super().__init__()
        self._setDefault(featuresCol="features", labelCol="label",
                         predictionCol="prediction", maxIter=100,
                         stepSize=0.1, regParam=0.0, standardization=True)
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, featuresCol=None, labelCol=None, predictionCol=None,
                  probabilityCol=None, maxIter=None, stepSize=None,
                  regParam=None, standardization=None, device=None):
        return self._set(**self._input_kwargs)

    def _fit(self, dataset) -> "LogisticRegressionModel":
        from ..core.ingest import columnToNdarray
        feats_col = self.getOrDefault(self.featuresCol)
        label_col = self.getLabelCol()
        X_parts, y_parts = [], []
        for part in dataset.iterPartitions():
            if part.num_rows == 0:
                continue
            X_parts.append(columnToNdarray(part.column(feats_col), None))
            y_parts.append(np.asarray(part.column(label_col).to_pylist(),
                                      dtype=np.int32))
        if not X_parts:
            raise ValueError("Cannot fit LogisticRegression on an empty "
                             "DataFrame")
        return self._fit_arrays(np.concatenate(X_parts),
                                np.concatenate(y_parts))

    def _fit_arrays(self, X: np.ndarray, y: np.ndarray
                    ) -> "LogisticRegressionModel":
        """Fit on features ``X`` (N, d) and integer labels ``y`` (N,)."""
        import torch
        import torch.nn.functional as F

        from ..runner.train_state import adam
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y, dtype=np.int64)
        n_classes = int(y.max()) + 1
        if n_classes < 2:
            raise ValueError("Need at least 2 classes to fit")
        lr = self.getOrDefault(self.stepSize)
        reg = self.getOrDefault(self.regParam)
        steps = self.getOrDefault(self.maxIter)
        d = X.shape[1]
        dev = self._torch_device()

        if self.getOrDefault(self.standardization):
            mu = X.mean(axis=0)
            sigma = X.std(axis=0)
            sigma = np.where(sigma < 1e-8, 1.0, sigma).astype(np.float32)
        else:
            mu = np.zeros((d,), np.float32)
            sigma = np.ones((d,), np.float32)
        Xs = torch.from_numpy((X - mu) / sigma).to(dev)
        yt = torch.from_numpy(y).to(dev)

        head = torch.nn.Linear(d, n_classes, device=dev)
        with torch.no_grad():
            head.weight.zero_()
            head.bias.zero_()
        opt = adam(lr)(head)
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(head(Xs), yt)
            if reg:
                loss = loss + reg * (head.weight ** 2).sum()
            loss.backward()
            opt.step()
        w = head.weight.detach().t().cpu().numpy()
        b = head.bias.detach().cpu().numpy()
        # Fold the standardization back into the coefficients so the model
        # scores raw features: w' = w/sigma, b' = b - mu·(w/sigma).
        w = w / sigma[:, None]
        b = b - mu @ w
        return LogisticRegressionModel(
            weights=w, bias=b,
            featuresCol=self.getOrDefault(self.featuresCol),
            predictionCol=self.getPredictionCol(),
            probabilityCol=(self.getOrDefault(self.probabilityCol)
                            if self.isDefined(self.probabilityCol) else None),
            device=self.getDevice())


class LogisticRegressionModel(Model, _LRParams, HasLabelCol, HasPredictionCol,
                              HasDevice):
    def __init__(self, weights=None, bias=None, featuresCol="features",
                 predictionCol="prediction", probabilityCol=None,
                 device=None):
        super().__init__()
        self.weights = np.asarray(weights) if weights is not None else None
        self.bias = np.asarray(bias) if bias is not None else None
        self._set(featuresCol=featuresCol, predictionCol=predictionCol,
                  probabilityCol=probabilityCol)
        if device is not None:
            self._set(device=device)

    @property
    def numClasses(self) -> int:
        return int(self.weights.shape[1])

    def predict_arrays(self, X: np.ndarray):
        """``(predictions int32 (N,), probabilities f32 (N, K))`` for
        features ``X`` on the model's device."""
        import torch
        dev = self._torch_device()
        x = torch.from_numpy(np.asarray(X, dtype=np.float32)).to(dev)
        w = torch.from_numpy(np.asarray(self.weights, np.float32)).to(dev)
        b = torch.from_numpy(np.asarray(self.bias, np.float32)).to(dev)
        logits = x @ w + b
        pred = logits.argmax(-1).to(torch.int32)
        return pred.cpu().numpy(), torch.softmax(logits, -1).cpu().numpy()

    def _transform(self, dataset):
        import pyarrow as pa

        from ..core.frame import _length_preserving, _set_column
        from ..core.ingest import columnToNdarray
        feats_col = self.getOrDefault(self.featuresCol)
        pred_col = self.getPredictionCol()
        prob_col = (self.getOrDefault(self.probabilityCol)
                    if self.isDefined(self.probabilityCol) else None)

        def op(batch: pa.RecordBatch) -> pa.RecordBatch:
            x = columnToNdarray(batch.column(feats_col), None)
            pred, prob = self.predict_arrays(x)
            batch = _set_column(batch, pred_col, pa.array(pred))
            if prob_col:
                batch = _set_column(
                    batch, prob_col,
                    pa.array(prob.tolist(), type=pa.list_(pa.float32())))
            return batch

        return dataset.mapBatches(_length_preserving(op))

    def _save_payload(self, path: str):
        import os
        np.savez(os.path.join(path, "coef.npz"), w=self.weights, b=self.bias)

    def _load_payload(self, path: str, meta: dict):
        import os
        z = np.load(os.path.join(path, "coef.npz"))
        self.weights, self.bias = z["w"], z["b"]
