"""KerasImageFileEstimator — train a Keras model on an image-URI DataFrame.

The counterpart of ``sparkdl_tpu/estimators/keras_image_file_estimator.py``.
Reference: ``python/sparkdl/estimators/keras_image_file_estimator.py``:
``_getNumpyFeaturesAndLabels`` collected *all* image URIs onto one
host, materialized the full dataset there as numpy, and ran
``model.fit`` on it — a single-node bottleneck by design.

Here, as in the JAX package, the dataset is **streamed**: images decode
host-side per batch on a feeder thread (``background_iter``) while the
previous batch trains on the device, through the port's runner
(``XlaRunner(...).run(ctx.fit(..., mutable=True))``). Keras 3 runs on its
torch backend (``transformers/keras_utils.py``): the loss calls the
model's ``stateless_call(trainable, non_trainable, batch,
training=True)`` with the model's own trainable tensors, so gradients
reach them, and the new non-trainable values (BatchNorm statistics)
come back as the step's new model state. ``fitMultiple``
(hyperparameter parallelism) comes from the Estimator base class. The
stage computes on ``device`` (unset → the card; ``"cpu"`` must be asked
for).
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterator

import numpy as np
import torch

from ..core.params import (HasBatchSize, HasDevice, HasInputCol, HasLabelCol,
                           HasOutputCol, HasSeed, Param, Params,
                           TypeConverters, keyword_only)
from ..core.pipeline import Estimator
from ..transformers.keras_image import KerasImageFileTransformer
from ..transformers.payloads import PicklesCallableParams


class _KerasTrainModule(torch.nn.Module):
    """A Keras-on-torch model as the runner's mutable-step module: its
    trainable variables are the parameters the optimizer updates (the
    Keras model is a child module; its non-trainable variables do not
    require a gradient, so the optimizer factories leave them out), and
    each non-trainable variable's storage is a buffer here, into which
    the step copies the new value (``train_state.assign_buffers``)."""

    def __init__(self, model):
        super().__init__()
        self.keras_model = model
        self.trainable = [v.value for v in model.trainable_variables]
        self.names = []
        for i, v in enumerate(model.non_trainable_variables):
            self.names.append(f"non_trainable_{i}")
            self.register_buffer(self.names[-1], v.value.data,
                                 persistent=False)

    def non_trainable(self) -> list:
        return [getattr(self, n) for n in self.names]


class KerasImageFileEstimator(PicklesCallableParams, Estimator, HasInputCol,
                              HasOutputCol, HasLabelCol, HasBatchSize,
                              HasSeed, HasDevice):
    """Fits ``modelFile`` on (URI, label) rows; returns a
    :class:`KerasImageFileTransformer` bound to the trained weights."""

    modelFile = Param(Params, "modelFile",
                      "path to a saved Keras model (.keras/.h5) to fine-tune",
                      TypeConverters.toString)
    imageLoader = Param(Params, "imageLoader",
                        "callable uri -> float32 array (loads AND "
                        "preprocesses)", TypeConverters.toCallable)
    epochs = Param(Params, "epochs", "passes over the dataset",
                   TypeConverters.toInt)
    learningRate = Param(Params, "learningRate", "optimizer learning rate",
                         TypeConverters.toFloat)
    optimizer = Param(Params, "optimizer", "optimizer name, with optax's "
                      "defaults (adam|sgd|adamw|rmsprop)",
                      TypeConverters.toString)
    loss = Param(Params, "loss", "loss: sparse_categorical_crossentropy | "
                 "categorical_crossentropy | mse", TypeConverters.toString)
    dropLastBatch = Param(Params, "dropLastBatch",
                          "drop the trailing partial batch (keeps shapes "
                          "static; set False to pad-and-mask it)",
                          TypeConverters.toBoolean)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, labelCol=None,
                 modelFile=None, imageLoader=None, batchSize=None,
                 epochs=None, learningRate=None, optimizer=None, loss=None,
                 dropLastBatch=None, seed=None, device=None):
        super().__init__()
        self._setDefault(batchSize=32, epochs=1, learningRate=1e-3,
                         optimizer="adam",
                         loss="sparse_categorical_crossentropy",
                         dropLastBatch=False, seed=0, labelCol="label")
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol=None, outputCol=None, labelCol=None,
                  modelFile=None, imageLoader=None, batchSize=None,
                  epochs=None, learningRate=None, optimizer=None, loss=None,
                  dropLastBatch=None, seed=None, device=None):
        return self._set(**self._input_kwargs)

    # -- data plane --------------------------------------------------------

    def _batches(self, dataset, epochs: int) -> Iterator[dict]:
        """Stream (image, label, weight) batches; images decoded lazily per
        batch. The trailing partial batch is padded to the static batch size
        with zero-weight rows (or dropped when ``dropLastBatch``)."""
        in_col = self.getInputCol()
        label_col = self.getLabelCol()
        bs = self.getBatchSize()
        loader = self.getOrDefault(self.imageLoader)
        drop_last = self.getOrDefault(self.dropLastBatch)

        from ..transformers.keras_image import loadImageBatch

        for _ in range(epochs):
            for rb in dataset.iterBatches(bs):
                n = rb.num_rows
                if n == 0 or (drop_last and n < bs):
                    continue
                uris = rb.column(in_col).to_pylist()
                labels = np.asarray(rb.column(label_col).to_pylist())
                # thread-pool decode: every host core loads in parallel
                imgs = loadImageBatch(loader, uris).astype(np.float32)
                weight = np.ones((n,), np.float32)
                if n < bs:
                    pad = bs - n
                    imgs = np.concatenate(
                        [imgs, np.broadcast_to(imgs[:1],
                                               (pad,) + imgs.shape[1:])])
                    labels = np.concatenate(
                        [labels, np.broadcast_to(labels[:1],
                                                 (pad,) + labels.shape[1:])])
                    weight = np.concatenate([weight, np.zeros((pad,),
                                                              np.float32)])
                yield {"image": imgs, "label": labels, "weight": weight}

    # -- training ----------------------------------------------------------

    def _make_tx(self):
        from ..runner import train_state as TS
        lr = self.getOrDefault(self.learningRate)
        name = self.getOrDefault(self.optimizer).lower()
        makers = {"adam": TS.adam, "sgd": TS.sgd, "adamw": TS.adamw,
                  "rmsprop": TS.rmsprop}
        if name not in makers:
            raise ValueError(f"Unknown optimizer {name!r}; "
                             f"one of {sorted(makers)}")
        return makers[name](lr)

    def _make_loss(self, keras_model):
        """Weighted loss over keras ``stateless_call`` — the
        ``mutable=True`` step contract: ``(loss, aux, new_model_state)``,
        the new non-trainable values by buffer name."""
        import torch.nn.functional as F

        from ..transformers.keras_utils import _keras
        keras = _keras()
        name = self.getOrDefault(self.loss).lower()
        if name not in ("sparse_categorical_crossentropy",
                        "categorical_crossentropy", "mse"):
            raise ValueError(f"Unknown loss {name!r}")

        def per_example(y, logits):
            logits = logits.to(torch.float32)
            if name == "sparse_categorical_crossentropy":
                return F.cross_entropy(logits, y.to(torch.int64),
                                       reduction="none")
            if name == "categorical_crossentropy":
                return -(y.to(torch.float32)
                         * F.log_softmax(logits, -1)).sum(-1)
            d = logits - y.to(torch.float32)
            return d.reshape(d.shape[0], -1).mean(-1)

        def loss_fn(module: _KerasTrainModule, batch):
            x = batch["image"]
            with keras.device(str(x.device)):
                out, new_nt = keras_model.stateless_call(
                    module.trainable, module.non_trainable(), x,
                    training=True)
            le = per_example(batch["label"], out)
            w = batch["weight"]
            loss = (le * w).sum() / torch.clamp(w.sum(), min=1.0)
            return loss, {}, {n: t.detach()
                              for n, t in zip(module.names, new_nt)}

        return loss_fn

    def _fit(self, dataset) -> KerasImageFileTransformer:
        from ..core.runtime import background_iter
        from ..runner import XlaRunner
        from ..transformers.keras_utils import load_keras_model

        model_file = self.getOrDefault(self.modelFile)
        device = self.getDevice()
        model = load_keras_model(model_file, device=device)
        epochs = self.getOrDefault(self.epochs)
        bs = self.getBatchSize()
        n_rows = dataset.count()
        if n_rows == 0:
            raise ValueError("Cannot fit on an empty DataFrame")
        per_epoch = (n_rows // bs if self.getOrDefault(self.dropLastBatch)
                     else -(-n_rows // bs))
        num_steps = max(per_epoch, 1) * epochs
        tx = self._make_tx()
        module = _KerasTrainModule(model)

        # background_iter: batch k+1 decodes on a feeder thread while the
        # step runs batch k — the fit loop never blocks on decode. The
        # step updates the model's own variables in place.
        XlaRunner(np=1, device=device).run(lambda ctx: ctx.fit(
            loss_fn=self._make_loss(model), model=module, tx=tx,
            data=background_iter(self._batches(dataset, epochs), maxsize=2),
            num_steps=num_steps, mutable=True,
            log_every=max(num_steps // 4, 1)))

        # Persist the trained model — the returned transformer is
        # self-contained (reference semantics: the fitted transformer
        # carries the trained model).
        out_dir = tempfile.mkdtemp(prefix="sparkdl_keras_fit_")
        trained_path = os.path.join(out_dir, "trained.keras")
        model.save(trained_path)

        return KerasImageFileTransformer(
            inputCol=self.getInputCol(), outputCol=self.getOutputCol(),
            modelFile=trained_path,
            imageLoader=self.getOrDefault(self.imageLoader),
            batchSize=bs, **({"device": device} if device else {}))

    _pickled_params = ("imageLoader",)
