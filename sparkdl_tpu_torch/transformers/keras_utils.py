"""Keras-3-on-torch bridge: load a saved Keras model as a torch function.

The counterpart of ``sparkdl_tpu/transformers/keras_utils.py``, which runs
Keras 3 on its JAX backend. Here Keras 3 runs on its **torch** backend
(``KERAS_BACKEND=torch``), where a model is a ``torch.nn.Module`` whose
variables are torch tensors: ``stateless_call`` gives a pure
``(variables, x) → y`` over torch tensors, as it gives a jittable one on
jax.

Keras is imported inside :func:`_keras`, never when this module is. The
backend is fixed when keras is first imported, so :func:`_keras` checks
the environment before it imports: it sets ``KERAS_BACKEND=torch`` when
the variable is unset, and raises ``RuntimeError`` when the variable, or
an already imported ``keras``, names another backend (this package never
makes keras import jax).

Keras's torch backend places new tensors on ``cuda`` whenever a card is
present, so loading and calling run under ``keras.device(device)``:
every entry point computes on ``device`` (unset → the card; ``"cpu"``
must be asked for).
"""

from __future__ import annotations

import os
import sys


def _keras():
    backend = os.environ.get("KERAS_BACKEND")
    if backend is None:
        os.environ["KERAS_BACKEND"] = backend = "torch"
    loaded = sys.modules.get("keras")
    if loaded is not None:
        backend = loaded.backend.backend()
    if backend != "torch":
        raise RuntimeError(
            f"sparkdl_tpu_torch runs Keras on its torch backend; set "
            f"KERAS_BACKEND=torch before keras is imported (keras "
            f"{'is imported on' if loaded is not None else 'would import'}"
            f" the {backend!r} backend)")
    import keras
    return keras


def load_keras_model(model_file: str, device=None):
    """A saved ``.keras`` / ``.h5`` model, its variables on ``device``."""
    from ..utils.platform import resolve_device
    keras = _keras()
    with keras.device(str(resolve_device(device))):
        return keras.models.load_model(model_file, compile=False)


def keras_model_to_fn(model, device=None):
    """Keras model → torch ``fn(batch)`` closing over its weights
    (``stateless_call(trainable, non_trainable, batch, training=False)``,
    under ``keras.device(device)``)."""
    from ..utils.platform import resolve_device
    keras = _keras()
    name = str(resolve_device(device))
    trainable = [v.value for v in model.trainable_variables]
    non_trainable = [v.value for v in model.non_trainable_variables]

    def fn(batch):
        with keras.device(name):
            out, _ = model.stateless_call(trainable, non_trainable, batch,
                                          training=False)
        return out

    return fn


def keras_file_to_fn(model_file: str, device=None):
    return keras_model_to_fn(load_keras_model(model_file, device=device),
                             device=device)
