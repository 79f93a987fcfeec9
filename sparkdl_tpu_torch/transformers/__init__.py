"""Transformers of the port: ``XlaImageTransformer`` (a torch callable
over an image column; alias ``TFImageTransformer``), ``XlaTransformer``
(a torch callable over a numeric array column; aliases ``TFTransformer``
and ``TensorTransformer``), ``DeepImageFeaturizer`` and
``DeepImagePredictor``, and the feature stages (``feature``:
``VectorAssembler``, ``StringIndexer``, ``StandardScaler``,
``IndexToString``; pyarrow loads when they run, not at import).
``KerasTransformer``, ``KerasImageFileTransformer`` and
``defaultImageLoader`` are not ported yet (ROADMAP.md, Queue A 9); their
names raise ``NotImplementedError`` here."""

from .feature import (IndexToString, StandardScaler, StandardScalerModel,
                      StringIndexer, StringIndexerModel, VectorAssembler)
from .named_image import DeepImageFeaturizer, DeepImagePredictor
from .tensor import XlaTransformer
from .xla_image import XlaImageTransformer

# Reference-name aliases: the reference's TFImageTransformer and
# TFTransformer applied an arbitrary compute graph to an image column and
# to an array column.
TFImageTransformer = XlaImageTransformer
TFTransformer = XlaTransformer
TensorTransformer = XlaTransformer

__all__ = ["XlaImageTransformer", "TFImageTransformer",
           "XlaTransformer", "TFTransformer", "TensorTransformer",
           "DeepImageFeaturizer", "DeepImagePredictor",
           "VectorAssembler", "StringIndexer", "StringIndexerModel",
           "StandardScaler", "StandardScalerModel", "IndexToString"]

_NOT_PORTED = {"KerasTransformer": "A 9",
               "KerasImageFileTransformer": "A 9",
               "defaultImageLoader": "A 9"}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md, Queue "
            f"{_NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
