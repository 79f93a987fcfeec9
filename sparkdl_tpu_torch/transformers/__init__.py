"""Transformers of the port: ``XlaImageTransformer`` (a torch callable
over an image column; alias ``TFImageTransformer``), ``XlaTransformer``
(a torch callable over a numeric array column; aliases ``TFTransformer``
and ``TensorTransformer``), ``DeepImageFeaturizer`` and
``DeepImagePredictor``. ``KerasTransformer``,
``KerasImageFileTransformer`` and ``defaultImageLoader`` are not ported
yet (ROADMAP.md, Queue A 9), nor are the feature stages (``feature``,
Queue A 4); their names raise ``NotImplementedError`` here."""

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
           "DeepImageFeaturizer", "DeepImagePredictor"]

_NOT_PORTED = {"KerasTransformer": "A 9",
               "KerasImageFileTransformer": "A 9",
               "defaultImageLoader": "A 9", "feature": "A 4",
               "VectorAssembler": "A 4", "StandardScaler": "A 4",
               "StringIndexer": "A 4", "IndexToString": "A 4"}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md, Queue "
            f"{_NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
