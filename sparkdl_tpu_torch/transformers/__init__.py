"""Image transformers of the port: ``XlaImageTransformer`` (a torch
callable over an image column; alias ``TFImageTransformer``),
``DeepImageFeaturizer`` and ``DeepImagePredictor``. ``TensorTransformer`` /
``XlaTransformer``, ``KerasImageFileTransformer`` and the Keras
transformers are not ported yet (ROADMAP.md, Queue A 9), nor are the
feature stages (``feature``, Queue A 4); their names raise
``NotImplementedError`` here."""

from .named_image import DeepImageFeaturizer, DeepImagePredictor
from .xla_image import XlaImageTransformer

# Reference-name alias: the reference's TFImageTransformer applied an
# arbitrary compute graph to an image column.
TFImageTransformer = XlaImageTransformer

__all__ = ["XlaImageTransformer", "TFImageTransformer",
           "DeepImageFeaturizer", "DeepImagePredictor"]

_NOT_PORTED = {"XlaTransformer": "A 9", "TFTransformer": "A 9",
               "TensorTransformer": "A 9", "KerasTransformer": "A 9",
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
