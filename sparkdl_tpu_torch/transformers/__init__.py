"""Transformers of the port: ``XlaImageTransformer`` (a torch callable
over an image column; alias ``TFImageTransformer``), ``XlaTransformer``
(a torch callable over a numeric array column; aliases ``TFTransformer``
and ``TensorTransformer``), ``KerasTransformer`` and
``KerasImageFileTransformer`` (a saved Keras model on Keras's torch
backend over an array column and over an image-URI column, with
``defaultImageLoader``), ``DeepImageFeaturizer`` and
``DeepImagePredictor``, and the feature stages (``feature``:
``VectorAssembler``, ``StringIndexer``, ``StandardScaler``,
``IndexToString``; pyarrow loads when they run, keras when a Keras model
is loaded, not at import)."""

from .feature import (IndexToString, StandardScaler, StandardScalerModel,
                      StringIndexer, StringIndexerModel, VectorAssembler)
from .keras_image import KerasImageFileTransformer, defaultImageLoader
from .named_image import DeepImageFeaturizer, DeepImagePredictor
from .tensor import KerasTransformer, XlaTransformer
from .xla_image import XlaImageTransformer

# Reference-name aliases: the reference's TFImageTransformer and
# TFTransformer applied an arbitrary compute graph to an image column and
# to an array column.
TFImageTransformer = XlaImageTransformer
TFTransformer = XlaTransformer
TensorTransformer = XlaTransformer

__all__ = ["XlaImageTransformer", "TFImageTransformer",
           "XlaTransformer", "TFTransformer", "TensorTransformer",
           "KerasTransformer", "KerasImageFileTransformer",
           "defaultImageLoader",
           "DeepImageFeaturizer", "DeepImagePredictor",
           "VectorAssembler", "StringIndexer", "StringIndexerModel",
           "StandardScaler", "StandardScalerModel", "IndexToString"]
