"""DeepImageFeaturizer / DeepImagePredictor — named-model transformers.

The port's ``sparkdl_tpu/transformers/named_image.py``, the flagship
transfer-learning surface: ``DeepImageFeaturizer(modelName=...)`` emits the
model's bottleneck features for downstream shallow learners;
``DeepImagePredictor`` emits (optionally decoded) class predictions.

Model lookup in :mod:`sparkdl_tpu_torch.models.registry`; the weights are
an ``nn.Module``'s f32 state, drawn from ``seed`` (flax's default
distributions) unless ``weightsPath`` names a local file or
:meth:`setWeights` installs one (or the JAX package's variables, carried
by ``registry.load_flax_variables``). ``weightsPath`` reads what the
reference reads: a Keras-applications ``.h5``/``.hdf5`` (name-mapped by
``models.pretrained.load_pretrained``; ResNets then run the keras-v1
stride placement, ``stride_on_3x3=False``), a flax msgpack
``.msgpack`` (``registry.load_flax_msgpack``) or a safetensors file keyed
by flax path (``registry.load_safetensors``); any other path is the
port's own ``torch.save`` state dict. The device step is the runner's
cast → flip → resize → preprocess → model, on ``device`` (unset → the
card). ``computeDtype="bfloat16"`` serves a copy whose conv and dense
weights are cast to bf16 once (``models.pretrained.cast_float_leaves``);
``"float32"`` computes in f32 — on the card cuDNN then runs the
convolutions in TF32 whenever ``torch.backends.cudnn.allow_tf32`` is on
(PyTorch's default, which the port leaves to the caller).
"""

from __future__ import annotations

import copy
import os

from ..core.params import (HasSeed, Param, Params, TypeConverters,
                           keyword_only)
from ..models import registry as model_registry
from .xla_image import XlaImageTransformer

_WEIGHTS_FILE = "weights.pt"


class _NamedImageTransformer(XlaImageTransformer, HasSeed):
    """Shared machinery: resolve modelName → (module, apply fn)."""

    modelName = Param(Params, "modelName",
                      "named model from SUPPORTED_MODELS",
                      TypeConverters.toString)
    computeDtype = Param(Params, "computeDtype",
                         "activation dtype for the forward pass: float32 "
                         "(default; TF32 convolutions on the card when "
                         "cudnn.allow_tf32 is on) or bfloat16. Params stay "
                         "float32 either way.",
                         TypeConverters.toString)
    weightsPath = Param(Params, "weightsPath",
                        "local weights file: a Keras-applications .h5/.hdf5 "
                        "(name-mapped import; ResNets then run the keras v1 "
                        "stride placement), flax msgpack (.msgpack), "
                        "safetensors keyed by flax path (.safetensors), or "
                        "else a torch.save state dict. Random seeded init "
                        "when unset (nothing is downloaded)",
                        TypeConverters.toString)

    _features_only = True

    def __init__(self):
        super(XlaImageTransformer, self).__init__()
        self._setDefault(batchSize=32, channelOrder="RGB",
                         outputMode="vector", inputCol="image", seed=0,
                         computeDtype="float32")
        self._module = None

    def _compute_dtype(self):
        import torch
        # isSet/hasDefault dance: instances revived by MLWritable.load from
        # an older save bypass __init__ and may lack the default.
        name = (self.getOrDefault(self.computeDtype)
                if self.isSet("computeDtype")
                or self.hasDefault("computeDtype") else "float32")
        try:
            return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
        except KeyError:
            raise ValueError(
                f"computeDtype must be 'float32' or 'bfloat16', "
                f"got {name!r}") from None

    def getModelName(self) -> str:
        return self.getOrDefault(self.modelName)

    def _model(self) -> model_registry.NamedImageModel:
        return model_registry.get_model(self.getModelName())

    def _keras_semantics(self) -> bool:
        """True when the installed weights come from a Keras-applications
        ``.h5`` file, in which case ResNets must run the keras v1 stride
        placement (models/pretrained.py) for the weights to be faithful."""
        return (self.isDefined(self.weightsPath)
                and self.getOrDefault(self.weightsPath)
                        .endswith((".h5", ".hdf5")))

    def _build_kwargs(self) -> dict:
        if self._keras_semantics() \
                and self.getModelName().startswith("ResNet"):
            return {"stride_on_3x3": False}
        return {}

    def _load_module(self):
        """The f32 model on the CPU: seeded init, then ``weightsPath``."""
        # getattr: instances revived by MLWritable.load bypass __init__.
        if getattr(self, "_module", None) is None:
            m = self._model()
            module = m.build(seed=self.getOrDefault(self.seed),
                             **self._build_kwargs())
            if self.isDefined(self.weightsPath):
                path = self.getOrDefault(self.weightsPath)
                if path.endswith((".h5", ".hdf5", ".msgpack",
                                  ".safetensors")):
                    template = model_registry.state_dict_to_flax(
                        module.state_dict())
                    if path.endswith((".h5", ".hdf5")):
                        from ..models import pretrained
                        variables = pretrained.load_pretrained(
                            self.getModelName(), path, template=template)
                    elif path.endswith(".safetensors"):
                        variables = model_registry.load_safetensors(
                            template, path)
                    else:
                        variables = model_registry.load_flax_msgpack(
                            template, path)
                    model_registry.load_flax_variables(module, variables)
                else:
                    model_registry.load_weights(module, path)
            self._module = module
        return self._module

    def setWeights(self, weights):
        """Install weights: an ``nn.Module`` of this model, its state dict,
        or the JAX package's ``{"params", "batch_stats"}`` variables as
        numpy (carried by ``registry.load_flax_variables``). Every name
        and shape must match."""
        from torch import nn
        module = self._model().build(**self._build_kwargs())
        if isinstance(weights, nn.Module):
            weights = weights.state_dict()
        if "params" in weights:
            model_registry.load_flax_variables(module, weights)
        else:
            module.load_state_dict(weights, strict=True)
        self._module = module
        return self

    def _make_fn(self):
        import torch

        from ..models.pretrained import cast_float_leaves
        m = self._model()
        dt = self._compute_dtype()
        # The served copy: self._module stays f32 on the CPU for
        # setWeights/save fidelity. Under bf16 its conv/dense kernels are
        # cast once — the leaves each layer would cast at use anyway; BN
        # statistics and affine (1-D) stay f32 for the f32 normalisation.
        served = copy.deepcopy(self._load_module())
        served.dtype = dt
        if dt != torch.float32:
            served = cast_float_leaves(served, dt)
        served = served.to(self._torch_device())
        return m.apply_fn(served, features_only=self._features_only)

    def _runner_key(self) -> tuple:
        return (self.getBatchSize(), self.getModelName(),
                self._features_only, str(self._compute_dtype()),
                self.getDevice(), id(self._load_module()))

    def _get_runner(self):
        # Pin the static input size from the model registry: the runner's
        # prologue resizes every wire size to it.
        self._set(inputSize=self._model().input_size)
        return super()._get_runner()

    def _transform(self, dataset):
        self._set(inputSize=self._model().input_size)
        return super()._transform(dataset)

    def _save_payload(self, path: str):
        if getattr(self, "_module", None) is not None:
            model_registry.save_weights(self._module,
                                        os.path.join(path, _WEIGHTS_FILE))

    def _load_payload(self, path: str, meta: dict):
        self._module = None
        wpath = os.path.join(path, _WEIGHTS_FILE)
        if os.path.exists(wpath):
            module = self._model().build(seed=self.getOrDefault(self.seed),
                                         **self._build_kwargs())
            self._module = model_registry.load_weights(module, wpath)


class DeepImageFeaturizer(_NamedImageTransformer):
    """Bottleneck-feature extractor for transfer learning (BASELINE config 1:
    ``Pipeline([DeepImageFeaturizer(InceptionV3), LogisticRegression])``)."""

    _features_only = True

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, modelName=None,
                 batchSize=None, weightsPath=None, seed=None,
                 computeDtype=None, device=None):
        super().__init__()
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol=None, outputCol=None, modelName=None,
                  batchSize=None, weightsPath=None, seed=None,
                  computeDtype=None, device=None):
        return self._set(**self._input_kwargs)

    def featureDim(self) -> int:
        return self._model().feature_dim


class DeepImagePredictor(_NamedImageTransformer):
    """Full-model classifier. ``decodePredictions=True`` emits a struct column
    of top-K {class, label, score} like the reference's decoded output."""

    _features_only = False

    decodePredictions = Param(Params, "decodePredictions",
                              "emit top-K decoded predictions instead of "
                              "raw logits", TypeConverters.toBoolean)
    topK = Param(Params, "topK", "K for decoded predictions",
                 TypeConverters.toInt)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, modelName=None,
                 batchSize=None, weightsPath=None, seed=None,
                 decodePredictions=None, topK=None, computeDtype=None,
                 device=None):
        super().__init__()
        self._setDefault(decodePredictions=False, topK=5)
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, inputCol=None, outputCol=None, modelName=None,
                  batchSize=None, weightsPath=None, seed=None,
                  decodePredictions=None, topK=None, computeDtype=None,
                  device=None):
        return self._set(**self._input_kwargs)

    def _transform(self, dataset):
        out = super()._transform(dataset)
        if not self.getOrDefault(self.decodePredictions):
            return out
        import numpy as np
        import pyarrow as pa

        from ..core.frame import _length_preserving, _set_column
        from ..core.ingest import columnToNdarray
        out_col = self.getOutputCol()
        top = self.getOrDefault(self.topK)
        typ = pa.list_(pa.struct([("class", pa.int32()),
                                  ("label", pa.string()),
                                  ("score", pa.float32())]))

        def decode_op(batch: pa.RecordBatch) -> pa.RecordBatch:
            if batch.num_rows == 0:
                return _set_column(batch, out_col, pa.array([], type=typ))
            logits = columnToNdarray(batch.column(out_col), None,
                                     dtype=np.float32)
            decoded = model_registry.decodePredictions(logits, top=top)
            return _set_column(batch, out_col, pa.array(decoded, type=typ))

        return out.mapBatches(_length_preserving(decode_op))
