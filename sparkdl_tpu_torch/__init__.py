"""sparkdl_tpu_torch — the PyTorch / CUDA port of ``sparkdl_tpu``.

A second package beside the JAX one, for one NVIDIA Hopper card (H100,
``sm_90a``). Module names mirror the JAX package so each counterpart is
easy to find (``ops/flash_attention.py`` ↔ ``sparkdl_tpu/ops/
flash_attention.py``, ``models/llama.py`` ↔ ``sparkdl_tpu/models/
llama.py``). Every Pallas kernel the JAX package runs on the ported path
is a CUDA C++ kernel under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``); beside each one sits its plain PyTorch version, which
CPU tensors take.

This package imports ``torch`` and never ``jax``, ``flax`` or anything of
``sparkdl_tpu``. Importing it builds nothing and touches no device.

Ported so far: Llama generation (``models.llama.generate``), the
continuous-batching serving engine (``GenerationEngine.from_model``,
unpaged and paged, speculative verify, int8 / fp8 KV pool) and the
serving fleet over its replicas (``EngineFleet``, with the SLO burn
trackers and the telemetry plane's exporter and HTTP endpoint), the LoRA
fine-tune (``runner.XlaRunner(np=1).run(lambda ctx: ctx.fit(...))`` with
``models.llama.causal_lm_loss_fn`` and ``lora_optimizer``), the BERT GLUE
fine-tune (``models.bert``, ``fit(..., with_rng=True)`` for dropout), the
Arrow DataFrame (``DataFrame``, ``Row``; ``runner.data.ArrowDataset``) and
the UDFs (``udf``: ``registerUDF`` over numeric columns through
``XlaTransformer``, the image UDFs, generation, text generation, sequence
classification), image scoring — the image model zoo
(``models.registry``), ``core.runtime.BatchRunner``, the Params / Pipeline
API and ``Pipeline([DeepImageFeaturizer, LogisticRegression])`` — model
selection (``CrossValidator``, ``TrainValidationSplit`` and the
evaluators), the feature stages, the byte-level BPE tokenizer
(``ByteBPETokenizer``), int8 projection weights in serving
(``GenerationEngine.from_model(..., weight_dtype="int8")``), the
foreign-checkpoint importers (``load_pretrained``: HF Llama and BERT
safetensors, Keras-applications ``.h5``, flax msgpack and flax-path
safetensors) and the offline reports over a run's event dir
(``runner.analysis``, ``runner.traceview``), the graph toolkit over
``torch.export`` (``graph``: ``GraphFunction``, ``IsolatedSession``,
``XlaInputGraph``, ``makeGraphUDF``) and the Keras path on Keras's torch
backend (``KerasTransformer``, ``KerasImageFileTransformer``,
``KerasImageFileEstimator``, ``registerKerasImageUDF`` over a Keras
model or file), sequence parallelism over a ``torch.distributed`` gang
(``core.runtime.make_mesh``, ``parallel.ring_attention``,
``parallel.ulysses_attention``) and the sharding rules placed as
``DTensor``s (``parallel.shard_params``), with the kernels they run: ``ops.flash_attention``
(prefill, the training forward and its backward, causal or padded),
``ops.flash_decode`` (per-token decode) and ``ops.paged_flash_decode``
(block-table decode and verify). ROADMAP.md lists what is still to port.

``DataFrame`` and ``Row`` need pyarrow and pandas; they load on first
access, so ``import sparkdl_tpu_torch`` works without them.
"""

__version__ = "0.4.0"

from .core.params import (HasBatchSize, HasDevice, HasInputCol,  # noqa: E402
                          HasLabelCol, HasOutputCol, HasPredictionCol,
                          HasSeed, Param, Params, TypeConverters,
                          keyword_only)
from .core.pipeline import (Estimator, Evaluator, MLWritable,  # noqa: E402
                            Model, Pipeline, PipelineModel, Transformer,
                            load)
from .core.tuning import (CrossValidator,  # noqa: E402
                          CrossValidatorModel, ParamGridBuilder,
                          TrainValidationSplit, TrainValidationSplitModel)
from .estimators import (BinaryClassificationEvaluator,  # noqa: E402
                         KerasImageFileEstimator, LogisticRegression,
                         LogisticRegressionModel,
                         MulticlassClassificationEvaluator,
                         RegressionEvaluator)
from .graph import (GraphFunction, IsolatedGraph,  # noqa: E402
                    IsolatedSession, TFInputGraph, XlaInputGraph,
                    buildFlattener, buildSpImageConverter, makeGraphUDF)
from .image.imageIO import (createResizeImageUDF,  # noqa: E402
                            nhwcToImageColumn, readImages,
                            readImagesWithCustomFn)
from .models import ByteBPETokenizer, load_pretrained  # noqa: E402
from .serving import (DEAD, DEGRADED, DOOMED, HEALTHY,  # noqa: E402
                      EngineFleet, FleetDegradedError, FleetRequest,
                      FleetRoutingError, GenerationEngine,
                      RequestShedError, fleet_debug_state)
from .transformers import (DeepImageFeaturizer,  # noqa: E402
                           DeepImagePredictor, KerasImageFileTransformer,
                           KerasTransformer, TFImageTransformer,
                           TFTransformer, XlaImageTransformer,
                           XlaTransformer, defaultImageLoader)
from .transformers.feature import (IndexToString,  # noqa: E402
                                   StandardScaler, StandardScalerModel,
                                   StringIndexer, StringIndexerModel,
                                   VectorAssembler)
from .udf import (applyUDF, listUDFs, registerGenerationUDF,  # noqa: E402
                  registerImageUDF, registerKerasImageUDF,
                  registerSequenceClassificationUDF,
                  registerTextGenerationUDF, registerUDF, unregisterUDF)

__all__ = ["GenerationEngine", "EngineFleet", "FleetRequest",
           "FleetDegradedError", "RequestShedError", "FleetRoutingError",
           "HEALTHY", "DEGRADED", "DOOMED", "DEAD", "fleet_debug_state",
           "DataFrame", "Row", "applyUDF", "listUDFs",
           "registerUDF", "registerImageUDF", "registerKerasImageUDF",
           "registerGenerationUDF", "registerSequenceClassificationUDF",
           "registerTextGenerationUDF", "unregisterUDF",
           "Param", "Params", "TypeConverters", "keyword_only",
           "HasInputCol", "HasOutputCol", "HasLabelCol", "HasPredictionCol",
           "HasBatchSize", "HasSeed", "HasDevice",
           "Transformer", "Estimator", "Model", "Evaluator", "Pipeline",
           "PipelineModel", "MLWritable", "load", "ByteBPETokenizer",
           "load_pretrained",
           "ParamGridBuilder", "CrossValidator", "CrossValidatorModel",
           "TrainValidationSplit", "TrainValidationSplitModel",
           "MulticlassClassificationEvaluator", "RegressionEvaluator",
           "BinaryClassificationEvaluator", "VectorAssembler",
           "StringIndexer", "StringIndexerModel", "StandardScaler",
           "StandardScalerModel", "IndexToString", "imageSchema", "readImages",
           "readImagesWithCustomFn", "createResizeImageUDF",
           "nhwcToImageColumn", "XlaImageTransformer", "TFImageTransformer",
           "XlaTransformer", "TFTransformer",
           "DeepImageFeaturizer", "DeepImagePredictor",
           "LogisticRegression", "LogisticRegressionModel",
           "KerasTransformer", "KerasImageFileTransformer",
           "KerasImageFileEstimator", "defaultImageLoader",
           "GraphFunction", "IsolatedSession", "IsolatedGraph",
           "XlaInputGraph", "TFInputGraph", "buildSpImageConverter",
           "buildFlattener", "makeGraphUDF"]


def __getattr__(name):
    if name in ("DataFrame", "Row"):
        from .core import frame
        return getattr(frame, name)
    if name == "imageSchema":
        from .image.imageIO import _image_schema
        return _image_schema()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
