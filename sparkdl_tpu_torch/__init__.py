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
unpaged and paged, speculative verify, int8 / fp8 KV pool), the LoRA
fine-tune (``runner.XlaRunner(np=1).run(lambda ctx: ctx.fit(...))`` with
``models.llama.causal_lm_loss_fn`` and ``lora_optimizer``), the BERT GLUE
fine-tune (``models.bert``, ``fit(..., with_rng=True)`` for dropout), the
Arrow DataFrame (``DataFrame``, ``Row``; ``runner.data.ArrowDataset``) and
the token-column UDFs (``udf``: generation, text generation, sequence
classification), and image scoring — the image model zoo
(``models.registry``), ``core.runtime.BatchRunner``, the Params / Pipeline
API and ``Pipeline([DeepImageFeaturizer, LogisticRegression])`` — with the
kernels they run: ``ops.flash_attention``
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
from .core.pipeline import (Estimator, MLWritable, Model,  # noqa: E402
                            Pipeline, PipelineModel, Transformer, load)
from .estimators import (LogisticRegression,  # noqa: E402
                         LogisticRegressionModel)
from .image.imageIO import (createResizeImageUDF,  # noqa: E402
                            nhwcToImageColumn, readImages,
                            readImagesWithCustomFn)
from .serving import GenerationEngine  # noqa: E402 — as sparkdl_tpu does
from .transformers import (DeepImageFeaturizer,  # noqa: E402
                           DeepImagePredictor, TFImageTransformer,
                           XlaImageTransformer)
from .udf import (applyUDF, listUDFs, registerGenerationUDF,  # noqa: E402
                  registerSequenceClassificationUDF,
                  registerTextGenerationUDF, unregisterUDF)

__all__ = ["GenerationEngine", "DataFrame", "Row", "applyUDF", "listUDFs",
           "registerGenerationUDF", "registerSequenceClassificationUDF",
           "registerTextGenerationUDF", "unregisterUDF",
           "Param", "Params", "TypeConverters", "keyword_only",
           "HasInputCol", "HasOutputCol", "HasLabelCol", "HasPredictionCol",
           "HasBatchSize", "HasSeed", "HasDevice",
           "Transformer", "Estimator", "Model", "Pipeline", "PipelineModel",
           "MLWritable", "load", "imageSchema", "readImages",
           "readImagesWithCustomFn", "createResizeImageUDF",
           "nhwcToImageColumn", "XlaImageTransformer", "TFImageTransformer",
           "DeepImageFeaturizer", "DeepImagePredictor",
           "LogisticRegression", "LogisticRegressionModel"]


def __getattr__(name):
    if name in ("DataFrame", "Row"):
        from .core import frame
        return getattr(frame, name)
    if name == "imageSchema":
        from .image.imageIO import _image_schema
        return _image_schema()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
