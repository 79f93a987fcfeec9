"""Core pieces of the port: the ML Params system and Pipeline API
(``params``, ``pipeline``), model selection (``tuning``:
``ParamGridBuilder``, ``CrossValidator``, ``TrainValidationSplit``), the
host ingest layer (``ingest``), the device runtime — the scoring
``BatchRunner``, call signatures and the decode-step graph runner
(``runtime``) — and the Arrow DataFrame (``frame``, which imports pyarrow
and pandas, so ``DataFrame`` and ``Row`` load on first access)."""

from .params import (HasBatchSize, HasInputCol, HasLabelCol, HasOutputCol,
                     HasPredictionCol, HasSeed, Param, Params,
                     TypeConverters, keyword_only)
from .pipeline import (Estimator, Evaluator, MLWritable, Model, Pipeline,
                       PipelineModel, Transformer, load)
from .tuning import (CrossValidator, CrossValidatorModel, ParamGridBuilder,
                     TrainValidationSplit, TrainValidationSplitModel)

__all__ = ["Param", "Params", "TypeConverters", "keyword_only",
           "HasInputCol", "HasOutputCol", "HasLabelCol", "HasPredictionCol",
           "HasBatchSize", "HasSeed", "Transformer", "Estimator", "Model",
           "Evaluator", "Pipeline", "PipelineModel", "MLWritable", "load",
           "DataFrame", "Row", "ParamGridBuilder", "CrossValidator",
           "CrossValidatorModel", "TrainValidationSplit",
           "TrainValidationSplitModel"]


def __getattr__(name):
    if name in ("DataFrame", "Row"):
        from . import frame
        return getattr(frame, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
