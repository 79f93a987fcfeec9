"""Core pieces of the port: the ML Params system and Pipeline API
(``params``, ``pipeline``), model selection (``tuning``:
``ParamGridBuilder``, ``CrossValidator``, ``TrainValidationSplit``), the
host ingest layer (``ingest``), the device runtime — the scoring
``BatchRunner``, call signatures and the decode-step graph runner
(``runtime``) — and the Arrow DataFrame (``frame``, which imports pyarrow
and pandas, so it is not imported here:
``from sparkdl_tpu_torch.core.frame import DataFrame``)."""

from .tuning import (CrossValidator, CrossValidatorModel, ParamGridBuilder,
                     TrainValidationSplit, TrainValidationSplitModel)

__all__ = ["ParamGridBuilder", "CrossValidator", "CrossValidatorModel",
           "TrainValidationSplit", "TrainValidationSplitModel"]
