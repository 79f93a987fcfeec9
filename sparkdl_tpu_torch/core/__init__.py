"""Core pieces of the port: the ML Params system and Pipeline API
(``params``, ``pipeline``), the host ingest layer (``ingest``), the device
runtime — the scoring ``BatchRunner``, call signatures and the decode-step
graph runner (``runtime``) — and the Arrow DataFrame (``frame``, which
imports pyarrow and pandas, so it is not imported here:
``from sparkdl_tpu_torch.core.frame import DataFrame``). Model selection
(``tuning``) is not ported yet (ROADMAP.md, Queue A 4)."""


def __getattr__(name):
    if name in ("tuning", "CrossValidator", "TrainValidationSplit",
                "ParamGridBuilder"):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md, Queue A 4)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
