"""Runner toolkit of the port: the training loop for one device
(``xla_runner``: ``XlaRunner(np=1).run(lambda ctx: ctx.fit(...))``, over
``train_state``, ``metrics`` and the checkpointable data plane ``data``)
and the parts of ``sparkdl_tpu/runner`` the serving engine reaches — the
flight recorder (``events``), the metrics registry (``telemetry``), the
anomaly sentinel (``sentinel``) and fault injection at the serving sites
(``chaos``). The launcher, checkpointing, data parallelism, the SLO
monitor and the rest of the telemetry plane come with the slices that
port their callers (ROADMAP.md)."""

from .train_state import TrainState
from .xla_runner import RunnerContext, XlaRunner

__all__ = ["RunnerContext", "TrainState", "XlaRunner"]
