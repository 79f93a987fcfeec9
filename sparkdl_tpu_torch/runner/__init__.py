"""Runner toolkit of the port: the training loop for one device
(``xla_runner``: ``XlaRunner(np=1, checkpoint_dir=).run(lambda ctx:
ctx.fit(...))`` and ``run_with_restarts``, over ``train_state``,
``metrics``, checkpoints (``checkpoint``) and the checkpointable data
plane ``data``) and the parts of ``sparkdl_tpu/runner`` the serving engine
reaches — the flight recorder (``events``), the metrics registry
(``telemetry``), the anomaly sentinel (``sentinel``) and fault injection
(``chaos``). The launcher, data parallelism, the SLO monitor and the rest
of the telemetry plane come with the slices that port their callers
(ROADMAP.md)."""

from .checkpoint import CheckpointManager
from .train_state import (TrainState, adam, bn_classifier_loss,
                          make_train_step, sgd, softmax_cross_entropy_loss)
from .xla_runner import RunnerContext, XlaRunner

__all__ = ["CheckpointManager", "RunnerContext", "TrainState", "XlaRunner",
           "adam", "bn_classifier_loss", "make_train_step", "sgd",
           "softmax_cross_entropy_loss"]
