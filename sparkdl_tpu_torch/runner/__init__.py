"""Runner toolkit of the port: the training loop for one process or a
data-parallel gang of processes, one device each (``xla_runner``:
``XlaRunner(np=, checkpoint_dir=).run(lambda ctx: ctx.fit(...))`` and
``run_with_restarts``, over ``train_state``, ``metrics``, checkpoints
(``checkpoint``) and the checkpointable data plane ``data``), the gang
launcher (``launcher.launch``, the ``mpirun`` role), the hvd-compat module
``api``, and the parts of ``sparkdl_tpu/runner`` the serving engine
reaches — the flight recorder (``events``), the metrics registry
(``telemetry``), the anomaly sentinel (``sentinel``) and fault injection
(``chaos``). The gang supervisor, the SLO monitor and the rest of the
telemetry plane come with the slices that port their callers
(ROADMAP.md)."""

from .checkpoint import CheckpointManager
from .launcher import GangFailure, launch
from .train_state import (TrainState, adam, bn_classifier_loss,
                          make_shard_map_step, make_train_step, sgd,
                          softmax_cross_entropy_loss)
from .xla_runner import RunnerContext, XlaRunner, current_context

__all__ = ["CheckpointManager", "GangFailure", "RunnerContext",
           "TrainState", "XlaRunner", "adam", "bn_classifier_loss",
           "current_context", "launch", "make_shard_map_step",
           "make_train_step", "sgd", "softmax_cross_entropy_loss"]
