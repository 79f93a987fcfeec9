"""Runner toolkit of the port: the training loop for one process or a
data-parallel gang of processes, one device each (``xla_runner``:
``XlaRunner(np=, checkpoint_dir=).run(lambda ctx: ctx.fit(...))`` and
``run_with_restarts``, over ``train_state``, ``metrics``, checkpoints
(``checkpoint``) and the checkpointable data plane ``data`` with its
batch ledger), the gang launcher and supervisor (``launcher.launch``, the
``mpirun`` role, and ``launcher.supervise``: budgeted restarts, the
heartbeat watchdog, poison-batch quarantine, elastic resizing; a CLI in
``python -m sparkdl_tpu_torch.runner.launcher``), the hvd-compat module
``api``, the flight recorder (``events``: spans, crash postmortems, merged
timelines), the telemetry plane (``telemetry``: registry, stage
accountant, request traces, exporter and HTTP endpoint, the gang's
aggregated snapshots), the SLO burn-rate monitor (``slo``), the anomaly
sentinel (``sentinel``), fault injection (``chaos``), and the offline
readers of a run's event dir: bottleneck and request reports
(``analysis``) and the merged Chrome trace (``traceview``)."""

from . import analysis
from . import events
from . import telemetry
from . import traceview
from .chaos import Fault, FaultPlan, InjectedFatal, InjectedFault, \
    InjectedPreemption
from .checkpoint import CheckpointCorruptionError, CheckpointManager, \
    load_portable, save_portable
from .data import (ArrowDataset, CheckpointableDataset, FactoryDataset,
                   ListDataset, as_dataset)
from .events import FlightRecorder, Timer, enable_flight_recorder, \
    merge_timeline
from .failures import TrainingDivergedError, classify_exception, \
    exception_summary
from .launcher import GangFailure, SuperviseResult, launch, supervise
from .metrics import MetricsLogger, StepTimeStats, ThroughputMeter, \
    debug_mode, global_step_stats, peak_flops_per_chip, run_stats, \
    touch_heartbeat, trace
from .telemetry import start as enable_telemetry
from .train_state import (TrainState, adam, adamw, bn_classifier_loss,
                          make_shard_map_step, make_train_step, rmsprop,
                          sgd, softmax_cross_entropy_loss)
from .xla_runner import RunnerContext, XlaRunner, current_context

__all__ = ["CheckpointCorruptionError", "CheckpointManager",
           "CheckpointableDataset", "ArrowDataset", "FactoryDataset",
           "Fault", "FaultPlan", "FlightRecorder", "GangFailure",
           "InjectedFatal", "InjectedFault", "InjectedPreemption",
           "ListDataset", "MetricsLogger", "RunnerContext", "StepTimeStats",
           "SuperviseResult",
           "ThroughputMeter", "Timer", "TrainState",
           "TrainingDivergedError", "XlaRunner", "adam", "adamw", "analysis",
           "as_dataset",
           "bn_classifier_loss", "classify_exception", "current_context",
           "debug_mode", "enable_flight_recorder", "enable_telemetry",
           "events", "exception_summary", "global_step_stats", "launch",
           "load_portable", "make_shard_map_step", "make_train_step",
           "merge_timeline", "peak_flops_per_chip", "rmsprop", "run_stats",
           "save_portable", "sgd", "softmax_cross_entropy_loss",
           "supervise", "telemetry", "touch_heartbeat", "trace",
           "traceview"]
