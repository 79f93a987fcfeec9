"""Horovod-style module API for migration (``import
sparkdl_tpu_torch.runner.api as hvd``).

The port's copy of ``sparkdl_tpu/runner/api.py``: scripts written against
``horovod.torch`` (``hvd.init(); hvd.rank(); hvd.size();
hvd.allreduce(x)``) port mechanically. Each call maps onto the current
:class:`~.xla_runner.RunnerContext` (the one ``XlaRunner.run`` is running,
or the one :func:`init` made). New code should use the context directly.

:func:`allreduce` and :func:`broadcast` are for values outside the train
step (metric aggregation, a seed): numpy arrays or scalars go in, numpy
comes out, and in a gang they run over the gang's host-side process
group. Gradients are averaged inside the step (``train_state``); both
consult the ``collective`` chaos site first.

The observability switches ride beside the hvd calls:
:func:`enable_flight_recorder` (``runner.events``) and
:func:`enable_telemetry` (``runner.telemetry.start``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import chaos, xla_runner
from .events import enable_flight_recorder  # noqa: F401
from .telemetry import start as enable_telemetry  # noqa: F401
from .xla_runner import RunnerContext, XlaRunner, current_context

__all__ = ["init", "size", "rank", "local_rank", "shutdown", "allreduce",
           "broadcast", "enable_flight_recorder", "enable_telemetry"]

_INIT_CONTEXTS: list[RunnerContext] = []  # made by init(), not by run()


def init(np: int = -1, **kwargs) -> RunnerContext:
    """hvd.init(): the current context; outside an ``XlaRunner.run``, a
    new ``XlaRunner(np, **kwargs)``'s (which joins the launcher's gang
    when the env names one), current until :func:`shutdown`."""
    ctx = current_context()
    if ctx is not None:
        return ctx
    ctx = XlaRunner(np=np, **kwargs).make_context()
    xla_runner._CURRENT_CONTEXT.append(ctx)
    _INIT_CONTEXTS.append(ctx)
    return ctx


def _ctx() -> RunnerContext:
    ctx = current_context()
    if ctx is None:
        raise RuntimeError("call runner.api.init() first (hvd.init analogue)")
    return ctx


def size() -> int:
    return _ctx().size


def rank() -> int:
    return _ctx().rank


def local_rank() -> int:
    """The rank on this host: a gang is one host's, so its rank."""
    return _ctx().rank


def shutdown() -> None:
    """hvd.shutdown(): drop the context :func:`init` made and leave the
    gang (its process group is destroyed); a later :func:`init` starts
    afresh."""
    while _INIT_CONTEXTS:
        ctx = _INIT_CONTEXTS.pop()
        if ctx in xla_runner._CURRENT_CONTEXT:
            xla_runner._CURRENT_CONTEXT.remove(ctx)
    xla_runner.leave_gang()


def _host_tensor(x) -> tuple[torch.Tensor, tuple]:
    a = np.array(x)  # a copy: the collective writes into it
    return torch.from_numpy(a.reshape(-1)), a.shape


def allreduce(x, average: bool = True) -> np.ndarray:
    """hvd.allreduce over the gang: the sum of every rank's ``x``, or
    its mean with ``average``. In one process the mean is ``x`` and the
    sum ``x·size`` (= ``x``)."""
    chaos.fire("collective")
    ctx = _ctx()
    t, shape = _host_tensor(x)
    if ctx.gang:
        dist.all_reduce(t, group=ctx.gang.host_group)
    out = t.numpy().reshape(shape)
    return out / ctx.size if average else out


def broadcast(x, root_rank: int = 0) -> np.ndarray:
    """hvd.broadcast: rank ``root_rank``'s ``x`` on every rank."""
    chaos.fire("collective")
    ctx = _ctx()
    t, shape = _host_tensor(x)
    if ctx.gang:
        dist.broadcast(t, src=root_rank, group=ctx.gang.host_group)
    return t.numpy().reshape(shape)
