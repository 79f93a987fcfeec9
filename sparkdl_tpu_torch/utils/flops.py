"""The FLOPs a region of eager PyTorch does, its hand-written kernels
included: the port's counterpart of XLA's cost analysis, which the JAX
package's ``fit`` reads under ``SPARKDL_MFU_ESTIMATE``.

:func:`count_flops` is a context manager over
``torch.utils.flop_counter.FlopCounterMode``, which counts the aten ops
it sees from their shapes (2 FLOPs a multiply-add: matmuls, convolutions
and their backward; elementwise work, norms and reductions count 0)::

    with count_flops() as c:
        state, m = step(state, batch)
    c.total   # an int, set at exit

A kernel launched through ``ctypes`` is no aten op, so the mode does not
see it. Each kernel wrapper therefore runs its work inside
:func:`kernel_work`, which reports the kernel's own FLOPs from its
inputs to every active counter, and leaves out whatever aten FLOPs the
body ran: on the CPU the body is the kernel's plain version, whose
matmuls would otherwise count a second time. So one count holds on the
CPU and on the card. The mode's own per-op table keeps those plain
matmuls; only ``total`` leaves them out.

Counters are process-wide, not per thread: the autograd engine runs a
card's backward on a thread of its own. Work other threads do while a
counter is active counts too.
"""

from __future__ import annotations

import contextlib

_ACTIVE: list["FlopCount"] = []


class FlopCount:
    """One count; use :func:`count_flops`. ``total`` (an int) is set at
    exit: the aten FLOPs the mode counted, less those run inside
    :func:`kernel_work`, plus what the kernels reported there
    (``kernel_flops``)."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self.mode = FlopCounterMode(display=False)
        self.kernel_flops = 0
        self.total: int | None = None
        self._hidden = 0

    def __enter__(self) -> "FlopCount":
        self.mode.__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _ACTIVE.remove(self)
        self.mode.__exit__(*exc)
        self.total = (int(self.mode.get_total_flops()) - self._hidden
                      + self.kernel_flops)
        return False


def count_flops() -> FlopCount:
    """A context manager that counts the FLOPs of its body; see the
    module's docstring."""
    return FlopCount()


@contextlib.contextmanager
def _reported(flops):
    active = list(_ACTIVE)
    before = [c.mode.get_total_flops() for c in active]
    yield
    n = int(flops())  # inside the window: its own aten work is left out too
    for c, b in zip(active, before):
        c._hidden += int(c.mode.get_total_flops() - b)
        c.kernel_flops += n


def kernel_work(flops):
    """Around a kernel wrapper's work: when a counter is active, report
    ``flops()`` (a callable, so nothing is computed otherwise) as the
    kernel's FLOPs and leave out the aten FLOPs of the body. Nothing is
    reported when the body raises."""
    if not _ACTIVE:
        return contextlib.nullcontext()
    return _reported(flops)
