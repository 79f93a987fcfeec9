"""Wall-clock timing that waits for the device.

An alias: the timing primitive is the flight recorder's span base,
``sparkdl_tpu_torch.runner.events.Timer``, so there is one timing
implementation in the package. The import is lazy (module
``__getattr__``), so reaching ``utils`` never loads the runner package.
"""

from __future__ import annotations

__all__ = ["Timer"]


def __getattr__(name):
    if name == "Timer":
        from ..runner.events import Timer
        return Timer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
