"""Shared utilities of the port (``Timer``: device-aware timing)."""

__all__ = ["Timer"]


def __getattr__(name):
    # Lazy: Timer is the flight recorder's span base (runner.events); an
    # eager import would load the runner package with every utility.
    if name == "Timer":
        from .timing import Timer
        return Timer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
