"""Shared utilities of the port: tree path helpers (``trees``) and
device-aware timing (``Timer``)."""

from .trees import flatten_with_paths, path_str, tree_size_bytes

__all__ = ["flatten_with_paths", "path_str", "tree_size_bytes", "Timer"]


def __getattr__(name):
    # Lazy: Timer is the flight recorder's span base (runner.events); an
    # eager import would load the runner package with every utility.
    if name == "Timer":
        from .timing import Timer
        return Timer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
