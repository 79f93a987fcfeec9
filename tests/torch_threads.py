"""PyTorch's and numpy's CPU threads for the port's tests: one share of
the cores a pytest-xdist worker.

Every ``tests/test_torch_*.py`` imports this module first. xdist collects
every test module in every worker, so the setting holds in each worker
from collection on. Left alone, each of the N workers runs PyTorch's
intra-op pool and numpy's OpenBLAS pool at one thread a core, and N
workers oversubscribe the CPU N times over: a test then takes several
times its single-thread time.

Under pytest, this calls ``torch.set_num_threads(max(1, C // N))`` once,
C being the CPUs this process may run on (:func:`cores`) and N
``PYTEST_XDIST_WORKER_COUNT`` (1 when the run is serial, which keeps
every core), and limits numpy's BLAS pool to the same count where
``threadpoolctl`` is installed. It changes nothing where
``OMP_NUM_THREADS`` is set, and nothing in a process that is not pytest:
a gang worker that imports a test module, or inherits the worker's
environment, keeps the count its launcher gave it. It never calls
``torch.set_num_interop_threads``, which raises once any inter-op work
has run.

A test whose limit was measured at a given thread count runs its work
under :func:`fixed`: a CPU reduction splits its sum by the intra-op
thread count, so its rounding moves with the count.
"""

import contextlib
import os
import sys

import torch


def cores() -> int:
    """The CPUs this process may run on: its affinity mask where the
    platform has one (a cpuset may hold fewer than the host's), else
    ``os.cpu_count()``."""
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


def share() -> int:
    """The thread count of one worker: the cores over the workers, at
    least 1."""
    return max(1, cores()
               // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


def apply() -> int:
    """Set PyTorch's thread count, and numpy's BLAS pool, to
    :func:`share` where this process is pytest and ``OMP_NUM_THREADS`` is
    not set; return PyTorch's count in force."""
    if "pytest" in sys.modules and "OMP_NUM_THREADS" not in os.environ:
        n = share()
        torch.set_num_threads(n)
        try:
            import numpy  # noqa: F401  (loads the BLAS library to limit)
            from threadpoolctl import threadpool_limits
        except ImportError:  # the card's host has no threadpoolctl
            pass
        else:
            threadpool_limits(n, user_api="blas")
    return torch.get_num_threads()


@contextlib.contextmanager
def fixed(n: int):
    """Run the block at ``n`` intra-op threads, then restore the count."""
    was = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(was)


THREADS = apply()
