"""``tests/torch_threads.py``, the helper that gives each pytest-xdist
worker its share of the cores for PyTorch's intra-op pool and numpy's
BLAS pool.

Each case imports the helper in a fresh interpreter, so this worker's own
counts are left as they are: one share of the cores a worker; every core
in a serial run; the launcher's count where ``OMP_NUM_THREADS`` is set;
the defaults in a process that is not pytest (a gang worker importing a
test module); and one thread where the process may run on one CPU
only. Then every ``tests/test_torch_*.py`` must import it, read with
``ast`` so that no test module is imported here.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
HAS_THREADPOOLCTL = importlib.util.find_spec("threadpoolctl") is not None
CHILD = ("import json, os, sys\n"
         "if sys.argv[1] == 'pytest':\n"
         "    import pytest\n"
         "if sys.argv[2] == 'one_cpu':\n"
         "    os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})\n"
         "import numpy, torch\n"
         "try:\n"
         "    from threadpoolctl import threadpool_info\n"
         "except ImportError:\n"
         "    threadpool_info = None\n"
         "def blas():\n"
         "    if threadpool_info is None:\n"
         "        return None\n"
         "    return sorted({p['num_threads'] for p in threadpool_info()\n"
         "                   if p['user_api'] == 'blas'})\n"
         "default, blas_default = torch.get_num_threads(), blas()\n"
         "import torch_threads\n"
         "print(json.dumps([default, torch.get_num_threads(),\n"
         "                  torch_threads.THREADS, torch_threads.cores(),\n"
         "                  blas_default, blas()]))\n")


def _child(env_extra: dict, as_pytest: bool = True,
           one_cpu: bool = False) -> tuple:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTEST_XDIST_WORKER_COUNT", "OMP_NUM_THREADS")}
    env.update(env_extra)
    env["PYTHONPATH"] = str(TESTS) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", CHILD, "pytest" if as_pytest else "plain",
         "one_cpu" if one_cpu else "every_cpu"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return tuple(json.loads(out.stdout.splitlines()[-1]))


def _blas(n: int):
    """The BLAS pool the helper leaves at ``n`` threads: ``[n]``, or
    None where threadpoolctl is missing and the pool is not read."""
    return [n] if HAS_THREADPOOLCTL else None


@pytest.mark.parametrize("case", ["six_workers", "serial", "omp_set",
                                  "not_pytest", "affinity"])
def test_helper_sets_one_share_of_the_cores_a_worker(case):
    """PyTorch's count, and numpy's BLAS pool (unless it was sized by
    ``OMP_NUM_THREADS``), as each case wants them; the cores are those
    the process may run on, not the host's."""
    if case == "six_workers":
        default, now, kept, cpus, _, blas = _child(
            {"PYTEST_XDIST_WORKER_COUNT": "6"})
        assert cpus == len(os.sched_getaffinity(0))
        assert now == kept == max(1, cpus // 6)
        assert blas == _blas(now)
    elif case == "serial":
        default, now, kept, cpus, _, blas = _child({})
        assert now == kept == cpus
        assert blas == _blas(cpus)
    elif case == "affinity":
        default, now, kept, cpus, _, blas = _child({}, one_cpu=True)
        assert now == kept == cpus == 1
        assert blas == _blas(1)
    elif case == "omp_set":
        default, now, kept, cpus, blas_default, blas = _child(
            {"PYTEST_XDIST_WORKER_COUNT": "6", "OMP_NUM_THREADS": "2"})
        assert default == now == kept == 2
        assert blas == blas_default
    else:
        default, now, kept, cpus, blas_default, blas = _child(
            {"PYTEST_XDIST_WORKER_COUNT": "6"}, as_pytest=False)
        assert now == kept == default
        assert blas == blas_default


def test_every_port_test_module_imports_the_helper():
    missing = []
    for f in sorted(TESTS.glob("test_torch_*.py")):
        names = {a.name for node in ast.parse(f.read_text()).body
                 if isinstance(node, ast.Import) for a in node.names}
        if "torch_threads" not in names:
            missing.append(f.name)
    assert missing == []
