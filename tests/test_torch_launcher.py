"""The port's gang launcher (``sparkdl_tpu_torch.runner.launcher``)
against the JAX package's: twins of ``tests/test_multiprocess.py``'s
launcher tests, driven by tiny scripts that import neither jax nor torch,
plus the spawn contract (the rendezvous env) and the launcher's imports.
Timing limits are the reference's: a dead rank is found in under 30 s
against a 120 s timeout. The supervisor's twins are in
``tests/test_torch_supervise.py``."""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import ast
import sys
import time
from pathlib import Path

import pytest

from sparkdl_tpu_torch.runner import launcher
from sparkdl_tpu_torch.runner.launcher import GangFailure


def test_launcher_propagates_failures(tmp_path):
    """Twin of ``test_multiprocess.py::test_launcher_propagates_failures``."""
    bad = tmp_path / "boom.py"
    bad.write_text("import sys; sys.exit(3)\n")
    with pytest.raises(RuntimeError, match="rank"):
        launcher.launch(str(bad), np=2, timeout_s=60.0, capture=True)


def test_launcher_rejects_bad_np():
    """Twin of ``test_multiprocess.py::test_launcher_rejects_bad_np``."""
    with pytest.raises(ValueError):
        launcher.launch("x.py", np=0)
    with pytest.raises(ValueError):
        launcher.supervise("x.py", np=0)


def test_dead_rank_detected_within_poll_not_timeout(tmp_path):
    """Twin of ``TestGangSupervision::test_dead_rank_detected_within_poll_
    not_timeout``: one rank dies while its peer sleeps as if on a
    collective; the poll loop kills the gang and raises within seconds,
    with the dead rank's stderr and the retryable verdict."""
    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['SPARKDL_PROCESS_ID'] == '1':\n"
        "    print('boom-rank-1', file=sys.stderr)\n"
        "    sys.exit(3)\n"
        "time.sleep(120)\n")
    t0 = time.monotonic()
    with pytest.raises(GangFailure) as ei:
        launcher.launch(str(script), np=2, timeout_s=120.0, capture=True,
                        poll_s=0.25)
    wall = time.monotonic() - t0
    assert wall < 30, f"detection took {wall:.1f}s (poll loop broken?)"
    assert "rank(s) [1]" in str(ei.value)
    assert "boom-rank-1" in str(ei.value)
    assert ei.value.kind == "retryable"
    assert ei.value.results[0].returncode != 0  # the sleeper was killed


def test_timeout_salvages_which_rank_stalled(tmp_path):
    """Twin of ``TestGangSupervision::test_timeout_salvages_which_rank_
    stalled``: the error names the rank still running and carries the
    finished rank's output."""
    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['SPARKDL_PROCESS_ID'] == '0':\n"
        "    print('rank0-finished-cleanly', file=sys.stderr)\n"
        "    sys.exit(0)\n"
        "time.sleep(120)\n")
    with pytest.raises(GangFailure) as ei:
        launcher.launch(str(script), np=2, timeout_s=4.0, capture=True,
                        poll_s=0.25)
    msg = str(ei.value)
    assert "rank(s) [1] still running" in msg
    assert "rank(s) [0] had exited" in msg
    assert "rank0-finished-cleanly" in msg
    assert ei.value.hung


def test_fatal_text_is_classified_fatal(tmp_path):
    """A rank dying on a program error (a ``ValueError`` traceback) is a
    fatal gang failure: restarting would repeat it."""
    script = tmp_path / "w.py"
    script.write_text("raise ValueError('np=2 exceeds visible devices')\n")
    with pytest.raises(GangFailure) as ei:
        launcher.launch(str(script), np=2, timeout_s=60.0, capture=True,
                        poll_s=0.25)
    assert ei.value.kind == "fatal"
    assert "exceeds visible devices" in str(ei.value)


def test_every_rank_gets_the_rendezvous_env(tmp_path):
    """Each rank sees ``SPARKDL_COORDINATOR`` (one address for the gang,
    the caller's when given), ``SPARKDL_NUM_PROCESSES`` and its own
    ``SPARKDL_PROCESS_ID``, the caller's ``env`` and its ``args``."""
    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys\n"
        "print(os.environ['SPARKDL_COORDINATOR'],"
        " os.environ['SPARKDL_NUM_PROCESSES'],"
        " os.environ['SPARKDL_PROCESS_ID'], os.environ['EXTRA'],"
        " sys.argv[1])\n")
    out = launcher.launch(str(script), np=3, args=["arg"],
                          env={"EXTRA": "x"}, timeout_s=60.0, capture=True,
                          poll_s=0.1)
    lines = [r.stdout.split() for r in out]
    assert {ln[0] for ln in lines} == {lines[0][0]}
    assert lines[0][0].startswith("127.0.0.1:")
    assert [ln[1:] for ln in lines] == [["3", str(r), "x", "arg"]
                                        for r in range(3)]
    out = launcher.launch(str(script), np=1, args=["a"], env={"EXTRA": "y"},
                          coordinator="127.0.0.1:4242", capture=True,
                          timeout_s=60.0)
    assert out[0].stdout.split() == ["127.0.0.1:4242", "1", "0", "y", "a"]


_SIBLINGS = {"events", "failures", "telemetry", "chaos", "data"}


def _imports(path: Path, top_level_only: bool = False) -> set:
    """The modules ``path`` imports (relative ones as ``.name``), at its
    top level or anywhere."""
    tree = ast.parse(path.read_text())
    nodes = tree.body if top_level_only else ast.walk(tree)
    names = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level and not node.module:  # "from . import events"
                names |= {"." + a.name for a in node.names}
            else:
                names.add("." * node.level + (node.module or ""))
    return names


def test_launcher_imports_no_cuda_code():
    """The launcher's own module imports the standard library and five
    sibling modules of the runner (``events``, ``failures``,
    ``telemetry``, ``chaos``, ``data``; ``metrics`` only lazily, inside
    a function), and none of those five imports torch at its top level:
    the parent of a gang never takes a card from its workers."""
    path = Path(launcher.__file__)
    names = _imports(path, top_level_only=True)
    stdlib = set(sys.stdlib_module_names)
    assert {n for n in names if not n.startswith(".")} <= stdlib | {
        "__future__"}, names
    assert {n[1:] for n in names if n.startswith(".")} == _SIBLINGS, names
    assert ".metrics" in _imports(path) - names  # the lazy counters
    for sib in sorted(_SIBLINGS):
        top = _imports(path.with_name(f"{sib}.py"), top_level_only=True)
        assert {n for n in top if not n.startswith(".")} <= stdlib | {
            "__future__"}, (sib, top)
        assert {n[1:] for n in top if n.startswith(".")} <= _SIBLINGS, (
            sib, top)
