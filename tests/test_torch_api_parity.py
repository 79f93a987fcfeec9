"""The port's public surface against the JAX package's, read without JAX.

- Every name in the ``__all__`` of each ``sparkdl_tpu`` package
  ``__init__`` (parsed with ``ast``, so nothing of the JAX package is
  imported) resolves on the port's counterpart package, as what it is in
  the reference: a submodule only where the reference's name is a
  submodule too.
- Every ``SPARKDL_*`` knob the reference's sources read (a string
  literal naming one) is read by the port's sources too.

A name or knob the port does not carry stands in :data:`EXCUSED_NAMES` or
:data:`EXCUSED_KNOBS` with the title of its ROADMAP.md Queue C 2 entry,
and that entry must exist. So "the port does all that the JAX package
does" is a test: a name or knob added to the reference without its port,
or a recorded difference without its record, fails here.
"""

import torch_threads  # noqa: F401  (PyTorch's threads: a worker's share)

import ast
import importlib
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF, PORT = REPO / "sparkdl_tpu", REPO / "sparkdl_tpu_torch"

#: (reference package, name) -> the title of its ROADMAP C 2 entry
EXCUSED_NAMES = {
    ("sparkdl_tpu.ops", "flash_attention"):
        "`ops.flash_attention` is the module",
}
#: knob -> the title of its ROADMAP C 2 entry
EXCUSED_KNOBS = {
    "SPARKDL_COMPILE_CACHE": "No compile cache for a relaunch",
    "SPARKDL_COMPILE_CACHE_MIN_S": "No compile cache for a relaunch",
    "SPARKDL_FLASH_BLOCK_Q": "The TPU's flash block sizes",
    "SPARKDL_FLASH_BLOCK_K": "The TPU's flash block sizes",
    "SPARKDL_TRANSFER_WORKERS": "The TPU feed's transfer threads and "
                                "staging buffers",
    "SPARKDL_STAGE_BUFFERS": "The TPU feed's transfer threads and "
                             "staging buffers",
    "SPARKDL_SERVE_TP_KERNEL": "Placement in torch's form",
}
_KNOB = re.compile(r"^SPARKDL_[A-Z0-9_]+$")


def _all_names(init: Path) -> list:
    names: list = []
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            names += ast.literal_eval(node.value)
        elif isinstance(node, ast.AugAssign) and \
                getattr(node.target, "id", None) == "__all__":
            names += ast.literal_eval(node.value)
    return names


def _packages() -> list:
    return sorted(p.parent for p in REF.rglob("__init__.py"))


def _dotted(pkg_dir: Path, root: str) -> str:
    return ".".join((root,) + pkg_dir.relative_to(REF).parts)


def _knobs(pkg: Path) -> set:
    out = set()
    for f in pkg.rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and _KNOB.match(node.value):
                out.add(node.value)
    return out


def _c2_section() -> str:
    text = (REPO / "ROADMAP.md").read_text()
    start = text.index("**C 2 — recorded differences")
    return text[start:text.index("**Reference caveat.**", start)]


@pytest.mark.parametrize("pkg_dir", _packages(),
                         ids=lambda p: _dotted(p, "sparkdl_tpu"))
def test_every_public_name_resolves_on_the_port(pkg_dir):
    ref_name = _dotted(pkg_dir, "sparkdl_tpu")
    names = _all_names(pkg_dir / "__init__.py")
    assert names, f"{ref_name} declares no __all__"
    port = importlib.import_module(_dotted(pkg_dir, "sparkdl_tpu_torch"))
    missing = []
    for name in names:
        if (ref_name, name) in EXCUSED_NAMES:
            continue
        try:
            obj = getattr(port, name)
        except AttributeError:
            missing.append(name)
            continue
        ref_is_module = (pkg_dir / f"{name}.py").exists() or \
            (pkg_dir / name / "__init__.py").exists()
        if type(obj).__name__ == "module" and not ref_is_module:
            missing.append(f"{name} (a module in the port)")
    assert not missing, f"{ref_name}: {missing}"


def test_every_excused_name_is_really_missing_and_recorded():
    """An excuse is kept only while it is needed, and names its C 2
    entry."""
    c2 = _c2_section()
    for (ref_name, name), title in EXCUSED_NAMES.items():
        assert name in _all_names(
            REF.joinpath(*ref_name.split(".")[1:], "__init__.py"))
        port = importlib.import_module(
            ref_name.replace("sparkdl_tpu", "sparkdl_tpu_torch", 1))
        assert type(getattr(port, name, None)).__name__ == "module" or \
            not hasattr(port, name), (ref_name, name)
        assert f"*{title}*" in c2, title


def test_every_knob_of_the_reference_is_read_by_the_port():
    ref, port = _knobs(REF), _knobs(PORT)
    assert "SPARKDL_MFU_ESTIMATE" in ref  # the scan sees the sources
    missing = sorted(ref - port - set(EXCUSED_KNOBS))
    assert not missing, missing
    c2 = _c2_section()
    for knob, title in EXCUSED_KNOBS.items():
        assert knob in ref and knob not in port, knob
        assert f"*{title}*" in c2, title
        assert knob in c2, knob


def test_lazy_and_aliased_names():
    """``core.DataFrame`` and ``Row`` load pyarrow on first access only
    (``tests/test_torch_llama.py::test_port_imports_without_pyarrow``
    imports the package with pyarrow blocked); ``HorovodRunner`` is
    ``XlaRunner``; the top level's ``flash_attention`` is the function."""
    import sparkdl_tpu_torch as s
    from sparkdl_tpu_torch import core, runner
    from sparkdl_tpu_torch.core import frame
    from sparkdl_tpu_torch.ops import flash_attention as fa

    assert core.DataFrame is frame.DataFrame and core.Row is frame.Row
    assert core.Pipeline is s.Pipeline
    assert runner.HorovodRunner is runner.XlaRunner is s.XlaRunner
    assert s.flash_attention is fa.flash_attention


class _Mesh:
    """What the shardings read of a ``DeviceMesh``: its axis names."""
    mesh_dim_names = ("data", "model")


def test_context_shardings_and_state_sharding():
    """``RunnerContext.data_sharding()`` splits over the data axis and
    ``replicated()`` over none (the reference's ``NamedSharding``s, with
    their ``DTensor`` placements); ``state_sharding`` is replicated by
    default and follows the rules given."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from sparkdl_tpu_torch.parallel.sharding import P, make_rules
    from sparkdl_tpu_torch.runner import (RunnerContext, TrainState, sgd,
                                          state_sharding)

    ctx = RunnerContext(device=torch.device("cpu"),
                        axes={"data": 1, "model": 1}, _mesh=_Mesh())
    ds, rep = ctx.data_sharding(), ctx.replicated()
    assert ds.spec == P("data") and rep.spec == P()
    assert ds.placements == [Shard(0), Replicate()]
    assert rep.placements == [Replicate(), Replicate()]
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Linear(8, 2))
    state = TrainState.create(model, sgd(0.1))
    sh = state_sharding(state, _Mesh())
    assert set(sh) == set(model.state_dict())
    assert all(s.spec == P() for s in sh.values())
    rules = make_rules([(r"^0/weight$", P("model", None))])
    sh = state_sharding(state, _Mesh(), rules)
    assert sh["0.weight"].spec == P("model", None)
    assert sh["0.weight"].placements == [Replicate(), Shard(0)]
    assert sh["1.weight"].spec == P()
