"""Feed/fetch name hygiene for the graph toolkit.

A copy of ``sparkdl_tpu/graph/utils.py`` (standard library only).
Reference surface: ``python/sparkdl/graph/utils.py`` — ``tensor_name``/
``op_name`` normalized TF-1.x's dual naming ("op" vs "op:0" tensor output),
and ``validated_input``/``validated_output`` checked feeds/fetches against a
graph. There is no op/tensor split in a torch program, but the
":0"-suffixed names still appear in TF-era artifacts (SavedModel signatures,
user code written against the reference), so the same normalization functions
are kept and every GraphFunction accepts either spelling.
"""

from __future__ import annotations

import re

_VALID_NAME = re.compile(r"^[A-Za-z0-9_.][A-Za-z0-9_.\-/]*$")


def op_name(name: str) -> str:
    """"x:0" → "x"; "x" → "x". The canonical slot name used internally."""
    if not isinstance(name, str) or not name:
        raise TypeError(f"Invalid graph slot name: {name!r}")
    base = name.split(":")[0]
    if not _VALID_NAME.match(base):
        raise ValueError(f"Invalid graph slot name: {name!r}")
    return base


def tensor_name(name: str) -> str:
    """"x" → "x:0"; "x:1" stays. TF-style spelling for compat output."""
    base = op_name(name)
    idx = name.split(":")[1] if ":" in name else "0"
    if not idx.isdigit():
        raise ValueError(f"Invalid tensor index in {name!r}")
    return f"{base}:{idx}"


def validated_input(name: str, input_names) -> str:
    """Normalize + check a feed name against a GraphFunction's inputs."""
    base = op_name(name)
    if base not in input_names:
        raise ValueError(
            f"Feed {name!r} is not an input of this graph; inputs: "
            f"{list(input_names)}")
    return base


def validated_output(name: str, output_names) -> str:
    """Normalize + check a fetch name against a GraphFunction's outputs."""
    base = op_name(name)
    if base not in output_names:
        raise ValueError(
            f"Fetch {name!r} is not an output of this graph; outputs: "
            f"{list(output_names)}")
    return base
