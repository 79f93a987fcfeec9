"""Tree path helpers: nested dicts, lists and tuples of tensors or numpy
arrays, walked in a fixed order.

The counterpart of ``sparkdl_tpu/utils/trees.py``, which walks jax
pytrees. Here the tree is the plain containers themselves: a dict's keys
in sorted order (as jax orders them), a list's or tuple's items by index,
a namedtuple's fields by name; ``None`` is an empty subtree; anything
else is a leaf. Paths are spelled as the reference's ``path_str`` spells
them (``sparkdl_tpu/parallel/sharding.py:22``): the keys joined by
``"/"``, e.g. ``"params/dense/kernel"`` or ``"layers/0/w"``.
"""

from __future__ import annotations

import numpy as np


def path_str(path) -> str:
    """A key path (a sequence of dict keys, indices or field names) →
    its ``"/"``-joined spelling."""
    return "/".join(str(k) for k in path)


def _walk(tree, prefix: tuple):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), prefix + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _walk(item, prefix + (i,))
    else:
        yield prefix, tree


def flatten_with_paths(tree) -> list[tuple[str, object]]:
    """``[("a/b/c", leaf), ...]`` in a deterministic traversal order."""
    return [(path_str(path), leaf) for path, leaf in _walk(tree, ())]


def tree_size_bytes(tree) -> int:
    """Total bytes across the array leaves (tensors and numpy arrays;
    params / cache accounting). Leaves without a dtype count 0."""
    total = 0
    for _, leaf in _walk(tree, ()):
        if hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
        elif hasattr(leaf, "size") and hasattr(leaf, "dtype"):
            total += int(leaf.size) * np.dtype(leaf.dtype).itemsize
    return total
