"""Sharding-rule helpers: pattern-matched PartitionSpecs over parameter
trees, placed as ``DTensor``s.

The counterpart of ``sparkdl_tpu/parallel/sharding.py``. A rule list maps
parameter-path patterns to :class:`P` specs (one mesh axis name, or None,
per tensor dim); :func:`shard_params` places each leaf with
``distribute_tensor`` on a named ``DeviceMesh`` (``core.runtime.
make_mesh``), ``Shard(i)`` on the mesh axis a spec names at dim i and
``Replicate()`` on the others.

Two layouts are matched. The reference's flax trees (``'layer0/q_proj/
kernel'``, Dense kernels ``[in, out]``) get the reference's specs. The
port's modules hold ``nn.Linear`` weights ``[out, in]`` under dotted
``state_dict`` names (``'layers.0.attn.q_proj.base.weight'``, read with
``'/'`` for ``'.'``), so every kernel rule has a ``weight`` twin with the
transposed spec (``q_proj/weight`` → ``P("model", None)``); embeddings
are ``[vocab, hidden]`` in both. A ``mesh`` argument that only sizes axes
(:func:`fsdp_rules`, :func:`divisible_rules`) may also be a ``{axis:
size}`` mapping.

:func:`head_sharded_kernel` runs a decode kernel on each tensor-parallel
rank's own heads (the reference's ``shard_map`` dispatch), and
:func:`serving_tp_layout` is the serving layout it serves.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping
from typing import Any, Callable, Sequence


class P(tuple):
    """PartitionSpec: one mesh axis name (a tuple of names, or None) per
    tensor dim, trailing dims replicated. ``str`` is the reference's."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


def path_str(path) -> str:
    """A key path (a tuple of keys, or one key) → the ``'/'``-joined string
    rules match, dotted ``state_dict`` names split at their dots
    (``('layers.0.attn', 'q_proj')`` → ``'layers/0/attn/q_proj'``)."""
    if isinstance(path, (str, int)):
        path = (path,)
    return "/".join(str(k).replace(".", "/") for k in path)


def _tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, Mapping):
        return {k: _tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _axis_size(mesh, name: str) -> int:
    if isinstance(mesh, Mapping):
        return int(mesh[name])
    return int(mesh.size(mesh.mesh_dim_names.index(name)))


def make_rules(patterns: Sequence[tuple[str, P]],
               default: P = P()) -> Callable[[tuple, Any], P]:
    """Build a ``rules(path, leaf) -> P`` fn from (regex, spec) pairs,
    first match wins. Regexes are ``re.search`` over the ``'/'``-joined
    parameter path (:func:`path_str`)."""
    compiled = [(re.compile(pat), spec) for pat, spec in patterns]

    def match_str(s: str, leaf) -> P:
        for rx, spec in compiled:
            if rx.search(s):
                # Drop trailing axes the leaf doesn't have (a bias matching
                # a kernel rule).
                nd = getattr(leaf, "ndim", None)
                if nd is not None and len(spec) > nd:
                    spec = P(*spec[:nd])
                return spec
        return default

    def rules(path, leaf) -> P:
        return match_str(path_str(path), leaf)

    rules.match_str = match_str
    return rules


def placements(spec: P, mesh) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(i)`` on
    each mesh axis the spec names at tensor dim i, ``Replicate()`` on the
    rest."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is None:
                continue
            if a not in names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                                 f"the mesh {tuple(names)}")
            out[names.index(a)] = Shard(dim)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``);
    :attr:`placements` is its ``DTensor`` spelling."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def shard_params(params: Any, mesh, rules: Callable) -> Any:
    """Place a parameter tree (nested dicts / lists of tensors or numpy
    arrays, e.g. a ``state_dict``) according to the rules: the same tree
    of ``DTensor``s on ``mesh``. Every rank must call it with the same
    tree; each leaf comes from rank 0's copy (``distribute_tensor``)."""
    import numpy as np
    import torch
    from torch.distributed.tensor import distribute_tensor

    def put(path, leaf):
        t = leaf if torch.is_tensor(leaf) else torch.as_tensor(
            np.asarray(leaf))
        t = t.detach().to(mesh.device_type)
        return distribute_tensor(t, mesh,
                                 placements(rules(path, leaf), mesh))

    return _tree_map_with_path(put, params)


def sharding_pytree(params: Any, mesh, rules: Callable) -> Any:
    """:class:`NamedSharding` tree of ``params``."""
    return _tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, rules(path, leaf)), params)


def describe(params: Any, rules: Callable) -> dict[str, str]:
    """path → spec string, for debugging/sharding audits."""
    out = {}

    def visit(path, leaf):
        out[path_str(path)] = str(rules(path, leaf))
        return leaf

    _tree_map_with_path(visit, params)
    return out


# ---------------------------------------------------------------------------
# Canonical transformer TP layouts (Megatron-style, mesh axis 'model')
# ---------------------------------------------------------------------------

_COLUMN = r"(q_proj|k_proj|v_proj|query|key|value)"
_ROW = r"(o_proj|out_proj|attention_output)"
_MLP_IN = r"(up_proj|gate_proj|intermediate|fc1|mlp_in)"
_MLP_OUT = r"(down_proj|output_dense|fc2|mlp_out)"


def transformer_tp_rules(model_axis: str = "model",
                         data_axis: str | None = None,
                         mesh=None) -> Callable:
    """Tensor-parallel rules for the transformer families in ``models/``:

    - attention q/k/v projections: shard the head (output) dim → each rank
      computes a head subset; the out-projection shards its *input* dim
      so the follow-up product contracts locally and one all-reduce
      restores the sum.
    - MLP: up-projection output-sharded, down-projection input-sharded.
    - embedding tables ``[vocab, hidden]``: hidden-dim sharded; lm_head
      is vocab-sharded.
    - everything else (norms, biases): replicated.

    Each kernel rule holds for the flax ``[in, out]`` ``kernel`` and, with
    the transposed spec, for the port's ``[out, in]`` ``weight``; int8
    scales (``kernel_scale`` / ``weight_scale``, per output channel)
    shard with the output dim of a column-parallel projection. With
    ``data_axis`` set, the rules extend to the 2-D FSDP×TP layout via
    :func:`fsdp_rules` (pass ``mesh`` so indivisible dims are skipped).
    """
    m = model_axis
    # (/base)? skips the LoRADense wrapper segment. The scale rules come
    # first: re.search lets '.../kernel' match inside '.../kernel_scale'.
    rules = make_rules([
        (_COLUMN + r"(/base)?/(kernel|weight)_scale", P(m)),
        (_ROW + r"(/base)?/(kernel|weight)_scale", P()),
        (_MLP_IN + r"(/base)?/(kernel|weight)_scale", P(m)),
        (_MLP_OUT + r"(/base)?/(kernel|weight)_scale", P()),
        (_COLUMN + r"(/base)?/kernel", P(None, m)),
        (_ROW + r"(/base)?/kernel", P(m, None)),
        (_MLP_IN + r"(/base)?/kernel", P(None, m)),
        (_MLP_OUT + r"(/base)?/kernel", P(m, None)),
        (_COLUMN + r"(/base)?/weight", P(m, None)),
        (_ROW + r"(/base)?/weight", P(None, m)),
        (_MLP_IN + r"(/base)?/weight", P(m, None)),
        (_MLP_OUT + r"(/base)?/weight", P(None, m)),
        (r"(embed_tokens|embedding|lm_head|word_embeddings)/"
         r"(embedding|kernel)", P(None, m)),
        (r"(embed_tokens|embedding|word_embeddings)/weight", P(None, m)),
        (r"lm_head/weight", P(m, None)),
    ])
    return fsdp_rules(rules, data_axis, mesh=mesh) if data_axis else rules


def fsdp_rules(base_rules: Callable | None = None,
               data_axis: str = "data",
               mesh=None) -> Callable:
    """ZeRO-3 / FSDP-style parameter sharding: every >=2-D leaf
    additionally shards its first base-unsharded dim over the DATA axis.
    1-D leaves (norm scales, biases) stay on the base layout.

    With ``mesh`` given, the data axis only lands on a dim that divides
    evenly by its extent; later free dims are tried in order, and a leaf
    with none keeps the base spec. Without ``mesh`` the first free dim is
    taken unchecked."""
    axis_size = _axis_size(mesh, data_axis) if mesh is not None else None

    def rules(path, leaf) -> P:
        base = base_rules(path, leaf) if base_rules is not None else P()
        ndim = getattr(leaf, "ndim", 0)
        # idempotent: a base already carrying data_axis gains no duplicate
        if ndim < 2 or data_axis in base:
            return base
        shape = getattr(leaf, "shape", None)
        spec = list(base) + [None] * (ndim - len(base))
        for i, s in enumerate(spec):
            if s is not None:
                continue
            if axis_size is not None and shape is not None \
                    and i < len(shape) and shape[i] % axis_size:
                continue  # uneven split: try a later free dim
            spec[i] = data_axis
            return P(*spec)
        return base  # no evenly-divisible free dim: keep the base layout

    # lora_rules derives adapter specs from the BASE matcher: adapters
    # inherit the TP layout and stay unsharded on the data axis
    rules.match_str = getattr(base_rules, "match_str", None)
    return rules


def divisible_rules(base_rules: Callable, mesh) -> Callable:
    """Wrap a rule fn so any spec axis that does not divide its leaf dim
    evenly is dropped (that dim replicated) instead of splitting
    unevenly — the policy :func:`fsdp_rules` applies to the data axis,
    for every axis of the spec."""
    def rules(path, leaf) -> P:
        spec = base_rules(path, leaf)
        shape = getattr(leaf, "shape", None)
        if shape is None or not any(spec):
            return spec
        out = []
        for i, ax in enumerate(spec):
            if ax is not None and (i >= len(shape)
                                   or shape[i] % _axis_size(mesh, ax)):
                ax = None  # uneven split: replicate this dim
            out.append(ax)
        return P(*out)

    rules.match_str = getattr(base_rules, "match_str", None)
    return rules


def local_heads(x, rank: int, tp: int, dim: int = 1):
    """Rank ``rank``'s block of ``x``'s heads (axis ``dim``) when ``tp``
    ranks split them evenly, contiguous: the shard ``Shard(dim)`` gives
    that rank. ``ValueError`` when the axis does not divide by ``tp``."""
    n = x.shape[dim]
    if tp < 1 or n % tp:
        raise ValueError(f"{n} heads on dim {dim} do not split evenly "
                         f"over tp={tp}")
    return x.narrow(dim, rank * (n // tp), n // tp).contiguous()


#: calls through :func:`head_sharded_kernel`'s wrappers, by the wrapped
#: function's name: one object each, whose ``launches`` count like the
#: kernel wrappers' (a captured step adds its count at every replay)
DISPATCH_COUNTERS: dict = {}


class _DispatchCount:
    def __init__(self, name: str):
        self.__name__ = f"head_sharded_{name}"
        self.launches = 0


def dispatch_counter(name: str) -> _DispatchCount:
    """The dispatch count of the wrapped function ``name``."""
    c = DISPATCH_COUNTERS.get(name)
    if c is None:
        c = DISPATCH_COUNTERS[name] = _DispatchCount(name)
    return c


def head_sharded_kernel(fn, mesh, axis: str = "tp"):
    """Run a decode kernel on each rank's own heads of the tensor-parallel
    head axis: the counterpart of the reference's ``shard_map`` over
    ``axis``. Per-head attention needs no collective, so every rank runs
    ``fn`` UNMODIFIED on its local shard.

    Operands follow the reference's rules: q, K and V (the first three)
    carry the heads on dim 1 (``[B, H, S, D]`` caches and ``[P, Hkv, bs,
    D]`` pools alike); a trailing 3-D operand whose leading two dims match
    K's is a quantized pool's ``[P, Hkv, 2]`` scale plane and shards with
    its heads; every other operand (tables, fill indices, pads) is
    replicated.

    Two kinds of input. ``DTensor`` q / K / V sharded ``Shard(1)`` on
    ``axis``: their local shards (``to_local``) go through ``fn``, a plain
    scale plane is cut to the rank's heads (:func:`local_heads`), a
    ``DTensor`` of any other operand gives its local tensor, and the
    output comes back a ``DTensor`` placed as q. Plain tensors are
    already the rank's local heads (the tensor-parallel serving model
    holds nothing else) and go through ``fn`` as they are.

    ``ValueError`` when the local head counts break the global Hq:Hkv
    ratio (a GQA group split across ranks). Every call adds one to
    ``dispatch_counter(fn.__name__).launches``."""
    counter = dispatch_counter(getattr(fn, "__name__", "kernel"))
    names = list(mesh.mesh_dim_names)
    if axis not in names:
        raise ValueError(f"axis {axis!r} is not an axis of the mesh "
                         f"{tuple(names)}")

    def wrapped(q, k, v, *rest, **kw):
        from torch.distributed.tensor import DTensor, Shard

        from ..ops import _build

        if isinstance(q, DTensor):
            for t in (q, k, v):
                if not isinstance(t, DTensor) or \
                        t.placements[names.index(axis)] != Shard(1):
                    raise ValueError(
                        f"head_sharded_kernel: q, K and V must all be "
                        f"DTensors sharded Shard(1) on {axis!r}")
            hq, hkv = q.shape[1], k.shape[1]
            tp = mesh.size(names.index(axis))
            rank = mesh.get_local_rank(axis)
            ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
            local = []
            for r in rest:
                if isinstance(r, DTensor):
                    r = r.to_local()
                elif getattr(r, "ndim", 0) == 3 and \
                        tuple(r.shape[:2]) == tuple(k.shape[:2]):
                    r = local_heads(r, rank, tp)
                local.append(r)
        else:
            hq, hkv = q.shape[1], k.shape[1]
            ql, kl, vl, local = q, k, v, list(rest)
        if kl.shape[1] == 0 or ql.shape[1] * hkv != kl.shape[1] * hq:
            raise ValueError(
                f"head_sharded_kernel: the local heads {ql.shape[1]}:"
                f"{kl.shape[1]} break the global Hq:Hkv ratio {hq}:{hkv} "
                f"(pick tp from the divisors of Hkv)")
        out = fn(ql, kl, vl, *local, **kw)
        _build.count_launch(counter)
        if not isinstance(q, DTensor):
            return out
        return DTensor.from_local(out, q.device_mesh, q.placements,
                                  run_check=False, shape=q.shape,
                                  stride=q.stride())

    wrapped.__name__ = wrapped.__qualname__ = counter.__name__
    wrapped.__wrapped__ = fn
    return wrapped


# ---------------------------------------------------------------------------
# Named layouts (SpecLayout) — serving tensor parallelism
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpecLayout:
    """A self-contained sharding layout: the param rules plus the specs
    for every non-param tensor a consumer must place (the serving
    backend's KV cache or paged pool, its replicated host vectors)."""

    rules: Callable          # param-path pattern rules (first match wins)
    kv_cache: P              # [B|pool, Hkv, S|bs, hd] K/V leaves
    replicated: P            # tokens / fill indices / tables / rng
    axis: str = "tp"         # the mesh axis the layout shards over
    degree: int = 1          # axis extent (1 = no sharding anywhere)


def serving_tp_layout(tp: int, cfg: Any = None, *,
                      axis: str = "tp") -> SpecLayout:
    """The serving-engine tensor-parallel layout (Megatron-style):
    attention q/k/v head-sharded with the KV cache's ``Hkv`` axis,
    o_proj row-sharded, MLP column-then-row.

    ``cfg`` (optional, any object with the ``LlamaConfig`` head fields)
    is validated up front: head-sharding is only exact when the KV-head
    and Q-head counts divide by ``tp``."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if cfg is not None and tp > 1:
        for field in ("num_kv_heads", "num_heads"):
            v = getattr(cfg, field, None)
            if v is not None and v % tp:
                raise ValueError(
                    f"{field}={v} is not divisible by tp={tp}: "
                    f"head-sharded serving needs an even head split "
                    f"(pick tp from the divisors of {field})")
    return SpecLayout(rules=transformer_tp_rules(model_axis=axis),
                      kv_cache=P(None, axis, None, None),
                      replicated=P(), axis=axis, degree=int(tp))


def lora_rules(base_rules: Callable, model_axis: str = "model") -> Callable:
    """LoRA adapter sharding consistent with the base layout: the A factor
    follows the base kernel's input partitioning, the B factor its output
    partitioning; the rank r stays replicated. Flax adapters are A ``[in,
    r]``, B ``[r, out]``; the port's are ``weight``s A ``[r, in]``, B
    ``[out, r]``, whose base weight is ``[out, in]``."""
    match = getattr(base_rules, "match_str", None)

    def rules(path, leaf) -> P:
        s = path_str(path)
        if match is not None and ("lora_a" in s or "lora_b" in s):
            # the spec the *base* kernel at this site would get
            base = match(s.replace("/lora_a", "").replace("/lora_b", ""),
                         None)
            first = base[0] if len(base) > 0 else None
            second = base[1] if len(base) > 1 else None
            if s.endswith("weight"):   # base [out, in]
                return P(None, second) if "lora_a" in s else P(first, None)
            if "lora_a" in s:          # base [in, out]
                return P(first, None)
            return P(None, second)
        return base_rules(path, leaf)

    return rules
