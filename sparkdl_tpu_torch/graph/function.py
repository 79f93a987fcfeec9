"""GraphFunction — the portable unit of compute.

The counterpart of ``sparkdl_tpu/graph/function.py``. Reference surface:
``python/sparkdl/graph/builder.py``'s ``GraphFunction`` — a serialized TF
GraphDef plus input/output tensor names, buildable from Keras models or by
chaining pieces (``fromList``), spliced into sessions with
``importGraphFunction``.

Here the portable artifact is a **torch.export program**: a
``GraphFunction`` is a torch function with *named* feeds and fetches
(``fn`` maps ``{input_name: tensor}`` to ``{output_name: tensor}``,
weights closed over), which:

- runs on its ``device`` (unset → the card; ``"cpu"`` must be asked for):
  numpy or tensor feeds are moved there, fetches stay tensors;
- composes before any call (``fromList`` chains fetches → feeds
  positionally, the reference's piece-chaining semantic; ``then``,
  ``rename``, ``as_single_output_fn``);
- runs its compiled form through :meth:`jit`: one captured step per
  feed-shape signature (``core.runtime.CompileCache.get``, a CUDA graph
  on the card), where the reference jitted one XLA program;
- serializes to bytes (``serialize``/``deserialize``, ``dump``/``load``)
  with ``torch.export`` and a symbolic leading batch dimension, the
  analogue of the reference's ``jax.export`` StableHLO payloads. Each
  package refuses the other's blob (``ValueError``).

The reference's ``fromJax`` is :meth:`GraphFunction.fromTorch` and its
``fromFlax(module, variables)`` is :meth:`GraphFunction.fromModule`
(``module`` holds its weights; the keyword arguments go to its forward).
"""

from __future__ import annotations

import io
import json
import os
import re
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from .utils import op_name, validated_output

_MAGIC = b"SPARKDL-TORCH-GFN1"
# The JAX package's magic (sparkdl_tpu/graph/function.py): its payload is
# jax.export StableHLO, which this package cannot run.
_JAX_MAGIC = b"SPARKDL-TPU-GFN1"

# Example sizes for the dimensions a spec leaves free. torch.export
# specialises an example dimension of size 0 or 1, so the batch is traced
# at 2, and every other free dimension at its own size from 3 up (equal
# example sizes would let the tracer take two dimensions for one).
_EXAMPLE_BATCH = 2
_EXAMPLE_FREE = 3


def _to_device(value, device: torch.device) -> torch.Tensor:
    """A feed → a tensor on ``device``. numpy float64 feeds become float32,
    as the reference's jax arrays (x64 off) make them; tensors keep their
    dtype."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    a = np.asarray(value)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a).to(device)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


class GraphFunction:
    """A named-feeds/named-fetches torch function on one device.

    ``fn`` maps a dict ``{input_name: tensor}`` to a dict ``{output_name:
    tensor}``; the tensors it is handed lie on ``device`` (unset → the
    card, which raises without one; ``"cpu"`` must be asked for).
    ``input_specs`` ``{name: (shape with None for free dims, dtype)}`` is
    needed only to serialize."""

    def __init__(self, fn: Callable[[dict], dict],
                 input_names: Sequence[str], output_names: Sequence[str],
                 input_specs: Mapping[str, tuple] | None = None,
                 device=None):
        from ..utils.platform import resolve_device
        self.fn = fn
        self.input_names = [op_name(n) for n in input_names]
        self.output_names = [op_name(n) for n in output_names]
        self.input_specs = dict(input_specs) if input_specs else None
        self.device = resolve_device(device)
        self._graphs = None

    # -- execution ---------------------------------------------------------

    def __call__(self, feeds: Mapping[str, object] | None = None, **kw):
        named = self._normalize_feeds(feeds, kw)
        with torch.no_grad():
            fetches = self.fn(named)
        return {op_name(k): v for k, v in fetches.items()}

    def jit(self) -> Callable:
        """The compiled entry point: dict feeds → dict fetches, one
        captured step per feed-shape signature, kept in this function's
        own ``core.runtime.CompileCache`` (on the card a CUDA graph
        replayed with the feeds copied into its input buffers; on the CPU
        the same buffers feed an eager call). ``fn`` must then make no
        host sync. The fetches are copies, valid after the next call."""
        if self._graphs is None:
            from ..core.runtime import CompileCache
            self._graphs = CompileCache()
        graphs, fn = self._graphs, self.fn
        inputs, outputs = self.input_names, self.output_names
        normalize = self._normalize_feeds
        name = f"GraphFunction:{id(self):x}"

        def positional(*args):
            res = fn(dict(zip(inputs, args)))
            return tuple(res[n] for n in outputs)

        def call(feeds=None, **kw):
            named = normalize(feeds, kw)
            args = [named[n] for n in inputs]
            key = tuple((tuple(t.shape), str(t.dtype)) for t in args)
            with torch.no_grad():
                out = graphs.get(name, key, positional, args)
                return {n: t.clone() for n, t in zip(outputs, out)}

        return call

    def as_single_output_fn(self, fetch: str | None = None) -> Callable:
        """batch → tensor adapter for single-input/single-output use (the
        shape the transformer/UDF layer consumes)."""
        if len(self.input_names) != 1:
            raise ValueError(
                f"as_single_output_fn needs exactly one input, have "
                f"{self.input_names}")
        out = (validated_output(fetch, self.output_names) if fetch
               else self.output_names[-1])
        name = self.input_names[0]
        fn = self.fn
        return lambda batch: fn({name: batch})[out]

    def _normalize_feeds(self, feeds, kw) -> dict:
        merged = dict(feeds or {})
        merged.update(kw)
        named = {op_name(k): v for k, v in merged.items()}
        missing = [n for n in self.input_names if n not in named]
        if missing:
            raise ValueError(f"Missing feeds {missing}; expected "
                             f"{self.input_names}")
        extra = [n for n in named if n not in self.input_names]
        if extra:
            raise ValueError(f"Unknown feeds {extra}; expected "
                             f"{self.input_names}")
        return {n: _to_device(v, self.device) for n, v in named.items()}

    # -- construction ------------------------------------------------------

    @classmethod
    def fromTorch(cls, fn: Callable, input_names: Sequence[str] | None = None,
                  output_names: Sequence[str] | None = None,
                  input_specs: Mapping[str, tuple] | None = None,
                  device=None) -> "GraphFunction":
        """Wrap a torch function taking positional tensors (one per input
        name) and returning a tensor, a tuple of tensors or a dict of
        tensors (the reference's ``fromJax``)."""
        from ..utils.platform import resolve_device
        device = resolve_device(device)
        inputs = [op_name(n) for n in (input_names or ["input"])]
        declared = [op_name(n) for n in output_names] if output_names else None

        def wrapped(feeds: dict) -> dict:
            out = fn(*[feeds[n] for n in inputs])
            return _name_outputs(out, declared)

        outputs = declared or _probe_output_names(fn, inputs, input_specs,
                                                  device)
        return cls(wrapped, inputs, outputs, input_specs, device=device)

    @classmethod
    def fromKeras(cls, model_or_file, input_name: str = "input",
                  output_name: str = "output",
                  device=None) -> "GraphFunction":
        """A Keras-3 model (torch backend) or saved .keras/.h5 file → one
        GraphFunction (weights captured). A file is loaded on ``device``;
        a model object computes where its variables lie, which must be
        ``device``. Reference: GraphFunction.fromKeras exported
        K.get_session()'s graph. Keras's input checks make the batch
        dimension a constant under ``torch.export``, so a Keras graph does
        not serialize with a free batch (``serialize`` raises; ROADMAP.md
        C 2)."""
        from ..transformers.keras_utils import (keras_model_to_fn,
                                                load_keras_model)
        from ..utils.platform import resolve_device
        device = resolve_device(device)
        model = (load_keras_model(model_or_file, device=device)
                 if isinstance(model_or_file, (str, os.PathLike))
                 else model_or_file)
        fn = keras_model_to_fn(model, device=device)
        spec = None
        try:
            shape = tuple(model.inputs[0].shape)
            spec = {op_name(input_name): (shape, "float32")}
        except Exception:
            pass
        return cls.fromTorch(fn, [input_name], [output_name], spec,
                             device=device)

    @classmethod
    def fromModule(cls, module: torch.nn.Module, input_name: str = "input",
                   output_name: str = "output", device=None,
                   **forward_kwargs) -> "GraphFunction":
        """A ``torch.nn.Module`` (holding its weights) → GraphFunction
        computing ``module(batch, **forward_kwargs)`` (the reference's
        ``fromFlax(module, variables, **apply_kwargs)``). The module's
        parameters and buffers must lie on ``device``; it is neither moved
        nor switched to eval mode here."""
        from ..utils.platform import resolve_device
        device = resolve_device(device)
        where = {t.device for t in (*module.parameters(), *module.buffers())}
        if any(d.type != device.type or (
                device.index is not None and d.index != device.index)
               for d in where):
            raise ValueError(
                f"fromModule: the module's tensors lie on "
                f"{sorted(map(str, where))}, the GraphFunction computes "
                f"on {device}; build the module there or pass device=")

        def fn(batch):
            return module(batch, **forward_kwargs)
        return cls.fromTorch(fn, [input_name], [output_name], device=device)

    @classmethod
    def fromList(cls, functions: Sequence["GraphFunction"]) -> "GraphFunction":
        """Chain pieces: stage i's fetches feed stage i+1's feeds
        positionally (the reference's piece-composition contract). The
        composite exposes the first stage's feeds and last stage's fetches
        and computes on their device (every stage's)."""
        if not functions:
            raise ValueError("fromList needs at least one GraphFunction")
        for a, b in zip(functions, functions[1:]):
            if len(a.output_names) != len(b.input_names):
                raise ValueError(
                    f"Cannot chain: stage with outputs {a.output_names} into "
                    f"stage with inputs {b.input_names} (arity mismatch)")
        devices = {str(g.device) for g in functions}
        if len(devices) > 1:
            raise ValueError(f"Cannot chain stages on different devices "
                             f"{sorted(devices)}")
        stages = list(functions)

        def chained(feeds: dict) -> dict:
            values = feeds
            for i, g in enumerate(stages):
                if i > 0:
                    prev = stages[i - 1]
                    values = {bn: values[an] for an, bn in
                              zip(prev.output_names, g.input_names)}
                values = g.fn(values)
                values = {op_name(k): v for k, v in values.items()}
            return values

        return cls(chained, stages[0].input_names, stages[-1].output_names,
                   stages[0].input_specs, device=stages[0].device)

    def then(self, other: "GraphFunction") -> "GraphFunction":
        return GraphFunction.fromList([self, other])

    def rename(self, inputs: Mapping[str, str] | None = None,
               outputs: Mapping[str, str] | None = None) -> "GraphFunction":
        imap = {op_name(k): op_name(v) for k, v in (inputs or {}).items()}
        omap = {op_name(k): op_name(v) for k, v in (outputs or {}).items()}
        new_in = [imap.get(n, n) for n in self.input_names]
        new_out = [omap.get(n, n) for n in self.output_names]
        inv_in = dict(zip(new_in, self.input_names))
        fn = self.fn

        def renamed(feeds: dict) -> dict:
            out = fn({inv_in[k]: v for k, v in feeds.items()})
            return {omap.get(op_name(k), op_name(k)): v
                    for k, v in out.items()}

        specs = ({imap.get(k, k): v for k, v in self.input_specs.items()}
                 if self.input_specs else None)
        return GraphFunction(renamed, new_in, new_out, specs,
                             device=self.device)

    # -- serialization (torch.export) --------------------------------------

    def serialize(self, input_specs: Mapping[str, tuple] | None = None
                  ) -> bytes:
        """→ portable bytes: a json header (names/specs) + the
        ``torch.export.save`` payload of the program on this function's
        device.

        ``input_specs``: {name: (shape, dtype)}; every leading ``None``
        becomes one shared symbolic batch dimension (``torch.export.Dim``)
        so any batch size can be fed at load time, and every other
        ``None`` a dimension of its own; where the exporter bounds one
        from above (a CUDA library that takes at most 65535 rows), the
        program takes sizes up to that bound (``max_sizes`` in the
        header). Falls back to specs captured at construction. Raises ``ValueError`` when the program cannot be
        exported as specified: a free dimension the function makes a
        constant (a Keras-on-torch model does this to its batch), or a
        call into one of this package's CUDA kernels (``ctypes`` calls,
        which ``torch.export`` cannot trace)."""
        from torch.export import Dim

        specs = dict(input_specs or self.input_specs or {})
        missing = [n for n in self.input_names if n not in specs]
        if missing:
            raise ValueError(
                f"serialize needs input_specs for {missing} "
                f"(shape, dtype per input)")

        # One shared Dim for every leading None (batch — inputs batch
        # together); a distinct Dim per other free dim.
        dims: dict = {}
        examples: dict = {}
        axes: dict = {}
        for n in self.input_names:
            shape, dtype = specs[n]
            sizes, free = [], {}
            for axis, d in enumerate(shape):
                if d is None:
                    key = "batch" if axis == 0 else (n, axis)
                    if key not in dims:
                        size = (_EXAMPLE_BATCH if key == "batch" else
                                _EXAMPLE_FREE + sum(k != "batch"
                                                    for k in dims))
                        dims[key] = (f"d{len(dims) + 1}", size)
                    free[axis] = dims[key][0]
                    sizes.append(dims[key][1])
                else:
                    sizes.append(int(d))
            examples[n] = torch.zeros(sizes, dtype=_torch_dtype(dtype),
                                      device=self.device)
            axes[n] = free

        program = _Program(self.fn, self.output_names)
        caps: dict = {}
        for attempt in range(2):
            made = {name: Dim(name, min=1, **({"max": caps[name]}
                                              if name in caps else {}))
                    for name, _ in dims.values()}
            dynamic = {n: {a: made[d] for a, d in free.items()} or None
                       for n, free in axes.items()}
            try:
                with torch.no_grad():
                    exported = torch.export.export(
                        program, (examples,), dynamic_shapes=(dynamic,))
                break
            except Exception as e:
                # The exporter may bound a free dimension from above (a
                # CUDA library takes at most 65535 rows on one grid axis):
                # take the bounds it suggests, once, when every one still
                # admits a size of 1; anything else is an error.
                caps = {} if attempt else _upper_bounds(e)
                if not caps:
                    raise _export_error(e, specs) from e
        header = json.dumps({
            "inputs": self.input_names, "outputs": self.output_names,
            "specs": {n: [list(specs[n][0]), _dtype_name(specs[n][1])]
                      for n in self.input_names},
            "device": str(self.device), "max_sizes": caps,
        }).encode()
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        return (_MAGIC + len(header).to_bytes(8, "little") + header
                + buf.getvalue())

    @classmethod
    def deserialize(cls, data: bytes, device=None) -> "GraphFunction":
        """A :meth:`serialize` blob → GraphFunction on ``device`` (unset →
        the card); the program's weights are moved there when it was
        exported on another device."""
        from ..utils.platform import resolve_device
        if data[:len(_JAX_MAGIC)] == _JAX_MAGIC:
            raise ValueError(
                "This GraphFunction was serialized by sparkdl_tpu, the JAX "
                "package (a jax.export StableHLO payload); sparkdl_tpu_torch "
                "reads only its own torch.export blobs")
        if data[:len(_MAGIC)] != _MAGIC:
            raise ValueError("Not a serialized GraphFunction")
        device = resolve_device(device)
        off = len(_MAGIC)
        hlen = int.from_bytes(data[off:off + 8], "little")
        header = json.loads(data[off + 8:off + 8 + hlen])
        exported = torch.export.load(io.BytesIO(data[off + 8 + hlen:]))
        if torch.device(header.get("device", "cpu")) != device:
            from torch.export.passes import move_to_device_pass
            exported = move_to_device_pass(exported, device)
        module = exported.module()
        inputs, outputs = header["inputs"], header["outputs"]

        def fn(feeds: dict) -> dict:
            return dict(module({n: feeds[n] for n in inputs}))

        specs = {n: (tuple(s if s is None else int(s) for s in shape), dt)
                 for n, (shape, dt) in header.get("specs", {}).items()}
        return cls(fn, inputs, outputs, specs or None, device=device)

    def dump(self, path: str, input_specs: Mapping[str, tuple] | None = None):
        data = self.serialize(input_specs)
        with open(path, "wb") as f:
            f.write(data)

    @classmethod
    def load(cls, path: str, device=None) -> "GraphFunction":
        with open(path, "rb") as f:
            return cls.deserialize(f.read(), device=device)

    def __repr__(self):
        return (f"GraphFunction(inputs={self.input_names}, "
                f"outputs={self.output_names}, device={self.device})")


class _Program(torch.nn.Module):
    """The module ``torch.export`` traces: the feed dict in, the fetch
    dict out (weights the function closes over become the program's
    constants)."""

    def __init__(self, fn: Callable, outputs: Sequence[str]):
        super().__init__()
        self.fn = fn
        self.outputs = list(outputs)

    def forward(self, feeds: dict) -> dict:
        res = self.fn(feeds)
        return {n: res[n] for n in self.outputs}


_SUGGESTED = re.compile(r"^\s*(\w+) = Dim\('\w+'((?:, \w+=\d+)*)\)\s*$")


def _upper_bounds(exc: Exception) -> dict:
    """The exporter's suggested fixes when each one only bounds a free
    dimension from above (``d1 = Dim('d1', max=65535)``): ``{name:
    max}``; ``{}`` when any other fix is suggested (a constant, a
    minimum above 1) or none is."""
    text = str(exc)
    if "Suggested fixes:" not in text:
        return {}
    caps = {}
    for line in text.split("Suggested fixes:", 1)[1].splitlines():
        if not line.strip():
            continue
        m = _SUGGESTED.match(line)
        if m is None:
            if caps:
                break  # the fixes' block has ended
            return {}
        bounds = dict(kv.split("=") for kv in m.group(2).split(", ")[1:])
        if set(bounds) - {"min", "max"} or int(bounds.get("min", 1)) > 1 \
                or "max" not in bounds:
            return {}
        caps[m.group(1)] = int(bounds["max"])
    return caps


def _export_error(exc: Exception, specs) -> ValueError:
    """What ``torch.export`` raised, as the ``ValueError`` serialize
    raises."""
    from ..ops._build import KernelNotExportable
    chain, e = [], exc
    while e is not None and len(chain) < 8:
        chain.append(e)
        e = e.__cause__ or e.__context__
    kernel = next((e for e in chain if isinstance(e, KernelNotExportable)),
                  None)
    if kernel is not None:
        return ValueError(f"serialize: {kernel} (ROADMAP.md, Queue C 2)")
    text = str(exc)
    if "specialized it to be a constant" in text:
        return ValueError(
            f"serialize: torch.export made a dimension the specs "
            f"{ {n: tuple(s[0]) for n, s in specs.items()} } leave free a "
            f"constant, so the program would accept one size only; a "
            f"Keras-on-torch model does this to its batch (its input "
            f"checks call int() on it; ROADMAP.md, Queue C 2). Give the "
            f"dimension a size in input_specs instead. torch.export said: "
            f"{text.splitlines()[0] if text else type(exc).__name__}")
    return ValueError(f"serialize: torch.export could not export this "
                      f"GraphFunction: {type(exc).__name__}: {text[:2000]}")


def _name_outputs(out, declared: Sequence[str] | None) -> dict:
    if isinstance(out, dict):
        named = {op_name(k): v for k, v in out.items()}
        if declared and sorted(named) != sorted(declared):
            raise ValueError(f"Function returned outputs {sorted(named)}, "
                             f"declared {sorted(declared)}")
        return named
    vals = out if isinstance(out, (tuple, list)) else (out,)
    if declared is None and len(vals) > 1:
        raise ValueError(
            "Multi-output functions must declare output_names or return a "
            "dict of named outputs")
    names = declared or ["output"]
    if len(names) != len(vals):
        raise ValueError(f"Function returned {len(vals)} outputs, declared "
                         f"{len(names)} names {names}")
    return dict(zip(names, vals))


def _probe_output_names(fn, inputs, input_specs, device) -> list[str]:
    """Infer output names at CONSTRUCTION time when possible.

    With ``input_specs`` the function runs on fake tensors
    (``FakeTensorMode``: shapes and dtypes only, no compute and no device
    touched; the counterpart of the reference's ``jax.eval_shape``): a
    dict return yields its keys, an undeclared multi-output raises here —
    at the definition — instead of as an arity error at call time.
    Without specs there is nothing to run; the single-output default
    keeps the common case simple."""
    if not input_specs or any(n not in input_specs for n in inputs):
        return ["output"]
    from torch._subclasses.fake_tensor import FakeTensorMode

    try:
        with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
            args = [torch.empty(
                tuple(1 if d is None else int(d)
                      for d in input_specs[n][0]),
                dtype=_torch_dtype(input_specs[n][1]), device=device)
                for n in inputs]
            out = fn(*args)
    except Exception:
        # fn may not run on fake tensors (host calls, data-dependent
        # control flow); fall back to the declared-or-default contract
        # checked at call time.
        return ["output"]
    if isinstance(out, dict):
        return [op_name(k) for k in out]
    if isinstance(out, (tuple, list)) and len(out) > 1:
        raise ValueError(
            f"Function returns {len(out)} outputs; declare output_names or "
            f"return a dict of named outputs")
    return ["output"]
