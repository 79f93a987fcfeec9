"""IsolatedSession — imperative graph assembly over lazy torch nodes.

The counterpart of ``sparkdl_tpu/graph/builder.py``. Reference surface:
``python/sparkdl/graph/builder.py``'s ``IsolatedSession`` — a hermetic TF
Graph + Session scope in which users placed placeholders, built ops,
spliced in GraphFunctions (``importGraphFunction``), and exported the
result (``asGraphFunction``).

There is no session or mutable global graph in PyTorch either: the scope
is a **lazy expression DAG**. ``placeholder`` returns a symbolic
``GraphNode``; arithmetic operators and ``apply(fn, *nodes)`` build nodes;
``importGraphFunction`` splices a GraphFunction's body in as more nodes.
``asGraphFunction(inputs, outputs)`` closes the DAG into one
GraphFunction on the session's device (unset → the card; ``"cpu"`` must
be asked for), which ``jit`` captures and ``serialize`` exports whole.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .function import GraphFunction, _to_device
from .utils import op_name


class GraphNode:
    """A symbolic value in an IsolatedSession: either a placeholder (leaf)
    or a function of other nodes. Supports torch operators."""

    def __init__(self, session: "IsolatedSession", name: str,
                 fn: Callable | None = None,
                 deps: Sequence["GraphNode"] = ()):
        self.session = session
        self.name = op_name(name)
        self.fn = fn            # None ⇒ placeholder
        self.deps = list(deps)

    def evaluate(self, env: dict, cache: dict):
        if self.name in cache:
            return cache[self.name]
        if self.fn is None:
            try:
                val = env[self.name]
            except KeyError:
                raise ValueError(
                    f"No feed provided for placeholder {self.name!r}"
                    ) from None
        else:
            val = self.fn(*[d.evaluate(env, cache) for d in self.deps])
        cache[self.name] = val
        return val

    # -- operator sugar (torch ops on the nodes' values) --

    def _binop(self, other, f, name):
        if isinstance(other, GraphNode):
            return self.session.apply(f, self, other, name=name)
        # Python numbers stay numbers (they take the tensor's dtype, as
        # jax's weakly typed scalars do); arrays become tensors on the
        # session's device
        const = (other if callable(other) or isinstance(
            other, (bool, int, float)) else
            _to_device(other, self.session.device))
        return self.session.apply(lambda a: f(a, const), self, name=name)

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b, None)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b, None)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a, None)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b, None)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b, None)

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: b / a, None)

    def __matmul__(self, o):
        return self._binop(o, lambda a, b: a @ b, None)

    def __neg__(self):
        return self.session.apply(lambda a: -a, self)

    def __getitem__(self, idx):
        return self.session.apply(lambda a: a[idx], self)

    def __repr__(self):
        kind = "placeholder" if self.fn is None else "op"
        return f"GraphNode<{kind} {self.name}>"


class IsolatedSession:
    """``with IsolatedSession() as issn: ...`` — a scoped graph assembly
    on ``device`` (unset → the card; ``"cpu"`` must be asked for).

    Unlike the reference there is no live Session to run: ``run(fetches,
    feed_dict)`` evaluates eagerly for debugging, and ``asGraphFunction``
    exports the artifact.
    """

    def __init__(self, device=None):
        from ..utils.platform import resolve_device
        self.device = resolve_device(device)
        self._nodes: dict[str, GraphNode] = {}
        self._counter = 0

    # The with-statement is scoping sugar for reference-API familiarity;
    # all state lives on the session object itself (no global graph).

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    # -- graph building --

    def _fresh(self, prefix: str) -> str:
        self._counter += 1
        return f"{prefix}_{self._counter}"

    def _register(self, node: GraphNode) -> GraphNode:
        if node.name in self._nodes:
            raise ValueError(f"Duplicate node name {node.name!r}")
        self._nodes[node.name] = node
        return node

    def placeholder(self, shape: Sequence[int | None] | None = None,
                    dtype: str = "float32",
                    name: str | None = None) -> GraphNode:
        node = GraphNode(self, name or self._fresh("placeholder"))
        node.shape = tuple(shape) if shape is not None else None
        node.dtype = dtype
        return self._register(node)

    def apply(self, fn: Callable, *deps: GraphNode,
              name: str | None = None) -> GraphNode:
        """fn(*dep_values) → new node; fn takes and returns tensors."""
        for d in deps:
            if d.session is not self:
                raise ValueError(f"Node {d.name!r} belongs to another session")
        return self._register(
            GraphNode(self, name or self._fresh("op"), fn, deps))

    def constant(self, value, name: str | None = None) -> GraphNode:
        arr = _to_device(value, self.device)
        return self._register(GraphNode(
            self, name or self._fresh("const"), lambda: arr, ()))

    def importGraphFunction(self, gfn: GraphFunction,
                            inputs: Sequence[GraphNode],
                            prefix: str = "") -> list[GraphNode]:
        """Splice a GraphFunction into this session: its feeds are bound to
        ``inputs`` (positionally, the reference contract) and its fetches
        come back as nodes. It must compute on the session's device."""
        if len(inputs) != len(gfn.input_names):
            raise ValueError(
                f"GraphFunction expects {len(gfn.input_names)} inputs "
                f"{gfn.input_names}, got {len(inputs)}")
        if gfn.device != self.device:
            raise ValueError(f"GraphFunction computes on {gfn.device}, the "
                             f"session on {self.device}")
        p = f"{prefix}/" if prefix else ""

        def run_body(*vals):
            return gfn.fn(dict(zip(gfn.input_names, vals)))

        body = self.apply(run_body, *inputs,
                          name=f"{p}{self._fresh('import')}")
        outs = []
        for out_name in gfn.output_names:
            outs.append(self.apply(
                (lambda n: lambda d: d[n])(out_name), body,
                name=f"{p}{out_name}" if p else self._fresh(out_name)))
        return outs

    # -- execution / export --

    def run(self, fetches, feed_dict: dict | None = None):
        """Eager evaluation for debugging (the Session.run analogue); the
        feeds move to the session's device."""
        env = {op_name(k): _to_device(v, self.device)
               for k, v in (feed_dict or {}).items()}
        cache: dict = {}
        with torch.no_grad():
            if isinstance(fetches, GraphNode):
                return fetches.evaluate(env, cache)
            return [f.evaluate(env, cache) for f in fetches]

    def asGraphFunction(self, inputs: Sequence[GraphNode],
                        outputs: Sequence[GraphNode]) -> GraphFunction:
        for n in inputs:
            if n.fn is not None:
                raise ValueError(f"Input {n.name!r} is not a placeholder")
        in_names = [n.name for n in inputs]
        out_nodes = list(outputs)
        # Export-time validation: every placeholder reachable from the
        # outputs must be declared an input — otherwise the omission only
        # surfaces as "No feed provided" when the exported function is
        # CALLED, far from the mistake.
        declared = set(in_names)
        reachable: dict[str, GraphNode] = {}
        stack = list(out_nodes)
        seen: set[str] = set()
        while stack:
            node = stack.pop()
            if node.name in seen:
                continue
            seen.add(node.name)
            if node.fn is None:
                reachable[node.name] = node
            stack.extend(node.deps)
        missing = sorted(set(reachable) - declared)
        if missing:
            raise ValueError(
                f"asGraphFunction: outputs depend on placeholder(s) "
                f"{missing} not declared in inputs {sorted(declared)}")

        def fn(feeds: dict) -> dict:
            cache: dict = {}
            return {n.name: n.evaluate(feeds, cache) for n in out_nodes}

        specs = {}
        for n in inputs:
            if getattr(n, "shape", None) is not None:
                specs[n.name] = (n.shape, getattr(n, "dtype", "float32"))
        return GraphFunction(fn, in_names, [n.name for n in out_nodes],
                             specs or None, device=self.device)


IsolatedGraph = IsolatedSession  # the reference package's alias
