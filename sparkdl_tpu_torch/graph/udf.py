"""makeGraphUDF — register a graph as a named column function.

The counterpart of ``sparkdl_tpu/graph/udf.py``. Reference surface:
``python/sparkdl/graph/tensorframes_udf.py`` — ``makeGraphUDF(graph,
name, fetches)`` registered a TF graph as a Spark SQL UDF executed by
TensorFrames in the JVM. Here the registry lives in-process
(``sparkdl_tpu_torch.udf``) and the graph runs as one device step a
batch over Arrow batches (``udf.registerUDF``), on the graph's device.
"""

from __future__ import annotations

from typing import Sequence

from .builder import IsolatedSession
from .function import GraphFunction
from .input import XlaInputGraph


def makeGraphUDF(graph, name: str, fetches: Sequence[str] | None = None,
                 blocked: bool = True, batchSize: int = 64,
                 device=None) -> None:
    """Register ``graph`` under ``name`` in the UDF registry.

    ``graph``: a GraphFunction, XlaInputGraph, IsolatedSession export, a
    torch callable, or serialized GraphFunction bytes/path. The UDF runs
    on the graph's device; ``device`` (unset → the card) places a
    callable, bytes or a path. ``fetches`` picks the output (single
    fetch — column UDFs are one-column). ``blocked`` is reference-parity
    arity: execution here is always batched.
    """
    from ..udf import registerUDF

    if isinstance(graph, XlaInputGraph):
        gfn = graph.translateToGraphFunction()
    elif isinstance(graph, GraphFunction):
        gfn = graph
    elif isinstance(graph, IsolatedSession):
        raise TypeError("Pass issn.asGraphFunction(inputs, outputs), not the "
                        "session itself")
    elif isinstance(graph, (bytes, bytearray)):
        gfn = GraphFunction.deserialize(bytes(graph), device=device)
    elif isinstance(graph, str):
        gfn = GraphFunction.load(graph, device=device)
    elif callable(graph):
        gfn = GraphFunction.fromTorch(graph, device=device)
    else:
        raise TypeError(f"Cannot make a UDF from {type(graph).__name__}")

    del blocked
    if isinstance(fetches, str):
        fetches = [fetches]
    fetch = fetches[0] if fetches else None
    registerUDF(name, gfn.as_single_output_fn(fetch), batchSize=batchSize,
                device=str(gfn.device))
