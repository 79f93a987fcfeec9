"""Graph toolkit of the port, on ``torch.export``.

The counterpart of ``sparkdl_tpu/graph/`` (reference:
``python/sparkdl/graph/`` — builder, input, pieces, utils,
tensorframes_udf). ``GraphFunction`` is the unit (``fromTorch``,
``fromModule``, ``fromKeras``, ``fromList``; ``serialize`` through
``torch.export``); ``IsolatedSession`` assembles one imperatively;
``XlaInputGraph`` normalizes artifacts into one; ``makeGraphUDF``
registers one as a column function. Every constructor computes on its
``device`` (unset → the card; ``"cpu"`` must be asked for).
"""

from .builder import GraphNode, IsolatedGraph, IsolatedSession
from .function import GraphFunction
from .input import TFInputGraph, XlaInputGraph, load_weights
from .pieces import buildFlattener, buildSpImageConverter
from .udf import makeGraphUDF
from .utils import op_name, tensor_name, validated_input, validated_output

__all__ = [
    "GraphFunction", "IsolatedSession", "IsolatedGraph", "GraphNode",
    "XlaInputGraph", "TFInputGraph", "load_weights",
    "buildSpImageConverter", "buildFlattener", "makeGraphUDF",
    "op_name", "tensor_name", "validated_input", "validated_output",
]
