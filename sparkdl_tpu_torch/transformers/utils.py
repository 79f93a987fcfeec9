"""Transformer helpers (reference: ``python/sparkdl/transformers/utils.py``
— ``imageInputPlaceholder`` and friends; the counterpart of
``sparkdl_tpu/transformers/utils.py``).

In TF-1.x the placeholder was a graph node; here it is a symbolic input in
an :class:`~sparkdl_tpu_torch.graph.IsolatedSession` (or just a spec tuple
for ``GraphFunction.serialize``)."""

from __future__ import annotations

from ..graph.builder import GraphNode, IsolatedSession

IMAGE_INPUT_PLACEHOLDER_NAME = "sparkdl_image_input"


def imageInputPlaceholder(nChannels: int | None = None,
                          height: int | None = None,
                          width: int | None = None,
                          session: IsolatedSession | None = None,
                          name: str = IMAGE_INPUT_PLACEHOLDER_NAME,
                          device=None) -> GraphNode:
    """A batched NHWC float placeholder for image graphs.

    With ``session=None`` a fresh IsolatedSession on ``device`` (unset →
    the card) is created and attached to the returned node
    (``node.session``), mirroring the reference pattern of building the
    input placeholder first and assembling around it.
    """
    issn = session or IsolatedSession(device=device)
    return issn.placeholder((None, height, width, nChannels), "float32",
                            name=name)


def imageInputSpec(height: int, width: int, nChannels: int = 3,
                   dtype: str = "float32") -> dict:
    """{name: (shape, dtype)} spec for ``GraphFunction.serialize``."""
    return {IMAGE_INPUT_PLACEHOLDER_NAME:
            ((None, height, width, nChannels), dtype)}
