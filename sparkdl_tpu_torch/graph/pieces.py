"""Composable graph pieces.

The counterpart of ``sparkdl_tpu/graph/pieces.py``. Reference surface:
``python/sparkdl/graph/pieces.py`` — ``buildSpImageConverter``
(image-struct fields → float tensor, channel reorder + rescale) and
``buildFlattener`` (tensor → per-row flat vector), spliced in front of /
behind model graphs.

Struct *decode* happens once at the Arrow boundary
(``imageIO.imageColumnToNHWC``), so the converter piece starts from a
uint8/float NHWC batch: the dtype cast, the BGR→RGB reorder and the
model's rescaling are the parts that belong inside the program, on the
device, beside the model.
"""

from __future__ import annotations

import torch

from .function import GraphFunction


def buildSpImageConverter(channelOrder: str = "BGR",
                          img_dtype: str = "uint8",
                          scale: float | None = None,
                          offset: float | None = None,
                          device=None) -> GraphFunction:
    """NHWC image batch (as stored: BGR, uint8) → float32 model-input batch,
    on ``device`` (unset → the card).

    ``channelOrder``: order of the *incoming* batch ("BGR" = at-rest struct
    order, flipped to RGB here; "RGB" = passthrough). ``scale``/``offset``:
    optional affine rescale (e.g. scale=1/127.5, offset=-1 for the
    [-1, 1] preprocessing family).

    feeds: ``image``; fetches: ``converted``.
    """
    flip = channelOrder.upper() == "BGR"
    del img_dtype  # cast is unconditional; kept for reference-parity arity

    def fn(feeds: dict) -> dict:
        x = feeds["image"]
        if x.ndim != 4:
            raise ValueError(f"Expected NHWC batch, got shape "
                             f"{tuple(x.shape)}")
        x = x.to(torch.float32)
        if flip and x.shape[-1] >= 3:
            x = torch.cat([x[..., :3].flip(-1), x[..., 3:]], dim=-1)
        if scale is not None:
            x = x * scale
        if offset is not None:
            x = x + offset
        return {"converted": x}

    return GraphFunction(fn, ["image"], ["converted"], device=device)


def buildFlattener(input_name: str = "input",
                   output_name: str = "flattened",
                   device=None) -> GraphFunction:
    """(N, ...) batch → (N, prod(...)) float32 — the piece the reference
    appended so model outputs land as per-row vectors in the DataFrame."""

    def fn(feeds: dict) -> dict:
        x = feeds[input_name]
        return {output_name: x.reshape(x.shape[0], -1).to(torch.float32)}

    return GraphFunction(fn, [input_name], [output_name], device=device)
