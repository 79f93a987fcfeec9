"""Random draws over one rank's rows of a gang's global batch.

The reference's implicit data-parallel step draws the global batch's
dropout masks from one key, and with partitionable threefry each device
computes the bits of its own rows, so a step does not depend on the
number of devices. ``torch.rand`` is not row-addressable: the value of an
element depends on the shape of the whole draw. So a rank draws the
global shape from the step's generator, which every rank seeds alike,
and keeps its own rows (:class:`RowWindow`). Rank r's masks are then
exactly rows r of the one-process step's masks over the global batch, at
``world``× the random numbers a rank's own rows need.

Dim 0 of every draw is the batch's rows (every dropout site of
``models/bert.py``: embeddings, attention probabilities, the layers'
outputs, the pooled row).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RowWindow:
    """The step's ``generator`` restricted to rows ``[row_start,
    row_start + n)`` of a global batch of ``global_rows`` rows, ``n`` the
    leading dim of each draw."""
    generator: torch.Generator
    row_start: int
    global_rows: int

    def rand(self, shape, device) -> torch.Tensor:
        """Rows ``[row_start, row_start + shape[0])`` of ``torch.rand((
        global_rows, *shape[1:]))`` from the generator."""
        n = shape[0]
        if self.row_start + n > self.global_rows:
            raise ValueError(
                f"rows [{self.row_start}, {self.row_start + n}) lie outside "
                f"a global batch of {self.global_rows}")
        full = torch.rand((self.global_rows, *shape[1:]),
                          generator=self.generator, device=device)
        return full[self.row_start:self.row_start + n]


def uniform(shape, rng, device) -> torch.Tensor:
    """U[0, 1) of ``shape`` on ``device`` from ``rng``: a
    ``torch.Generator`` draws ``torch.rand(shape)``, a :class:`RowWindow`
    its rows of the global draw."""
    if isinstance(rng, RowWindow):
        return rng.rand(tuple(shape), device)
    return torch.rand(shape, generator=rng, device=device)
