"""Device identification — the single place that decides "are we on a
CUDA card?" and which device an entry point runs on.

The counterpart of ``sparkdl_tpu/utils/platform.py``. The entry points
run on the card unless the caller asks for the CPU: :func:`resolve_device`
turns ``None`` into ``cuda`` and raises when there is no CUDA device,
so nothing quietly continues on the CPU.
"""

from __future__ import annotations

import torch


def is_cuda_backend() -> bool:
    """True when PyTorch sees at least one CUDA device."""
    return torch.cuda.is_available()


def is_hopper(device=None) -> bool:
    """True when ``device`` (default: the current CUDA device) is a
    Hopper card, compute capability (9, 0) — the ``sm_90a`` target the
    kernels are built for."""
    if not is_cuda_backend():
        return False
    return torch.cuda.get_device_capability(device) == (9, 0)


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; anything else → ``torch.device(device)``.

    Raises ``RuntimeError`` when the resolved device is CUDA and no CUDA
    device exists — the message says to pass ``device="cpu"`` to run on
    the CPU on purpose."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not is_cuda_backend():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run on "
            "the CPU (the kernels' plain PyTorch versions)")
    return dev
