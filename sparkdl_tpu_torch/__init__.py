"""sparkdl_tpu_torch — the PyTorch / CUDA port of ``sparkdl_tpu``.

A second package beside the JAX one, for one NVIDIA Hopper card (H100,
``sm_90a``). Module names mirror the JAX package so each counterpart is
easy to find (``ops/flash_attention.py`` ↔ ``sparkdl_tpu/ops/
flash_attention.py``, ``models/llama.py`` ↔ ``sparkdl_tpu/models/
llama.py``). Every Pallas kernel the JAX package runs on the ported path
is a CUDA C++ kernel under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``); beside each one sits its plain PyTorch version, which
CPU tensors take.

This package imports ``torch`` and never ``jax``, ``flax`` or anything of
``sparkdl_tpu``. Importing it builds nothing and touches no device.

Ported so far: Llama generation (``models.llama.generate``) with its two
kernels, ``ops.flash_attention`` (prefill) and ``ops.flash_decode``
(per-token decode). ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"
