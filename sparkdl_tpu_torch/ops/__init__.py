"""Hand-written CUDA kernels for the hot ops, each beside its plain
PyTorch version: ``flash_attention`` (prefill), ``flash_decode``
(per-token decode) and ``paged_flash_decode`` (decode and verify through
block tables). Kernels build on first launch (``_build.py``), never at
import.

Import the submodules themselves (``from sparkdl_tpu_torch.ops import
flash_attention as fa``): this package re-exports no function named as a
submodule, so ``ops.flash_attention`` is the module (the function is
``sparkdl_tpu_torch.flash_attention``). It re-exports the attention
policy, :func:`auto_attn_fn` and :func:`resolve_attn_fn`."""

from .flash_attention import auto_attn_fn, resolve_attn_fn

__all__ = ["auto_attn_fn", "resolve_attn_fn"]
