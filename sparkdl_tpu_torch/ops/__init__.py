"""Hand-written CUDA kernels for the hot ops, each beside its plain
PyTorch version: ``flash_attention`` (prefill), ``flash_decode``
(per-token decode) and ``paged_flash_decode`` (decode and verify through
block tables). Kernels build on first launch (``_build.py``), never at
import.

Import the submodules themselves (``from sparkdl_tpu_torch.ops import
flash_attention as fa``): this package re-exports no function, so no
function name shadows the module of the same name."""
