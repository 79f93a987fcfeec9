// Error text for the cudaError_t every launcher returns
// (sparkdl_tpu_torch/ops/_build.py::check).
#include <cuda_runtime.h>

extern "C" const char* sdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
