// Shared helpers of the port's CUDA kernels (plain C interface, no
// PyTorch headers: see sparkdl_tpu_torch/ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace sdl {

// Large-but-finite "minus infinity" of the JAX kernels (NEG_INF in
// sparkdl_tpu/ops/flash_attention.py): a masked score is set to it, and a
// fully-masked row keeps its running max there.
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Component j of a float4; j is a compile-time constant after unrolling.
__device__ __forceinline__ float f4get(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// N consecutive elements (N = 2 or 4) from an aligned address, as f32.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 4) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    static_assert(N == 2, "N must be 2 or 4");
    float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 4) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
    float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else {
    static_assert(N == 2, "N must be 2 or 4");
    float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  }
}

// Lets `kern` take dynamic shared memory up to the device's opt-in limit,
// and checks that this launch's `smem` fits in it. The cap belongs to the
// function, not to a launch: set to each launch's own size, a thread
// launching at a shorter S could lower it between another thread's set
// and that thread's launch, which then fails (too many resources
// requested). Host code.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kern, size_t smem) {
  int dev = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(cap)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              cap);
}

}  // namespace sdl
