// The mma.sync toolkit of the tensor-core flash-attention kernels
// (flash_attention_tc.cu, flash_attention_bwd_tc.cu): cp.async copies into
// XOR-swizzled bf16 tiles, ldmatrix fragment loads, the m16n8k16 bf16
// product with f32 accumulators, and the accumulator → A-fragment packing.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
// A (16 x 16) a0 (row g, cols 2t, 2t+1), a1 (row g+8), a2 (row g, cols
// 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9); B (16 x 8) b0 (k rows 2t,
// 2t+1, col g), b1 (k rows 2t+8, 2t+9); C (16 x 8) c0, c1 (row g, cols 2t,
// 2t+1), c2, c3 (row g+8). So the C tiles of two neighbouring n8 columns
// are, packed to bf16, the A fragment of one k16 step (pack_bf16).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace sdl {
namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  // src_bytes 0 zero-fills the 16 bytes without reading src
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a · b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU's ex2.approx.ftz (relative error below 2^-22; results
// under 2^-126 flush to 0, which no O or l can see). exp2f adds range
// handling that the softmax never needs, and it showed in the kernel's time.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile: the chunk
// index is XORed with the row's low 3 bits, so the 8 rows one ldmatrix
// phase reads (same logical chunk) land in 8 different bank groups.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

// cp.async a 64-row tile starting at g (rows_valid rows exist) into the
// swizzled tile at shared address dst, NT threads of the block taking part
// (tid their index); missing rows are zero-filled.
template <int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* g,
                                          int rows_valid, int tid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < 64 * CHUNKS / NT; ++i) {
    const int idx = i * NT + tid;
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const bool ok = r < rows_valid;
    cp_async16(dst + swz<D>(r, c),
               g + static_cast<size_t>(ok ? r : 0) * D + c * 8, ok ? 16 : 0);
  }
}

}  // namespace tc
}  // namespace sdl
