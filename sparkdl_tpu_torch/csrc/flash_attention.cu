// Flash-attention forward for Hopper (sm_90a): the f32 variant ("fma_f32",
// f32 FMAs on the CUDA cores) and the C entry point that picks a variant by
// dtype. bf16 inputs launch the tensor-core kernel of flash_attention_tc.cu
// ("tc_mma_bf16"); f32 inputs launch the kernel below, because the tensor
// cores have no full-precision f32 product (TF32 keeps ~3 decimal digits).
//
// Replaces: sparkdl_tpu/ops/flash_attention.py:_fwd_kernel (the Pallas
// kernel that _fwd hands to pl.pallas_call). Same contract: q, k, v
// [B, H, S, D]; optional [B, S] 0/1 kv_mask; optional causal mask; O in
// q's dtype and the per-row logsumexp in f32. Mask semantics are the JAX
// kernel's exactly: a score is live when col < S, kv_mask[col] > 0 and
// (causal) col <= row; a dead score is set to NEG_INF; p is 0 while the
// row max is still NEG_INF; l == 0 divides by 1. So a fully-masked row
// gives O = 0 and lse = NEG_INF (finite).
//
// What bounds it on this card: at the prefill shapes of the port's main
// path (B = 4, H = 16, S = 2048, D = 128, causal, left pads 0, 548, 1348,
// 2015) in f32 the live work is 28.4 GFLOP against ~170 MB that the
// function must move; outside the tensor cores f32 peaks at 67 TFLOP/s, so
// the bound is operations, ~0.42 ms. This kernel runs the two products as
// f32 FMAs, which keeps the reference's f32 arithmetic.
//
// Design (what it does about the bound it has):
// - one 256-thread block per (64-row Q tile, b·h); the Q tile is staged
//   once in shared memory, pre-scaled by 1/sqrt(D) as the JAX kernel does;
// - a loop over 64-row K/V tiles inside the block replaces the TPU's
//   sequential grid axis; with causal it stops at the diagonal tile, so
//   dead tiles are never read (the TPU kernel's pl.when skip), and the
//   heaviest Q tiles launch first;
// - each thread owns a 4x4 patch of the score tile and a 4 x (D/16) patch
//   of O, so the online-softmax row max and sum are 16-lane shuffles and
//   the running (m, l, acc) stay in registers; only P goes through shared
//   memory, read back by the same half-warp (a __syncwarp, no block sync);
// - K is stored transposed and every shared read is a 16-byte vector
//   load, so each FMA-heavy loop issues one load per 8 FMAs;
// - the ragged edge (S not a multiple of 64) is masked in the kernel:
//   nothing is padded in device memory.
#include "common.cuh"

namespace {

using sdl::NEG_INF;

constexpr int BQ = 64;   // Q rows per block
constexpr int BK = 64;   // K/V rows per tile (== BQ: the causal stop is qt)
constexpr int NT = 256;  // 16 row groups x 16 column groups

template <int D>
struct Smem {  // offsets in floats
  static constexpr int QS = D + 4;   // Q row stride
  static constexpr int KS = BK + 4;  // K^T row stride
  static constexpr int PS = BK + 4;  // P row stride
  static constexpr int q = 0;
  static constexpr int k = q + BQ * QS;
  static constexpr int v = k + D * KS;
  static constexpr int p = v + BK * D;
  static constexpr int mask = p + BQ * PS;
  static constexpr int floats = mask + BK;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ kv_mask,
              T* __restrict__ o, float* __restrict__ lse, int H, int S,
              float sm_scale, int causal) {
  using L = Smem<D>;
  constexpr int NJ = D / 64;  // float4 column groups of O per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + L::q;
  float* Kt = smem + L::k;
  float* Vs = smem + L::v;
  float* Ps = smem + L::p;
  float* Ms = smem + L::mask;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = qt * BQ;
  const size_t head = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows rg*4 .. rg*4+3 of the tile
  const int cg = tid & 15;  // score cols cg*4..+3; O cols jj*64+cg*4..+3

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D, row = q0 + r;
    Qs[r * L::QS + d] =
        row < S ? sdl::to_float(q[head + static_cast<size_t>(row) * D + d]) *
                      sm_scale
                : 0.f;
  }

  float acc[4][NJ][4];
  float m_r[4], l_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = NEG_INF;
    l_r[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][jj][c] = 0.f;
  }

  int n_kt = (S + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, qt + 1);  // tiles past the diagonal are dead

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int c = e / D, d = e % D, col = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (col < S) {
        const size_t off = head + static_cast<size_t>(col) * D + d;
        kx = sdl::to_float(k[off]);
        vx = sdl::to_float(v[off]);
      }
      Kt[d * L::KS + c] = kx;
      Vs[c * D + d] = vx;
    }
    if (tid < BK) {
      const int col = k0 + tid;
      // 0 marks a dead column: past S, or masked out by kv_mask
      Ms[tid] = col < S ? (kv_mask ? kv_mask[static_cast<size_t>(b) * S + col]
                                   : 1.f)
                        : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(rg * 4 + i) * L::QS + d]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
        kv[dd] = *reinterpret_cast<const float4*>(&Kt[(d + dd) * L::KS + cg * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, sdl::f4get(kv[0], j), a);
          a = fmaf(qv[i].y, sdl::f4get(kv[1], j), a);
          a = fmaf(qv[i].z, sdl::f4get(kv[2], j), a);
          a = fmaf(qv[i].w, sdl::f4get(kv[3], j), a);
          s[i][j] = a;
        }
    }

    // Online softmax over this tile (the JAX kernel's _update, row-wise).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg * 4 + j;
        const bool live = Ms[c] > 0.f && (!causal || k0 + c <= row);
        s[i][j] = live ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      float p[4], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = m_new <= NEG_INF ? 0.f : expf(s[i][j] - m_new);
        sum += p[j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_r[i] - m_new);
      l_r[i] = l_r[i] * alpha + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][jj][c] *= alpha;
      *reinterpret_cast<float4*>(&Ps[(rg * 4 + i) * L::PS + cg * 4]) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncwarp();  // P rows of this half-warp are read by the same lanes

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(rg * 4 + i) * L::PS + kk]);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(kk + kq) * D + jj * 64 + cg * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pi = sdl::f4get(pv[i], kq);
            acc[i][jj][0] = fmaf(pi, vv.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(pi, vv.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(pi, vv.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(pi, vv.w, acc[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= S) continue;
    const float safe_l = l_r[i] > 0.f ? l_r[i] : 1.f;  // fully-masked rows
    T* orow = o + head + static_cast<size_t>(row) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[jj * 64 + cg * 4 + c] = sdl::from_float<T>(acc[i][jj][c] / safe_l);
    if (cg == 0) lse[static_cast<size_t>(bh) * S + row] = m_r[i] + logf(safe_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, void* o, void* lse, int B, int H,
                   int S, int causal, cudaStream_t stream) {
  auto kern = fa_fwd_kernel<T, D>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = sdl::allow_dynamic_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  const float sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kv_mask),
      static_cast<T*>(o), static_cast<float*>(lse), H, S, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

namespace sdl {
cudaError_t flash_attention_tc_bf16(const void* q, const void* k,
                                    const void* v, const void* kv_mask,
                                    void* o, void* lse, int* tiles, int B,
                                    int H, int S, int D, int causal,
                                    cudaStream_t stream);
}  // namespace sdl

// q, k, v, o: [B, H, S, D] contiguous; kv_mask: [B, S] f32 or NULL;
// lse: [B, H, S] f32. D must be 64 or 128. variant (the wrapper's
// kernel_variant picks it): 0 "fma_f32", f32 tensors, the CUDA-core kernel
// above; 1 "tc_mma_bf16", bf16 tensors, the tensor-core kernel of
// flash_attention_tc.cu. tiles: int32 or NULL; the tensor-core kernel adds
// the (Q tile, K tile) pairs it computed there.
extern "C" int sdl_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* kv_mask,
                                       void* o, void* lse, int B, int H, int S,
                                       int D, int causal, int variant,
                                       void* tiles, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaSuccess;
  if (B * H > 65535) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (variant == 1)
    return sdl::flash_attention_tc_bf16(q, k, v, kv_mask, o, lse,
                                        static_cast<int*>(tiles), B, H, S, D,
                                        causal, st);
  if (variant != 0) return cudaErrorInvalidValue;
  if (D == 64)
    return launch<float, 64>(q, k, v, kv_mask, o, lse, B, H, S, causal, st);
  if (D == 128)
    return launch<float, 128>(q, k, v, kv_mask, o, lse, B, H, S, causal, st);
  return cudaErrorInvalidValue;
}
