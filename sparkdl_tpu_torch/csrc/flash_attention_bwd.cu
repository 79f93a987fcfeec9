// Flash-attention backward for Hopper (sm_90a): dq, dk, dv from the saved
// forward (q, k, v, O, lse) and the incoming dO. This file holds the C entry
// point, which launches the variant the wrapper's kernel_variant picked:
// "fma_f32" (f32 tensors), f32 FMAs on the CUDA cores, below; "tc_mma_bf16"
// (bf16 tensors), the tensor-core kernels of flash_attention_bwd_tc.cu. The
// delta kernel below runs first for both.
//
// Replaces: sparkdl_tpu/ops/flash_attention.py:_bwd_one_head / _flash_bwd,
// the JAX package's backward (plain JAX under jax.custom_vjp: a lax.scan
// over K tiles under two vmaps, not a Pallas kernel). Same arithmetic, in
// f32 (the tensor-core variant's roundings are in its own file):
//   delta = rowsum(dO * O)
//   P  = live ? exp(scale * q.k - lse) : 0     (never exp of a dead score)
//   dV = P^T dO;  dP = dO V^T;  dS = P * (dP - delta) * scale
//   dK = dS^T q;  dQ = dS K
// A score is live when col < S, kv_mask[col] > 0 and (causal) col <= row,
// the forward's rule. P comes from that mask, not from the exp: a fully
// masked row has lse = NEG_INF, and exp(NEG_INF - NEG_INF) would be 1. So
// such a row's dQ is exactly 0 and it adds nothing to dK or dV.
//
// What bounds it on this card: five products of 2*S*S*D a (b, h) (the
// recomputed q.k, dV, dP, dK, dQ), halved when causal, against reading q,
// k, v, O, dO, lse and writing dq, dk, dv; at S = 2048, D = 128 that is
// ~340 operations a byte, so operations bound it. The f32 variant runs
// them as f32 FMAs on the CUDA cores (67 TFLOP/s at most: the tensor cores
// have no full-precision f32 product), which keeps the reference's f32
// arithmetic; it also recomputes q.k and dP once more than the bound
// counts (in both the dK/dV and the dQ stage).
//
// Design: three launches on the caller's stream, no atomics, so the
// gradients are the same bits run to run.
// 1. delta: one warp a row, f32 [B, H, S] scratch the wrapper allocates.
// 2. dK, dV: one 256-thread block per (64-row K tile, b*h), K^T and V^T
//    staged once; it walks the Q tiles that can see the K tile (from the
//    diagonal down when causal), each staged as scale*q and dO with its lse
//    and delta. Thread (rg, cg) computes a 4x4 patch of S and dP (q rows
//    rg*4.., k cols cg*4..), writes P and dS/scale to shared memory, and
//    after one barrier accumulates dV and dK for k rows rg*4.. and
//    D/16 columns in registers (dK from scale*q, so dS needs no scale).
// 3. dQ: one 256-thread block per (64-row Q tile, b*h), heaviest causal
//    tiles first; it walks the K tiles up to the diagonal, each staged as
//    K^T, V^T and K, and accumulates dQ in registers; the dS rows a thread
//    reads were written by its own half-warp (a __syncwarp, no barrier).
// The ragged edge is masked in the kernels: rows and columns >= S are read
// as 0, are never live, and are not written.
#include "common.cuh"

namespace {

using sdl::NEG_INF;

constexpr int BQ = 64;   // Q rows a tile
constexpr int BK = 64;   // K rows a tile (== BQ: the causal walks start
                         // and stop at the diagonal tile)
constexpr int NT = 256;  // 16 row groups x 16 column groups

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ d_o,
                    float* __restrict__ delta, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc = fmaf(sdl::to_float(d_o[base + d]), sdl::to_float(o[base + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
struct Layout {  // offsets in floats
  static constexpr int QS = D + 4;   // [r][d] row stride: scale*q, dO, K
  static constexpr int TS = BK + 4;  // [d][c] row stride: K^T, V^T
  static constexpr int PS = BK + 4;  // [r][c] row stride: P, dS
};

// Stages rows [r0, r0 + 64) of a [S, D] head as f32 [r][d] at stride QS,
// times `mul`; rows >= S read as 0.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0,
                                           int S, float mul) {
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, d = e % D, row = r0 + r;
    dst[r * Layout<D>::QS + d] =
        row < S ? sdl::to_float(src[static_cast<size_t>(row) * D + d]) * mul
                : 0.f;
  }
}

// Stages rows [c0, c0 + 64) of a [S, D] head transposed, f32 [d][c] at
// stride TS; rows >= S read as 0.
template <typename T, int D>
__device__ __forceinline__ void stage_cols(float* dst, const T* src, int c0,
                                           int S) {
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int c = e / D, d = e % D, col = c0 + c;
    dst[d * Layout<D>::TS + c] =
        col < S ? sdl::to_float(src[static_cast<size_t>(col) * D + d]) : 0.f;
  }
}

// s[i][j] = sum_d Qs[rg*4+i][d] * Kt[d][cg*4+j], and dp the same with dOs
// and Vt: the recomputed scores (Qs holds scale*q) and dP of one 4x4 patch.
template <int D>
__device__ __forceinline__ void scores_and_dp(const float* Qs,
                                              const float* dOs,
                                              const float* Kt,
                                              const float* Vt, int rg, int cg,
                                              float (&s)[4][4],
                                              float (&dp)[4][4]) {
  using L = Layout<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(&Qs[(rg * 4 + i) * L::QS + d]);
      ov[i] = *reinterpret_cast<const float4*>(&dOs[(rg * 4 + i) * L::QS + d]);
    }
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      kv[dd] = *reinterpret_cast<const float4*>(&Kt[(d + dd) * L::TS + cg * 4]);
      vv[dd] = *reinterpret_cast<const float4*>(&Vt[(d + dd) * L::TS + cg * 4]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = s[i][j], b = dp[i][j];
        a = fmaf(qv[i].x, sdl::f4get(kv[0], j), a);
        a = fmaf(qv[i].y, sdl::f4get(kv[1], j), a);
        a = fmaf(qv[i].z, sdl::f4get(kv[2], j), a);
        a = fmaf(qv[i].w, sdl::f4get(kv[3], j), a);
        b = fmaf(ov[i].x, sdl::f4get(vv[0], j), b);
        b = fmaf(ov[i].y, sdl::f4get(vv[1], j), b);
        b = fmaf(ov[i].z, sdl::f4get(vv[2], j), b);
        b = fmaf(ov[i].w, sdl::f4get(vv[3], j), b);
        s[i][j] = a;
        dp[i][j] = b;
      }
  }
}

// P and dS/scale of one 4x4 patch (q rows q0+rg*4+i, k cols k0+cg*4+j):
// P from the mask, never from the exp of a dead score.
__device__ __forceinline__ void probs_and_ds(const float (&s)[4][4],
                                             const float (&dp)[4][4],
                                             const float* Ls, const float* Ds,
                                             const float* Ms, int q0, int k0,
                                             int rg, int cg, int S,
                                             int causal, float (&p)[4][4],
                                             float (&ds)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cg * 4 + j;
      const bool live =
          row < S && Ms[c] > 0.f && (!causal || k0 + c <= row);
      p[i][j] = live ? expf(s[i][j] - Ls[r]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - Ds[r]);
    }
  }
}

// Stages the live-column flags of K tile k0 (0 past S or where kv_mask is
// 0) into Ms.
__device__ __forceinline__ void stage_mask(float* Ms, const float* kv_mask,
                                           int b, int k0, int S) {
  if (threadIdx.x < BK) {
    const int col = k0 + threadIdx.x;
    Ms[threadIdx.x] =
        col < S ? (kv_mask ? kv_mask[static_cast<size_t>(b) * S + col] : 1.f)
                : 0.f;
  }
}

// lse and delta of Q tile q0 into Ls, Ds (0 past S; such rows are dead).
__device__ __forceinline__ void stage_row_stats(float* Ls, float* Ds,
                                                const float* lse,
                                                const float* delta,
                                                size_t rbase, int q0, int S) {
  if (threadIdx.x < BQ) {
    const int row = q0 + threadIdx.x;
    Ls[threadIdx.x] = row < S ? lse[rbase + row] : 0.f;
    Ds[threadIdx.x] = row < S ? delta[rbase + row] : 0.f;
  }
}

template <int D>
struct KVSmem {  // offsets in floats
  using L = Layout<D>;
  static constexpr int q = 0;                   // scale*q  [r][d]
  static constexpr int dO = q + BQ * L::QS;     // dO       [r][d]
  static constexpr int kt = dO + BQ * L::QS;    // K^T      [d][c]
  static constexpr int vt = kt + D * L::TS;     // V^T      [d][c]
  static constexpr int p = vt + D * L::TS;      // P        [r][c]
  static constexpr int ds = p + BQ * L::PS;     // dS/scale [r][c]
  static constexpr int lse = ds + BQ * L::PS;
  static constexpr int delta = lse + BQ;
  static constexpr int mask = delta + BQ;
  static constexpr size_t bytes = (mask + BK) * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ d_o,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const float* __restrict__ kv_mask, T* __restrict__ dk,
                   T* __restrict__ dv, int H, int S, float sm_scale,
                   int causal) {
  using L = Layout<D>;
  using M = KVSmem<D>;
  constexpr int NJ = D / 64;  // float4 column groups of dK/dV per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + M::q;
  float* dOs = smem + M::dO;
  float* Kt = smem + M::kt;
  float* Vt = smem + M::vt;
  float* Ps = smem + M::p;
  float* DSs = smem + M::ds;
  float* Ls = smem + M::lse;
  float* Ds = smem + M::delta;
  float* Ms = smem + M::mask;

  const int kt = blockIdx.x;  // tile 0 walks the most Q tiles: first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = kt * BK;
  const size_t head = static_cast<size_t>(bh) * S * D;
  const size_t rbase = static_cast<size_t>(bh) * S;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;

  stage_cols<T, D>(Kt, k + head, k0, S);
  stage_cols<T, D>(Vt, v + head, k0, S);
  stage_mask(Ms, kv_mask, b, k0, S);

  float acc_v[4][NJ][4], acc_k[4][NJ][4];  // k rows rg*4+i, d jj*64+cg*4+c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_v[i][jj][c] = acc_k[i][jj][c] = 0.f;

  const int n_qt = (S + BQ - 1) / BQ;
  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous Q tile's readers are done
    stage_rows<T, D>(Qs, q + head, q0, S, sm_scale);
    stage_rows<T, D>(dOs, d_o + head, q0, S, 1.f);
    stage_row_stats(Ls, Ds, lse, delta, rbase, q0, S);
    __syncthreads();

    float s[4][4], dp[4][4], p[4][4], ds[4][4];
    scores_and_dp<D>(Qs, dOs, Kt, Vt, rg, cg, s, dp);
    probs_and_ds(s, dp, Ls, Ds, Ms, q0, k0, rg, cg, S, causal, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(&Ps[(rg * 4 + i) * L::PS + cg * 4]) =
          make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
      *reinterpret_cast<float4*>(&DSs[(rg * 4 + i) * L::PS + cg * 4]) =
          make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T (scale*q): thread (rg, cg) owns k rows
    // rg*4.. and d columns jj*64 + cg*4..
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(&Ps[r * L::PS + rg * 4]);
      const float4 sv =
          *reinterpret_cast<const float4*>(&DSs[r * L::PS + rg * 4]);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 ov = *reinterpret_cast<const float4*>(
            &dOs[r * L::QS + jj * 64 + cg * 4]);
        const float4 qv = *reinterpret_cast<const float4*>(
            &Qs[r * L::QS + jj * 64 + cg * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pi = sdl::f4get(pv, i), si = sdl::f4get(sv, i);
          acc_v[i][jj][0] = fmaf(pi, ov.x, acc_v[i][jj][0]);
          acc_v[i][jj][1] = fmaf(pi, ov.y, acc_v[i][jj][1]);
          acc_v[i][jj][2] = fmaf(pi, ov.z, acc_v[i][jj][2]);
          acc_v[i][jj][3] = fmaf(pi, ov.w, acc_v[i][jj][3]);
          acc_k[i][jj][0] = fmaf(si, qv.x, acc_k[i][jj][0]);
          acc_k[i][jj][1] = fmaf(si, qv.y, acc_k[i][jj][1]);
          acc_k[i][jj][2] = fmaf(si, qv.z, acc_k[i][jj][2]);
          acc_k[i][jj][3] = fmaf(si, qv.w, acc_k[i][jj][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + rg * 4 + i;
    if (col >= S) continue;
    const size_t off = head + static_cast<size_t>(col) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = jj * 64 + cg * 4 + c;
        dk[off + d] = sdl::from_float<T>(acc_k[i][jj][c]);
        dv[off + d] = sdl::from_float<T>(acc_v[i][jj][c]);
      }
  }
}

template <int D>
struct QSmem {  // offsets in floats
  using L = Layout<D>;
  static constexpr int q = 0;                  // scale*q  [r][d]
  static constexpr int dO = q + BQ * L::QS;    // dO       [r][d]
  static constexpr int kt = dO + BQ * L::QS;   // K^T      [d][c]
  static constexpr int vt = kt + D * L::TS;    // V^T      [d][c]
  static constexpr int k = vt + D * L::TS;     // K        [c][d]
  static constexpr int ds = k + BK * L::QS;    // dS/scale [r][c]
  static constexpr int lse = ds + BQ * L::PS;
  static constexpr int delta = lse + BQ;
  static constexpr int mask = delta + BQ;
  static constexpr size_t bytes = (mask + BK) * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ d_o,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ kv_mask, T* __restrict__ dq, int H,
                 int S, float sm_scale, int causal) {
  using L = Layout<D>;
  using M = QSmem<D>;
  constexpr int NJ = D / 64;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + M::q;
  float* dOs = smem + M::dO;
  float* Kt = smem + M::kt;
  float* Vt = smem + M::vt;
  float* Ks = smem + M::k;
  float* DSs = smem + M::ds;
  float* Ls = smem + M::lse;
  float* Ds = smem + M::delta;
  float* Ms = smem + M::mask;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = qt * BQ;
  const size_t head = static_cast<size_t>(bh) * S * D;
  const size_t rbase = static_cast<size_t>(bh) * S;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;

  stage_rows<T, D>(Qs, q + head, q0, S, sm_scale);
  stage_rows<T, D>(dOs, d_o + head, q0, S, 1.f);
  stage_row_stats(Ls, Ds, lse, delta, rbase, q0, S);

  float acc[4][NJ][4];  // q rows rg*4+i, d columns jj*64+cg*4+c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][jj][c] = 0.f;

  int n_kt = (S + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, qt + 1);  // tiles past the diagonal are dead
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous K tile's readers are done
    stage_cols<T, D>(Kt, k + head, k0, S);
    stage_cols<T, D>(Vt, v + head, k0, S);
    stage_rows<T, D>(Ks, k + head, k0, S, 1.f);
    stage_mask(Ms, kv_mask, b, k0, S);
    __syncthreads();

    float s[4][4], dp[4][4], p[4][4], ds[4][4];
    scores_and_dp<D>(Qs, dOs, Kt, Vt, rg, cg, s, dp);
    probs_and_ds(s, dp, Ls, Ds, Ms, q0, k0, rg, cg, S, causal, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&DSs[(rg * 4 + i) * L::PS + cg * 4]) =
          make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
    __syncwarp();  // dS rows of this half-warp are read by the same lanes

    // dQ += dS K: thread (rg, cg) owns q rows rg*4.. and d columns
    // jj*64 + cg*4..
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sv[i] = *reinterpret_cast<const float4*>(
            &DSs[(rg * 4 + i) * L::PS + kk]);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 kv = *reinterpret_cast<const float4*>(
              &Ks[(kk + kq) * L::QS + jj * 64 + cg * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float si = sdl::f4get(sv[i], kq);
            acc[i][jj][0] = fmaf(si, kv.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(si, kv.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(si, kv.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(si, kv.w, acc[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= S) continue;
    T* out = dq + head + static_cast<size_t>(row) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[jj * 64 + cg * 4 + c] = sdl::from_float<T>(acc[i][jj][c] * sm_scale);
  }
}

template <typename T, int D>
cudaError_t launch_delta(const void* o, const void* d_o, void* delta,
                         long long rows, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((rows + NT / 32 - 1) / (NT / 32));
  fa_bwd_delta_kernel<T, D><<<blocks, NT, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(d_o),
      static_cast<float*>(delta), rows);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lse, const void* d_o, const void* kv_mask,
                   void* dq, void* dk, void* dv, void* delta, int B, int H,
                   int S, int causal, cudaStream_t stream) {
  auto kv_kern = fa_bwd_dkdv_kernel<T, D>;
  auto q_kern = fa_bwd_dq_kernel<T, D>;
  cudaError_t err = sdl::allow_dynamic_smem(kv_kern, KVSmem<D>::bytes);
  if (err != cudaSuccess) return err;
  err = sdl::allow_dynamic_smem(q_kern, QSmem<D>::bytes);
  if (err != cudaSuccess) return err;
  const float sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const auto* tq = static_cast<const T*>(q);
  const auto* tk = static_cast<const T*>(k);
  const auto* tv = static_cast<const T*>(v);
  const auto* tdo = static_cast<const T*>(d_o);
  const auto* flse = static_cast<const float*>(lse);
  const auto* fmask = static_cast<const float*>(kv_mask);
  auto* fdelta = static_cast<float*>(delta);

  const int tiles = (S + BQ - 1) / BQ;
  kv_kern<<<dim3(tiles, B * H), NT, KVSmem<D>::bytes, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, fmask, static_cast<T*>(dk),
      static_cast<T*>(dv), H, S, sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  q_kern<<<dim3(tiles, B * H), NT, QSmem<D>::bytes, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, fmask, static_cast<T*>(dq), H, S,
      sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

namespace sdl {
cudaError_t flash_attention_bwd_tc_bf16(const void* q, const void* k,
                                        const void* v, const void* lse,
                                        const void* d_o, const void* kv_mask,
                                        void* dq, void* dk, void* dv,
                                        const void* delta, int B, int H,
                                        int S, int D, int causal,
                                        cudaStream_t stream);
}  // namespace sdl

// q, k, v, o, d_o, dq, dk, dv: [B, H, S, D] contiguous, 16-byte aligned;
// lse: [B, H, S] f32 from the forward; kv_mask: [B, S] f32 or NULL; delta:
// [B, H, S] f32 scratch. D must be 64 or 128. variant (the wrapper's
// kernel_variant picks it): 0 "fma_f32", f32 tensors, the CUDA-core kernels
// above; 1 "tc_mma_bf16", bf16 tensors, the tensor-core kernels of
// flash_attention_bwd_tc.cu. Either way delta = rowsum(dO * O) runs first.
extern "C" int sdl_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* lse, const void* d_o,
                                       const void* kv_mask, void* dq,
                                       void* dk, void* dv, void* delta,
                                       int B, int H, int S, int D, int causal,
                                       int variant, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaSuccess;
  if (B * H > 65535 || (D != 64 && D != 128)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * H * S;
  cudaError_t err;
  if (variant == 0) {
    err = D == 64 ? launch_delta<float, 64>(o, d_o, delta, rows, st)
                  : launch_delta<float, 128>(o, d_o, delta, rows, st);
    if (err != cudaSuccess) return err;
    if (D == 64)
      return launch<float, 64>(q, k, v, lse, d_o, kv_mask, dq, dk, dv, delta,
                               B, H, S, causal, st);
    return launch<float, 128>(q, k, v, lse, d_o, kv_mask, dq, dk, dv, delta,
                              B, H, S, causal, st);
  }
  if (variant == 1) {
    err = D == 64
              ? launch_delta<__nv_bfloat16, 64>(o, d_o, delta, rows, st)
              : launch_delta<__nv_bfloat16, 128>(o, d_o, delta, rows, st);
    if (err != cudaSuccess) return err;
    return sdl::flash_attention_bwd_tc_bf16(q, k, v, lse, d_o, kv_mask, dq,
                                            dk, dv, delta, B, H, S, D, causal,
                                            st);
  }
  return cudaErrorInvalidValue;
}
