// Flash-attention backward for Hopper's tensor cores (sm_90a), bf16 in and
// out, f32 accumulators: the "tc_mma_bf16" variant of flash_attention_bwd.
//
// Replaces: sparkdl_tpu/ops/flash_attention.py:_bwd_one_head / _flash_bwd
// (the JAX package's backward, plain JAX under jax.custom_vjp) for bf16
// inputs; f32 inputs keep the CUDA-core kernels of flash_attention_bwd.cu,
// which also holds the C entry point, the delta kernel, and the choice
// between the two. Same function, given the saved (q, k, v, O, lse), dO,
// causal and an optional [B, S] kv_mask:
//   delta = rowsum(dO * O)                      (flash_attention_bwd.cu)
//   P  = live ? exp(scale * q.k - lse) : 0      (never exp of a dead score)
//   dV = P^T dO;  dS = P * (dO V^T - delta) * scale
//   dK = dS^T q;  dQ = dS K
// A score is live when col < S, kv_mask[col] > 0 and (causal) col <= row.
// P comes from that rule, not from the exp: an all-masked row has lse =
// NEG_INF, and exp(NEG_INF - NEG_INF) would be 1; so such a row's dq, dk
// and dv stay exactly 0. Each gradient is rounded to bf16 once, from f32.
// The tensor cores add two roundings that the plain version lacks: P to
// bf16 before dV, and dS/scale to bf16 before dK and dQ (checks hold the
// kernel to fa.bwd_tolerance's "tc_mma_bf16" rule for that).
//
// What bounds it on this card: operations. At the trainer's layer (B 2,
// H 32, S 2048, D 128, causal) the bound counts five products of 2·D a
// live (row, col) pair (q.k again, dV, dP, dK, dQ), 1.7e11 FLOP against
// ~17 MB moved: 0.174 ms at 989 TFLOP/s bf16. Two stages without atomics
// issue seven: q.k and dO.V^T are computed in both. So 5 of 7 products are
// useful, and this design reaches at best about 71 % of the bound.
//
// What the design does about the four limits of the CUDA-core version:
// 1. no tensor cores: every product runs on mma.sync.m16n8k16 bf16 with
//    f32 accumulators (products exact, sums in f32). The scale multiplies
//    f32 scores (with log2(e) folded in, for ex2) and the f32 dK and dQ
//    epilogues, never a bf16 operand;
// 2. operands widened to f32 and staged synchronously: q, k, v and dO stay
//    bf16 in shared memory, copied by 16-byte cp.async into tiles whose
//    16-byte chunks are XOR-swizzled (mma_sync.cuh), so ldmatrix and
//    ldmatrix.trans read them without bank conflicts; rows past S are
//    zero-filled by cp.async's src-size operand. The streamed tiles go
//    through a 2-stage ring: tile i+1 is in flight while tile i computes,
//    one barrier a tile;
// 3. one block an SM: one 128-thread block (4 warps, 16 rows each) per
//    (64-row tile, b·h) with ~97 KB of shared memory at D 128, so two
//    blocks an SM; no kernel may spill (chip_smoke.py phase a);
// 4. seven products where the bound counts five: kept, the price of no
//    atomics (gradients are the same bits run to run).
// dK/dV: K and V of the block's tile land once; the Q tiles that see it
// (from the diagonal down when causal) stream q, dO, lse and delta. The
// block works transposed, so P never goes through shared memory: S^T =
// K q^T and dP^T = V dO^T (A from K, V by ldmatrix; B from q, dO by
// ldmatrix, as the forward reads K), P^T and dS^T/scale in f32 registers,
// packed from the accumulator layout straight into bf16 A fragments, then
// dV += P^T dO and dK += dS^T q (B by ldmatrix.trans, as the forward reads
// V). A Q tile goes in two 32-column halves, which keeps S^T and dP^T at
// 32 registers beside the 128 of dK and dV.
// dQ: q and dO of the block's tile land once; the K/V tiles up to the
// diagonal stream; S = q K^T, dP = dO V^T, dS/scale packed into A
// fragments, dQ += dS K (K by ldmatrix.trans) — the forward's structure.
// Element masks run only on the causal diagonal tile and on tiles with a
// dead column or row (the ragged edge, a kv_mask zero). The epilogues
// round once to bf16 and store 16 bytes a lane through the warp's own
// rows of a tile buffer that only that warp reads.
#include <stdint.h>

#include "common.cuh"
#include "mma_sync.cuh"

namespace {

using sdl::NEG_INF;
using namespace sdl::tc;

constexpr int BQ = 64;  // Q rows a tile
constexpr int BK = 64;  // K rows a tile (== BQ: the causal walks start and
                        // stop at the diagonal tile)
constexpr int NW = 4;
constexpr int NT = NW * 32;
constexpr float LOG2E = 1.44269504088896340736f;

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

template <int D>
struct DkdvSmem {  // byte offsets
  static constexpr int TILE = 64 * D * 2;             // one bf16 tile
  static constexpr int k = 0;
  static constexpr int v = TILE;
  static constexpr int STAGE = 2 * TILE + 2 * BQ * 4;  // q, dO, lse, delta
  __host__ __device__ static constexpr int q(int st) {
    return 2 * TILE + st * STAGE;
  }
  __host__ __device__ static constexpr int d_o(int st) {
    return q(st) + TILE;
  }
  __host__ __device__ static constexpr int lse(int st) {
    return q(st) + 2 * TILE;
  }
  __host__ __device__ static constexpr int delta(int st) {
    return lse(st) + BQ * 4;
  }
  static constexpr int bits = 2 * TILE + 2 * STAGE;   // the K tile's columns
  static constexpr size_t bytes = bits + 16;
};

// One Q-tile stage of the dK/dV ring: q and dO rows q0.. (zero past S), lse
// and delta of those rows (0 past S; such rows are dead).
template <int D>
__device__ __forceinline__ void load_q_stage(
    unsigned char* smem, int st, const __nv_bfloat16* q,
    const __nv_bfloat16* d_o, const float* lse, const float* delta,
    size_t head, size_t rbase, int q0, int S, int tid) {
  using L = DkdvSmem<D>;
  const size_t off = head + static_cast<size_t>(q0) * D;
  load_tile<D, NT>(smem_addr(smem + L::q(st)), q + off, S - q0, tid);
  load_tile<D, NT>(smem_addr(smem + L::d_o(st)), d_o + off, S - q0, tid);
  const int r = tid & (BQ - 1), row = q0 + r;
  const bool ok = row < S;
  const float* src = (tid < BQ ? lse : delta) + rbase + (ok ? row : 0);
  cp_async4(smem_addr(smem + (tid < BQ ? L::lse(st) : L::delta(st)) + 4 * r),
            src, ok ? 4 : 0);
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
fa_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ d_o,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ kv_mask,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int H, int S,
                      float scale, float scale_log2, int causal) {
  using L = DkdvSmem<D>;
  constexpr int KS = D / 16;  // k16 steps over D
  constexpr int DT = D / 8;   // n8 tiles of dK, dV
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned* bits = reinterpret_cast<unsigned*>(smem + L::bits);

  const int kt = blockIdx.x;  // tile 0 walks the most Q tiles: first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = kt * BK;
  const size_t head = static_cast<size_t>(bh) * S * D;
  const size_t rbase = static_cast<size_t>(bh) * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair

  const uint32_t k_s = smem_addr(smem + L::k);
  const uint32_t v_s = smem_addr(smem + L::v);
  load_tile<D, NT>(k_s, k + head + static_cast<size_t>(k0) * D, S - k0, tid);
  load_tile<D, NT>(v_s, v + head + static_cast<size_t>(k0) * D, S - k0, tid);
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt0 = causal ? kt : 0;
  load_q_stage<D>(smem, 0, q, d_o, lse, delta, head, rbase, qt0 * BQ, S, tid);
  cp_async_commit();

  if (warp < 2) {  // the tile's live columns (this block's K rows), 2 words
    const int col = k0 + warp * 32 + lane;
    const float m =
        col < S ? (kv_mask ? __ldg(kv_mask + static_cast<size_t>(b) * S + col)
                           : 1.f)
                : 0.f;
    const unsigned w = __ballot_sync(0xffffffffu, m > 0.f);
    if (lane == 0) bits[warp] = w;
  }
  __syncthreads();
  const bool k_full = (bits[0] & bits[1]) == 0xffffffffu;
  bool live_k[2];  // this thread's K rows warp*16 + g (+ 8)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = warp * 16 + g + 8 * h;
    live_k[h] = (bits[kr >> 5] >> (kr & 31)) & 1u;
  }

  float acc_v[DT][4], acc_k[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[j][e] = acc_k[j][e] = 0.f;

  for (int qt = qt0, i = 0; qt < n_qt; ++qt, ++i) {
    const int st = i & 1;
    cp_async_wait_all();
    __syncthreads();  // stage i landed; every warp is done with the other
    if (qt + 1 < n_qt) {
      load_q_stage<D>(smem, st ^ 1, q, d_o, lse, delta, head, rbase,
                      (qt + 1) * BQ, S, tid);
      cp_async_commit();
    }
    const int q0 = qt * BQ;
    const bool masked = !k_full || (causal && qt == kt) || q0 + BQ > S;
    const uint32_t qb = smem_addr(smem + L::q(st));
    const uint32_t ob = smem_addr(smem + L::d_o(st));
    const float* ls = reinterpret_cast<const float*>(smem + L::lse(st));
    const float* dl = reinterpret_cast<const float*>(smem + L::delta(st));

    // not unrolled: one half's fragments and addresses live at a time, which
    // keeps the kernel under 255 registers at D 128 without a spill
#pragma unroll 1
    for (int hq = 0; hq < 2; ++hq) {  // Q columns hq*32 .. +31
      // S^T = K q^T and dP^T = V dO^T: this warp's 16 K rows x 32 Q rows
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        const int ar = warp * 16 + (lane & 15), ac = 2 * kk + (lane >> 4);
        ldmatrix_x4(ka, k_s + swz<D>(ar, ac));
        ldmatrix_x4(va, v_s + swz<D>(ar, ac));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          const int br = hq * 32 + 16 * np + (lane & 7) + ((lane >> 4) << 3);
          const int bc = 2 * kk + ((lane >> 3) & 1);
          ldmatrix_x4(r, qb + swz<D>(br, bc));
          mma_bf16(s[2 * np], ka, r[0], r[1]);
          mma_bf16(s[2 * np + 1], ka, r[2], r[3]);
          ldmatrix_x4(r, ob + swz<D>(br, bc));
          mma_bf16(dp[2 * np], va, r[0], r[1]);
          mma_bf16(dp[2 * np + 1], va, r[2], r[3]);
        }
      }

      // P^T (in s) and dS^T / scale (in dp), f32, from the live rule
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = hq * 32 + 8 * j + 2 * t;  // Q row within the tile
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_c = (e & 1) ? l2.y : l2.x;
          const float delta_c = (e & 1) ? d2.y : d2.x;
          float p = fast_exp2(fmaf(s[j][e], scale_log2, -lse_c * LOG2E));
          if (masked) {
            const int kr = warp * 16 + g + 8 * (e >> 1);
            const int row = q0 + c + (e & 1);
            const bool live = live_k[e >> 1] && row < S &&
                              (!causal || k0 + kr <= row);
            p = live ? p : 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_c);
        }
      }

      // dV += P^T dO and dK += (dS^T / scale) q over these 32 Q rows
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t da[4] = {
            pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
            pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
            pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
        const int key =
            hq * 32 + 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, ob + swz<D>(key, 2 * dd + (lane >> 4)));
          mma_bf16(acc_v[2 * dd], pa, r[0], r[1]);
          mma_bf16(acc_v[2 * dd + 1], pa, r[2], r[3]);
          ldmatrix_x4_trans(r, qb + swz<D>(key, 2 * dd + (lane >> 4)));
          mma_bf16(acc_k[2 * dd], da, r[0], r[1]);
          mma_bf16(acc_k[2 * dd + 1], da, r[2], r[3]);
        }
      }
    }
  }

  // Epilogue: dK·scale and dV rounded once to bf16, staged in this warp's
  // rows of the K and V tiles (only this warp read them), stored 16 bytes
  // a lane; K rows past S are not written.
  __syncwarp();
  unsigned char* kbuf = smem + L::k;
  unsigned char* vbuf = smem + L::v;
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(kbuf + swz<D>(r, j) + 4 * t) =
          __floats2bfloat162_rn(acc_k[j][2 * h] * scale,
                                acc_k[j][2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vbuf + swz<D>(r, j) + 4 * t) =
          __floats2bfloat162_rn(acc_v[j][2 * h], acc_v[j][2 * h + 1]);
    }
  __syncwarp();
  constexpr int CHUNKS = D / 8;
#pragma unroll
  for (int i = 0; i < 16 * CHUNKS / 32; ++i) {
    const int idx = i * 32 + lane;
    const int r = warp * 16 + idx / CHUNKS, c = idx % CHUNKS;
    const int col = k0 + r;
    if (col < S) {
      const size_t off = head + static_cast<size_t>(col) * D + c * 8;
      *reinterpret_cast<uint4*>(dk + off) =
          *reinterpret_cast<const uint4*>(kbuf + swz<D>(r, c));
      *reinterpret_cast<uint4*>(dv + off) =
          *reinterpret_cast<const uint4*>(vbuf + swz<D>(r, c));
    }
  }
}

template <int D>
struct DqSmem {  // byte offsets
  static constexpr int TILE = 64 * D * 2;
  static constexpr int q = 0;
  static constexpr int d_o = TILE;
  __host__ __device__ static constexpr int k(int st) {
    return 2 * TILE + st * 2 * TILE;
  }
  __host__ __device__ static constexpr int v(int st) {
    return k(st) + TILE;
  }
  static constexpr int bits = 6 * TILE;  // 2 words (64 columns) a K tile
  static size_t bytes(int n_kt) {
    return static_cast<size_t>(bits) + 8u * n_kt;
  }
};

template <int D>
__global__ void __launch_bounds__(NT, 2)
fa_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ d_o,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ kv_mask,
                    __nv_bfloat16* __restrict__ dq, int H, int S,
                    float scale, float scale_log2, int causal) {
  using L = DqSmem<D>;
  constexpr int KS = D / 16;
  constexpr int DT = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned* bits = reinterpret_cast<unsigned*>(smem + L::bits);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = qt * BQ;
  const size_t head = static_cast<size_t>(bh) * S * D;
  const size_t rbase = static_cast<size_t>(bh) * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const uint32_t q_s = smem_addr(smem + L::q);
  const uint32_t o_s = smem_addr(smem + L::d_o);
  const size_t qoff = head + static_cast<size_t>(q0) * D;
  load_tile<D, NT>(q_s, q + qoff, S - q0, tid);
  load_tile<D, NT>(o_s, d_o + qoff, S - q0, tid);
  const int n_cols = causal ? min(S, q0 + BQ) : S;
  const int n_kt = (n_cols + BK - 1) / BK;
  load_tile<D, NT>(smem_addr(smem + L::k(0)), k + head, S, tid);
  load_tile<D, NT>(smem_addr(smem + L::v(0)), v + head, S, tid);
  cp_async_commit();

  // Live columns up to the causal stop, as bits (2 words a K tile).
  const int n_words = 2 * n_kt;
  const float* mrow = kv_mask ? kv_mask + static_cast<size_t>(b) * S : nullptr;
  for (int w0 = warp; w0 < n_words; w0 += NW) {
    const int col = w0 * 32 + lane;
    const float m = col < n_cols ? (mrow ? __ldg(mrow + col) : 1.f) : 0.f;
    const unsigned w = __ballot_sync(0xffffffffu, m > 0.f);
    if (lane == 0) bits[w0] = w;
  }

  const int row_lo = q0 + warp * 16 + g;  // this thread's two rows
  float lse_l2[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    lse_l2[h] = row < S ? __ldg(lse + rbase + row) * LOG2E : 0.f;
    delta_r[h] = row < S ? __ldg(delta + rbase + row) : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    const int k0 = kt * BK;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed (and the bits); the other stage free
    if (kt + 1 < n_kt) {
      const size_t off = head + static_cast<size_t>(k0 + BK) * D;
      load_tile<D, NT>(smem_addr(smem + L::k(st ^ 1)), k + off, S - k0 - BK,
                       tid);
      load_tile<D, NT>(smem_addr(smem + L::v(st ^ 1)), v + off, S - k0 - BK,
                       tid);
      cp_async_commit();
    }
    const uint32_t kb = smem_addr(smem + L::k(st));
    const uint32_t vb = smem_addr(smem + L::v(st));

    // S = q K^T and dP = dO V^T: this warp's 16 rows x the tile's 64 cols
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      const int ar = warp * 16 + (lane & 15), ac = 2 * kk + (lane >> 4);
      ldmatrix_x4(qa, q_s + swz<D>(ar, ac));
      ldmatrix_x4(oa, o_s + swz<D>(ar, ac));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        const int key = 16 * np + (lane & 7) + ((lane >> 4) << 3);
        const int bc = 2 * kk + ((lane >> 3) & 1);
        ldmatrix_x4(r, kb + swz<D>(key, bc));
        mma_bf16(s[2 * np], qa, r[0], r[1]);
        mma_bf16(s[2 * np + 1], qa, r[2], r[3]);
        ldmatrix_x4(r, vb + swz<D>(key, bc));
        mma_bf16(dp[2 * np], oa, r[0], r[1]);
        mma_bf16(dp[2 * np + 1], oa, r[2], r[3]);
      }
    }

    // dS / scale (in dp), f32, P from the live rule
    const unsigned w_lo = bits[2 * kt], w_hi = bits[2 * kt + 1];
    const bool masked = (w_lo & w_hi) != 0xffffffffu ||
                        (causal && kt == qt) || q0 + BQ > S;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = fast_exp2(fmaf(s[j][e], scale_log2, -lse_l2[h]));
        if (masked) {
          const int c = 8 * j + 2 * t + (e & 1);  // column within the tile
          const unsigned w = j < 4 ? w_lo : w_hi;
          const int row = row_lo + 8 * h;
          const bool live = ((w >> (c & 31)) & 1u) && row < S &&
                            (!causal || k0 + c <= row);
          p = live ? p : 0.f;
        }
        dp[j][e] = p * (dp[j][e] - delta_r[h]);
      }

    // dQ += (dS / scale) K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      const int key = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, kb + swz<D>(key, 2 * dd + (lane >> 4)));
        mma_bf16(acc[2 * dd], da, r[0], r[1]);
        mma_bf16(acc[2 * dd + 1], da, r[2], r[3]);
      }
    }
  }

  // Epilogue: dQ·scale rounded once to bf16, staged in this warp's rows of
  // the q tile (only this warp read them), stored 16 bytes a lane.
  __syncwarp();
  unsigned char* qbuf = smem + L::q;
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(qbuf + swz<D>(r, j) + 4 * t) =
          __floats2bfloat162_rn(acc[j][2 * h] * scale,
                                acc[j][2 * h + 1] * scale);
    }
  __syncwarp();
  constexpr int CHUNKS = D / 8;
#pragma unroll
  for (int i = 0; i < 16 * CHUNKS / 32; ++i) {
    const int idx = i * 32 + lane;
    const int r = warp * 16 + idx / CHUNKS, c = idx % CHUNKS;
    const int row = q0 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(dq + head + static_cast<size_t>(row) * D +
                                c * 8) =
          *reinterpret_cast<const uint4*>(qbuf + swz<D>(r, c));
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* lse, const void* d_o, const void* kv_mask,
                      void* dq, void* dk, void* dv, const void* delta, int B,
                      int H, int S, int causal, cudaStream_t stream) {
  auto kv_kern = fa_bwd_dkdv_tc_kernel<D>;
  auto q_kern = fa_bwd_dq_tc_kernel<D>;
  const int n_t = (S + BQ - 1) / BQ;
  const size_t kv_smem = DkdvSmem<D>::bytes;
  const size_t q_smem = DqSmem<D>::bytes(n_t);
  cudaError_t err = sdl::allow_dynamic_smem(kv_kern, kv_smem);
  if (err != cudaSuccess) return err;
  err = sdl::allow_dynamic_smem(q_kern, q_smem);
  if (err != cudaSuccess) return err;
  const double sc = 1.0 / sqrt(static_cast<double>(D));
  const float scale = static_cast<float>(sc);
  const float scale_log2 = static_cast<float>(sc * 1.4426950408889634074);
  const auto* tq = static_cast<const __nv_bfloat16*>(q);
  const auto* tk = static_cast<const __nv_bfloat16*>(k);
  const auto* tv = static_cast<const __nv_bfloat16*>(v);
  const auto* tdo = static_cast<const __nv_bfloat16*>(d_o);
  const auto* flse = static_cast<const float*>(lse);
  const auto* fdelta = static_cast<const float*>(delta);
  const auto* fmask = static_cast<const float*>(kv_mask);
  kv_kern<<<dim3(n_t, B * H), NT, kv_smem, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, fmask, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, S, scale, scale_log2, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kern<<<dim3(n_t, B * H), NT, q_smem, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, fmask, static_cast<__nv_bfloat16*>(dq),
      H, S, scale, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

namespace sdl {

// bf16 q, k, v, d_o, dq, dk, dv [B, H, S, D] contiguous, 16-byte aligned;
// lse and delta [B, H, S] f32 (delta = rowsum(dO * O), already computed on
// the stream); kv_mask [B, S] f32 or NULL. D must be 64 or 128.
cudaError_t flash_attention_bwd_tc_bf16(const void* q, const void* k,
                                        const void* v, const void* lse,
                                        const void* d_o, const void* kv_mask,
                                        void* dq, void* dk, void* dv,
                                        const void* delta, int B, int H,
                                        int S, int D, int causal,
                                        cudaStream_t stream) {
  if (D == 64)
    return launch_tc<64>(q, k, v, lse, d_o, kv_mask, dq, dk, dv, delta, B, H,
                         S, causal, stream);
  if (D == 128)
    return launch_tc<128>(q, k, v, lse, d_o, kv_mask, dq, dk, dv, delta, B,
                          H, S, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace sdl
