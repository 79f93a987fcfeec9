// Flash-attention forward for Hopper's tensor cores (sm_90a), bf16 in and
// out, f32 softmax: the "tc_mma_bf16" variant of flash_attention.
//
// Replaces: sparkdl_tpu/ops/flash_attention.py:_fwd_kernel (the Pallas
// kernel that _fwd hands to pl.pallas_call) for bf16 inputs; f32 inputs
// keep the CUDA-core kernel in flash_attention.cu, which also holds the C
// entry point that picks between the two. Same contract: q, k, v
// [B, H, S, D]; optional [B, S] 0/1 kv_mask; optional causal mask; O in
// bf16 and the per-row logsumexp in f32. A score is live when col < S,
// kv_mask[col] > 0 and (causal) col <= row; a dead score is NEG_INF (finite);
// p is 0 while the row max is still NEG_INF; l == 0 divides by 1, so a
// fully-masked row gives O = 0 and lse = NEG_INF exactly.
//
// What bounds it on this card: at the prefill shapes of the port's main
// path (B = 4, H = 16, S = 2048, D = 128, causal, left pads 0, 548, 1348,
// 2015) the live work is 28.4 GFLOP against ~87 MB that the function must
// move, about 330 operations a byte, above the H100's bf16 ridge (~295):
// the bound is the tensor-core rate, 0.0287 ms (operations).
//
// What the design does about that bound:
// - both products run on the tensor cores, mma.sync.m16n8k16 bf16 with f32
//   accumulation (products exact, sums in f32). The 1/sqrt(D) scale (with
//   log2(e) folded in, for ex2) multiplies the f32 scores, never bf16 Q;
// - one 128-thread block (4 warps, 16 Q rows each) per (64-row Q tile,
//   b·h), heaviest causal tiles first. The Q tile lands in shared memory
//   once (cp.async) and lives in registers as mma A fragments (ldmatrix)
//   for the whole K loop;
// - K/V tiles of 64 rows stream through a 2-stage cp.async ring (16-byte
//   copies, tile t+1 in flight while tile t is computed, one barrier a
//   tile); rows are
//   XOR-swizzled in 16-byte chunks so ldmatrix (K) and ldmatrix.trans (V)
//   read without bank conflicts. Rows past S are zero-filled by cp.async's
//   src-size operand, nothing is padded in device memory. 80 KB of shared
//   memory at D = 128: two blocks an SM;
// - online softmax in registers: a thread holds two rows of each m16
//   fragment, so a row max or sum is two quad shuffles; l sums the f32 p;
//   P goes from the accumulator layout straight into the bf16 A fragments
//   of P·V (one rounding of p to bf16, the only one the tensor cores add);
// - dead-tile skip: the block first turns row b of kv_mask (up to its
//   causal stop) into a bitmask and a list of the K tiles with a live
//   column, and loops over that list only. A tile with no live column
//   changes nothing in the JAX kernel (every p is 0 and alpha is 1), so
//   the skip is exact; a Q tile with no live score loads no K/V at all.
//   Element masks run only on the diagonal tile and on tiles with a dead
//   column (the ragged edge, padding);
// - the epilogue divides by l once, rounds to bf16 once and stores O with
//   16-byte stores through the (by then free) Q buffer.
#include <stdint.h>

#include "common.cuh"
#include "mma_sync.cuh"

namespace {

using sdl::NEG_INF;
using namespace sdl::tc;

constexpr int BQ = 64;  // Q rows per block (16 per warp)
constexpr int BK = 64;  // K/V rows per tile (== BQ: the causal stop is qt)
constexpr int NW = 4;
constexpr int NT = NW * 32;
constexpr unsigned FULL_TILE = 0x80000000u;  // list flag: every column live
constexpr float LN2 = 0.69314718055994530942f;

template <int D>
struct TcSmem {  // byte offsets
  static constexpr int ROW = D * 2;         // one bf16 row
  static constexpr int TILE = 64 * ROW;     // one 64-row tile
  static constexpr int q = 0;
  static constexpr int k = q + TILE;        // 2 stages
  static constexpr int v = k + 2 * TILE;    // 2 stages
  static constexpr int bits = v + 2 * TILE;  // 2 words (64 columns) a K tile
  static size_t bytes(int n_kt) {
    // bits, then the live-tile list, then its length
    return static_cast<size_t>(bits) + 8u * n_kt + 4u * n_kt + 16u;
  }
};

template <int D>
__global__ void __launch_bounds__(NT, 2)
fa_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ kv_mask,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int* __restrict__ tiles, int H, int S, float scale_log2,
                 int causal) {
  using L = TcSmem<D>;
  constexpr int KS = D / 16;  // k16 steps of Q·K^T
  constexpr int DT = D / 8;   // n8 tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned* bits = reinterpret_cast<unsigned*>(smem + L::bits);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = qt * BQ;
  const size_t head = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair

  const uint32_t q_s = smem_addr(smem + L::q);
  const uint32_t k_s = smem_addr(smem + L::k);
  const uint32_t v_s = smem_addr(smem + L::v);

  load_tile<D, NT>(q_s, q + head + static_cast<size_t>(q0) * D, S - q0, tid);
  cp_async_commit();

  // Live columns up to the causal stop, as bits (2 words a K tile), then
  // the list of K tiles with a live column (FULL_TILE: all 64 live).
  const int n_cols = causal ? min(S, q0 + BQ) : S;
  const int n_kt = (n_cols + BK - 1) / BK;
  const int n_words = 2 * n_kt;
  unsigned* list = bits + n_words;
  int* n_list = reinterpret_cast<int*>(list + n_kt);
  const float* mrow = kv_mask ? kv_mask + static_cast<size_t>(b) * S : nullptr;
  for (int w0 = warp; w0 < n_words; w0 += 4 * NW) {
    float mv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = (w0 + u * NW) * 32 + lane;
      mv[u] = col < n_cols ? (mrow ? __ldg(mrow + col) : 1.f) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned w = __ballot_sync(0xffffffffu, mv[u] > 0.f);
      if (lane == 0 && w0 + u * NW < n_words) bits[w0 + u * NW] = w;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int t0 = 0; t0 < n_kt; t0 += 32) {
      const int kt = t0 + lane;
      const unsigned a = kt < n_kt ? bits[2 * kt] : 0u;
      const unsigned c = kt < n_kt ? bits[2 * kt + 1] : 0u;
      const bool any = (a | c) != 0u;
      const unsigned live = __ballot_sync(0xffffffffu, any);
      if (any)
        list[count + __popc(live & ((1u << lane) - 1u))] =
            static_cast<unsigned>(kt) | ((a & c) == 0xffffffffu ? FULL_TILE : 0u);
      count += __popc(live);
    }
    if (lane == 0) *n_list = count;
  }
  __syncthreads();
  const int n_live = *n_list;

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // rows g and g + 8, log2 units
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sum
  uint32_t qf[KS][4];

  const int row_lo = q0 + warp * 16 + g;  // this thread's two rows
  if (n_live > 0) {
    const int kt0 = static_cast<int>(list[0] & ~FULL_TILE);
    load_tile<D, NT>(k_s, k + head + static_cast<size_t>(kt0) * BK * D,
                 S - kt0 * BK, tid);
    load_tile<D, NT>(v_s, v + head + static_cast<size_t>(kt0) * BK * D,
                 S - kt0 * BK, tid);
    cp_async_commit();
  }

  int walked = 0;  // K tiles this block computed, for `tiles`
  for (int i = 0; i < n_live; ++i, ++walked) {
    const unsigned ent = list[i];
    const int kt = static_cast<int>(ent & ~FULL_TILE);
    const int k0 = kt * BK;
    const int st = i & 1;
    cp_async_wait_all();
    __syncthreads();  // tile i landed; every warp is done with the other stage
    if (i + 1 < n_live) {  // the next live tile, into the other stage
      const int kn = static_cast<int>(list[i + 1] & ~FULL_TILE);
      load_tile<D, NT>(k_s + (st ^ 1) * L::TILE,
                   k + head + static_cast<size_t>(kn) * BK * D, S - kn * BK,
                   tid);
      load_tile<D, NT>(v_s + (st ^ 1) * L::TILE,
                   v + head + static_cast<size_t>(kn) * BK * D, S - kn * BK,
                   tid);
      cp_async_commit();
    }

    if (i == 0) {  // Q fragments, once: rows warp*16 .. +15
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int r = warp * 16 + (lane & 15);
        ldmatrix_x4(qf[kk], q_s + swz<D>(r, 2 * kk + (lane >> 4)));
      }
    }

    // S = Q · K^T for this warp's 16 rows and the tile's 64 columns
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const uint32_t kb = k_s + st * L::TILE;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        const int key = 16 * np + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(r, kb + swz<D>(key, 2 * kk + ((lane >> 3) & 1)));
        mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    // Scale (log2 units), mask where needed, online softmax.
    const bool masked = !(ent & FULL_TILE) || (causal && kt == qt);
    const unsigned w_lo = bits[2 * kt], w_hi = bits[2 * kt + 1];
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int c = 8 * j + 2 * t + (e & 1);  // column within the tile
          const unsigned w = j < 4 ? w_lo : w_hi;
          bool live = (w >> (c & 31)) & 1u;
          if (causal) live = live && k0 + c <= row_lo + 8 * (e >> 1);
          x = live ? x : NEG_INF;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      alpha[h] = fast_exp2(m_r[h] - m_new);
      m_r[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = m_r[h] <= NEG_INF ? 0.f : fast_exp2(s[j][e] - m_r[h]);
        s[j][e] = p;
        sum[h] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + sum[h];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P · V: P from the accumulators into bf16 A fragments
    const uint32_t vb = v_s + st * L::TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vb + swz<D>(key, 2 * dp + (lane >> 4)));
        mma_bf16(acc[2 * dp], pa, r[0], r[1]);
        mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
      }
    }
  }

  // Epilogue: the row sums across the quad, O / l rounded once to bf16,
  // staged in this warp's rows of the Q buffer, stored 16 bytes a lane.
  cp_async_wait_all();  // a dead Q tile never waited for its Q copies
  __syncthreads();
  if (tiles != nullptr && tid == 0) atomicAdd(tiles, walked);
  float safe_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    safe_l[h] = l > 0.f ? l : 1.f;  // fully-masked rows
    const int row = row_lo + 8 * h;
    if (t == 0 && row < S)
      lse[static_cast<size_t>(bh) * S + row] =
          m_r[h] <= NEG_INF ? NEG_INF : (m_r[h] + log2f(safe_l[h])) * LN2;
  }
  unsigned char* qbuf = smem + L::q;
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(qbuf + swz<D>(r, j) + 4 * t) =
          __floats2bfloat162_rn(acc[j][2 * h] / safe_l[h],
                                acc[j][2 * h + 1] / safe_l[h]);
    }
  __syncwarp();
  constexpr int CHUNKS = D / 8;
#pragma unroll
  for (int i = 0; i < 16 * CHUNKS / 32; ++i) {
    const int idx = i * 32 + lane;
    const int r = warp * 16 + idx / CHUNKS, c = idx % CHUNKS;
    const int row = q0 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(o + head + static_cast<size_t>(row) * D +
                                c * 8) =
          *reinterpret_cast<const uint4*>(qbuf + swz<D>(r, c));
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* kv_mask, void* o, void* lse, int* tiles,
                      int B, int H, int S, int causal, cudaStream_t stream) {
  auto kern = fa_fwd_tc_kernel<D>;
  const int n_qt = (S + BQ - 1) / BQ;
  const size_t smem = TcSmem<D>::bytes(n_qt);  // n_kt <= n_qt (BK == BQ)
  cudaError_t err = sdl::allow_dynamic_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = static_cast<float>(
      1.4426950408889634074 / sqrt(static_cast<double>(D)));
  kern<<<dim3(n_qt, B * H), NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(kv_mask),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), tiles, H, S,
      scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

namespace sdl {

// bf16 q, k, v, o [B, H, S, D] contiguous, 16-byte aligned; kv_mask [B, S]
// f32 or NULL; lse [B, H, S] f32. D must be 64 or 128. tiles: int32 or
// NULL; each block adds the K tiles it computed (checks of the skip).
cudaError_t flash_attention_tc_bf16(const void* q, const void* k,
                                    const void* v, const void* kv_mask,
                                    void* o, void* lse, int* tiles, int B,
                                    int H, int S, int D, int causal,
                                    cudaStream_t stream) {
  if (D == 64)
    return launch_tc<64>(q, k, v, kv_mask, o, lse, tiles, B, H, S, causal,
                         stream);
  if (D == 128)
    return launch_tc<128>(q, k, v, kv_mask, o, lse, tiles, B, H, S, causal,
                          stream);
  return cudaErrorInvalidValue;
}

}  // namespace sdl
