// Flash-decode: one query token per row against a contiguous KV cache,
// for Hopper (sm_90a), f32 or bf16 in, f32 math.
//
// Replaces: sparkdl_tpu/ops/flash_decode.py:_decode_kernel (the Pallas
// kernel that flash_decode hands to pl.pallas_call). Same contract: q
// [B, Hq, 1, D]; k, v caches [B, Hkv, L, D] with Hq = rep * Hkv (GQA);
// row b attends cache slots [pad[b], cur[b]) — cur is one scalar for all
// rows or a [B] vector; a row with nothing live outputs 0.
//
// What bounds it on this card: bytes. Each live K/V row is read once and
// used for 2 * rep * D multiply-adds, a few operations a byte against the
// H100's ~295-a-byte ridge, so the least time is the live cache bytes
// over 3.35 TB/s.
//
// Design (what it does about that):
// - the loop runs over [pad[b], cur[b]) ONLY: the dead tail past cur and
//   the left pad are never read, which keeps the TPU kernel's O(cur) byte
//   contract (there a clamped index map skipped the DMA);
// - one 256-thread block per (b, kv head) holds that head's rep query
//   rows, so each K/V row is read once for the whole GQA group, with no
//   repeat of the cache;
// - a warp reads one cache row with all 32 lanes (D/32 contiguous
//   elements a lane, one vector load) and keeps 4 rows in flight; the 8
//   warps interleave over positions, each with its own f32 online
//   softmax, and a log-sum-exp combine in shared memory merges them;
// - not done yet: splitting L across blocks. At the port's main-path
//   batch (B = 4, Hkv = 8) this grid is 32 blocks on 132 SMs, which
//   leaves most of the card's bandwidth unused; a split-KV pass with a
//   second combine kernel is the next step (PERF.md).
#include "common.cuh"

namespace {

using sdl::NEG_INF;

constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr int UNROLL = 4;  // cache rows in flight per warp

template <typename T, int D, int REP>
__global__ void __launch_bounds__(NT)
fd_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          const int* __restrict__ cur_vec, int cur_scalar,
          const int* __restrict__ pad, int Hkv, int L, float sm_scale) {
  constexpr int EPL = D / 32;  // elements per lane
  __shared__ float sm_m[WARPS][REP], sm_l[WARPS][REP];
  __shared__ float sm_acc[WARPS][REP][D];

  const int bh = blockIdx.x;  // b * Hkv + kv head
  const int b = bh / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int start = pad ? max(pad[b], 0) : 0;
  const int end = min(cur_vec ? cur_vec[b] : cur_scalar, L);

  // This kv head's query group is rows bh*REP .. bh*REP+REP-1 of the
  // flattened [B*Hq, D] queries (Hq = Hkv * REP).
  float qr[REP][EPL], acc[REP][EPL], m[REP], l[REP];
#pragma unroll
  for (int g = 0; g < REP; ++g) {
    sdl::load_vec<EPL>(q + (static_cast<size_t>(bh) * REP + g) * D + lane * EPL,
                       qr[g]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[g][e] *= sm_scale;
      acc[g][e] = 0.f;
    }
    m[g] = NEG_INF;
    l[g] = 0.f;
  }

  const T* kb = k + static_cast<size_t>(bh) * L * D + lane * EPL;
  const T* vb = v + static_cast<size_t>(bh) * L * D + lane * EPL;
  for (int p0 = start + warp * UNROLL; p0 < end; p0 += WARPS * UNROLL) {
    float kr[UNROLL][EPL], vr[UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p0 + u < end) {
        sdl::load_vec<EPL>(kb + static_cast<size_t>(p0 + u) * D, kr[u]);
        sdl::load_vec<EPL>(vb + static_cast<size_t>(p0 + u) * D, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < REP; ++g) {
      float s[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) a = fmaf(qr[g][e], kr[u][e], a);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        s[u] = p0 + u < end ? a : NEG_INF;
      }
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mx = fmaxf(mx, s[u]);
      // p0 < end, so s[0] is live and mx is a real score from here on
      const float alpha = expf(m[g] - mx);
      float p[UNROLL], sum = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        p[u] = p0 + u < end ? expf(s[u] - mx) : 0.f;
        sum += p[u];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) a = fmaf(p[u], vr[u][e], a);
        acc[g][e] = a;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < REP; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();

  // Log-sum-exp combine of the warps' partial softmaxes. A warp that saw
  // no live slot has m = NEG_INF and l = acc = 0, so it adds nothing; a
  // row with no live slot at all ends with l = 0 and outputs 0.
  for (int idx = threadIdx.x; idx < REP * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum = fmaf(sm_l[w][g], c, lsum);
      num = fmaf(sm_acc[w][g][d], c, num);
    }
    const float safe_l = lsum > 0.f ? lsum : 1.f;
    o[(static_cast<size_t>(bh) * REP + g) * D + d] = sdl::from_float<T>(num / safe_l);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     const int* cur, int cur_scalar, const int* pad, int B,
                     int Hkv, int rep, int L, cudaStream_t st) {
  const float sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const auto* qq = static_cast<const T*>(q);
  const auto* kk = static_cast<const T*>(k);
  const auto* vv = static_cast<const T*>(v);
  auto* oo = static_cast<T*>(o);
  const int grid = B * Hkv;
  switch (rep) {
    case 1: fd_kernel<T, D, 1><<<grid, NT, 0, st>>>(qq, kk, vv, oo, cur, cur_scalar, pad, Hkv, L, sm_scale); break;
    case 2: fd_kernel<T, D, 2><<<grid, NT, 0, st>>>(qq, kk, vv, oo, cur, cur_scalar, pad, Hkv, L, sm_scale); break;
    case 4: fd_kernel<T, D, 4><<<grid, NT, 0, st>>>(qq, kk, vv, oo, cur, cur_scalar, pad, Hkv, L, sm_scale); break;
    case 8: fd_kernel<T, D, 8><<<grid, NT, 0, st>>>(qq, kk, vv, oo, cur, cur_scalar, pad, Hkv, L, sm_scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, o: [B, Hkv*rep, 1, D]; k, v: [B, Hkv, L, D]; all contiguous, f32
// (is_bf16 = 0) or bf16. cur: [B] int32, or NULL to use cur_scalar for
// every row. pad: [B] int32 or NULL (no left pad). D must be 64 or 128,
// rep 1, 2, 4 or 8.
extern "C" int sdl_flash_decode(const void* q, const void* k, const void* v,
                                void* o, const void* cur, int cur_scalar,
                                const void* pad, int B, int Hkv, int rep,
                                int L, int D, int is_bf16, void* stream) {
  if (B <= 0 || Hkv <= 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cur);
  const int* p = static_cast<const int*>(pad);
  if (D == 64)
    return is_bf16 ? launch_d<__nv_bfloat16, 64>(q, k, v, o, c, cur_scalar, p, B, Hkv, rep, L, st)
                   : launch_d<float, 64>(q, k, v, o, c, cur_scalar, p, B, Hkv, rep, L, st);
  if (D == 128)
    return is_bf16 ? launch_d<__nv_bfloat16, 128>(q, k, v, o, c, cur_scalar, p, B, Hkv, rep, L, st)
                   : launch_d<float, 128>(q, k, v, o, c, cur_scalar, p, B, Hkv, rep, L, st);
  return cudaErrorInvalidValue;
}
