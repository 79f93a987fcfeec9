// Paged flash-decode: query tokens attend the KV cache THROUGH a block
// table, straight from the shared pool, for Hopper (sm_90a). f32 or bf16
// queries; f32, bf16, int8 or fp8 (e4m3) pools; f32 math.
//
// Replaces: sparkdl_tpu/ops/paged_flash_decode.py:_paged_decode_kernel
// (the Pallas kernel that paged_flash_decode hands to pl.pallas_call).
// Same contract: q [B, Hq, S, D] (S = 1 is the decode step, S = k+1 the
// speculative verify window); pools [P, Hkv, bs, D] with Hq = rep * Hkv;
// logical position p of slot b lives at pool row (tables[b, p / bs],
// p % bs); query i of slot b attends logical positions
// [pad[b], cur[b] + i], clipped to the table (MB * bs positions). A
// quantized pool holds codes and a [P, Hkv, 2] f32 plane of (K, V)
// scales per (physical block, kv head); the scale folds in after each
// product, (q.k)*s_k and p*(v*s_v), so only the codes are read.
//
// Semantics kept from the TPU kernel: NEG_INF is finite; a row's p is 0
// while its running max is NEG_INF; l = 0 divides by 1, so a row with
// nothing to attend outputs 0. A slot parked on the trash block with
// cur = 0 attends position 0 of the block its table names and returns
// V there: finite garbage the engine discards.
//
// What bounds it on this card: bytes. Each live K/V row is read once per
// row group and feeds 2 * rows * D multiply-adds, far below the H100's
// ~295 operations a byte, so the least time is the live blocks' bytes
// (codes and scales) over 3.35 TB/s.
//
// Design (what it does about that):
// - the loop runs over the logical positions [pad, min(cur + S, MB*bs))
//   only, and each position's pool row is found through the table: the
//   dead tail, the left pad and every block no table names are never
//   read (the TPU kernel's O(cur) contract; there a clamped index map
//   skipped the DMA);
// - one 256-thread block per (slot, kv head, group of up to RT query
//   rows), the rows being (query i, GQA member g) pairs flattened as
//   i * rep + g. RT is a template parameter (1, 2, 4 or 8) that bounds
//   the registers; the decode step (S = 1, rep <= 8) and a verify
//   window with S * rep <= 8 fit one group, so each K/V row is read
//   once; a larger window splits into ceil(S*rep / 8) groups that each
//   read the rows again (mostly from L2);
// - a warp reads one pool row with all 32 lanes (D/32 contiguous
//   elements a lane, one vector load) and keeps UNROLL rows in flight;
//   the 8 warps interleave over positions, each with its own f32 online
//   softmax per query row, and a log-sum-exp combine in shared memory
//   merges them;
// - not done yet: splitting the positions of one slot across blocks
//   (vLLM's v2 scheme), wgmma and TMA. At LlamaConfig.small's decode
//   step (8 slots, 8 kv heads) the grid is 64 blocks on 132 SMs.
#include "common.cuh"

#include <cuda_fp8.h>
#include <stdint.h>

namespace {

using sdl::NEG_INF;

constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr int UNROLL = 4;  // pool rows in flight per warp

// N consecutive pool elements from an aligned address, as f32 (codes are
// returned as their values; the caller applies the block's scale).
template <int N>
__device__ __forceinline__ void load_pool(const float* p, float* out) {
  sdl::load_vec<N>(p, out);
}
template <int N>
__device__ __forceinline__ void load_pool(const __nv_bfloat16* p, float* out) {
  sdl::load_vec<N>(p, out);
}
template <int N>
__device__ __forceinline__ void load_pool(const int8_t* p, float* out) {
  if constexpr (N == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
  } else {
    static_assert(N == 2, "N must be 2 or 4");
    const char2 c = *reinterpret_cast<const char2*>(p);
    out[0] = c.x; out[1] = c.y;
  }
}
template <int N>
__device__ __forceinline__ void load_pool(const __nv_fp8_e4m3* p, float* out) {
  static_assert(N == 2 || N == 4, "N must be 2 or 4");
  const uint32_t w = N == 4 ? *reinterpret_cast<const uint32_t*>(p)
                            : *reinterpret_cast<const uint16_t*>(p);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const __half_raw hr = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>((w >> (8 * e)) & 0xffu), __NV_E4M3);
    out[e] = __half2float(__half(hr));  // e4m3 -> f16 is exact
  }
}

template <typename T> struct is_code { static constexpr bool value = false; };
template <> struct is_code<int8_t> { static constexpr bool value = true; };
template <> struct is_code<__nv_fp8_e4m3> { static constexpr bool value = true; };

template <typename TQ, typename TK, int D, int RT>
__global__ void __launch_bounds__(NT)
pfd_kernel(const TQ* __restrict__ q, const TK* __restrict__ kp,
           const TK* __restrict__ vp, const float* __restrict__ scales,
           const int* __restrict__ tables, const int* __restrict__ cur,
           const int* __restrict__ pad, TQ* __restrict__ o, int Hkv, int rep,
           int S, int bs, int MB, float sm_scale) {
  constexpr int EPL = D / 32;  // elements per lane
  constexpr bool QUANT = is_code<TK>::value;
  __shared__ float sm_m[WARPS][RT], sm_l[WARPS][RT];
  __shared__ float sm_acc[WARPS][RT][D];

  const int bh = blockIdx.x;  // slot * Hkv + kv head
  const int b = bh / Hkv, h = bh % Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = S * rep, Hq = Hkv * rep;
  const int c = cur[b];
  const int start = pad ? max(pad[b], 0) : 0;
  const int end = min(c + S, MB * bs);  // the last query attends cur + S - 1

  // Row r = i * rep + g of this block's group: query i of head h*rep + g.
  // lim[g] is the last position the row attends; -1 for a padding row.
  float qr[RT][EPL], acc[RT][EPL], m[RT], l[RT];
  int lim[RT];
#pragma unroll
  for (int g = 0; g < RT; ++g) {
    const int r = blockIdx.y * RT + g;
    m[g] = NEG_INF;
    l[g] = 0.f;
    lim[g] = -1;
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = acc[g][e] = 0.f;
    if (r < R) {
      const int i = r / rep, head = h * rep + r % rep;
      lim[g] = c + i;
      sdl::load_vec<EPL>(
          q + ((static_cast<size_t>(b) * Hq + head) * S + i) * D + lane * EPL,
          qr[g]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] *= sm_scale;
    }
  }

  const int* tbl = tables + static_cast<size_t>(b) * MB;
  for (int p0 = start + warp * UNROLL; p0 < end; p0 += WARPS * UNROLL) {
    float kr[UNROLL][EPL], vr[UNROLL][EPL], sk[UNROLL], sv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + u;
      sk[u] = sv[u] = 1.f;
      if (p < end) {
        const int blk = tbl[p / bs];  // the pool block the table names
        const size_t row =
            ((static_cast<size_t>(blk) * Hkv + h) * bs + p % bs) * D + lane * EPL;
        load_pool<EPL>(kp + row, kr[u]);
        load_pool<EPL>(vp + row, vr[u]);
        if constexpr (QUANT) {
          const float2 s =
              *reinterpret_cast<const float2*>(scales + (static_cast<size_t>(blk) * Hkv + h) * 2);
          sk[u] = s.x;
          sv[u] = s.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < RT; ++g) {
      float s[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) a = fmaf(qr[g][e], kr[u][e], a);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        const int p = p0 + u;
        s[u] = (p < end && p <= lim[g]) ? a * sk[u] : NEG_INF;
      }
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mx = fmaxf(mx, s[u]);
      // while mx is NEG_INF nothing is live yet: alpha = 1 and every p
      // is 0, so the state stays (NEG_INF, 0, 0)
      const float alpha = expf(m[g] - mx);
      float pr[UNROLL], sum = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        pr[u] = s[u] > NEG_INF ? expf(s[u] - mx) : 0.f;
        sum += pr[u];
        pr[u] *= sv[u];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) a = fmaf(pr[u], vr[u][e], a);
        acc[g][e] = a;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < RT; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();

  // Log-sum-exp combine of the warps' partial softmaxes. A warp that saw
  // nothing live for a row has m = NEG_INF and l = acc = 0, so it adds
  // nothing; a row with nothing live at all ends with l = 0 and outputs 0.
  for (int idx = threadIdx.x; idx < RT * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    const int r = blockIdx.y * RT + g;
    if (r >= R) continue;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float cw = expf(sm_m[w][g] - mx);
      lsum = fmaf(sm_l[w][g], cw, lsum);
      num = fmaf(sm_acc[w][g][d], cw, num);
    }
    const float safe_l = lsum > 0.f ? lsum : 1.f;
    const int i = r / rep, head = h * rep + r % rep;
    o[((static_cast<size_t>(b) * Hq + head) * S + i) * D + d] =
        sdl::from_float<TQ>(num / safe_l);
  }
}

template <typename TQ, typename TK, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const float* scales, const int* tables, const int* cur,
                     const int* pad, void* o, int B, int Hkv, int rep, int S,
                     int bs, int MB, cudaStream_t st) {
  const float sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const auto* qq = static_cast<const TQ*>(q);
  const auto* kk = static_cast<const TK*>(k);
  const auto* vv = static_cast<const TK*>(v);
  auto* oo = static_cast<TQ*>(o);
  const int R = S * rep;
  const int rt = R <= 1 ? 1 : R <= 2 ? 2 : R <= 4 ? 4 : 8;
  const dim3 grid(B * Hkv, (R + rt - 1) / rt);
#define SDL_PFD_LAUNCH(RT_)                                                    \
  pfd_kernel<TQ, TK, D, RT_><<<grid, NT, 0, st>>>(qq, kk, vv, scales, tables, \
                                                  cur, pad, oo, Hkv, rep, S,  \
                                                  bs, MB, sm_scale)
  switch (rt) {
    case 1: SDL_PFD_LAUNCH(1); break;
    case 2: SDL_PFD_LAUNCH(2); break;
    case 4: SDL_PFD_LAUNCH(4); break;
    default: SDL_PFD_LAUNCH(8); break;
  }
#undef SDL_PFD_LAUNCH
  return cudaGetLastError();
}

template <typename TQ, typename TK>
cudaError_t launch_t(int D, const void* q, const void* k, const void* v,
                     const float* scales, const int* tables, const int* cur,
                     const int* pad, void* o, int B, int Hkv, int rep, int S,
                     int bs, int MB, cudaStream_t st) {
  if (D == 64)
    return launch_d<TQ, TK, 64>(q, k, v, scales, tables, cur, pad, o, B, Hkv,
                                rep, S, bs, MB, st);
  if (D == 128)
    return launch_d<TQ, TK, 128>(q, k, v, scales, tables, cur, pad, o, B, Hkv,
                                 rep, S, bs, MB, st);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_q(int kv_kind, int D, const void* q, const void* k,
                     const void* v, const float* scales, const int* tables,
                     const int* cur, const int* pad, void* o, int B, int Hkv,
                     int rep, int S, int bs, int MB, cudaStream_t st) {
  switch (kv_kind) {
    case 0: return launch_t<TQ, TQ>(D, q, k, v, scales, tables, cur, pad, o, B,
                                    Hkv, rep, S, bs, MB, st);
    case 1: return launch_t<TQ, int8_t>(D, q, k, v, scales, tables, cur, pad,
                                        o, B, Hkv, rep, S, bs, MB, st);
    case 2: return launch_t<TQ, __nv_fp8_e4m3>(D, q, k, v, scales, tables, cur,
                                               pad, o, B, Hkv, rep, S, bs, MB,
                                               st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: [B, Hkv*rep, S, D], f32 (is_bf16 = 0) or bf16; k, v pools:
// [P, Hkv, bs, D] in q's type (kv_kind 0), int8 codes (1) or e4m3 codes
// (2); scales: [P, Hkv, 2] f32 for kv_kind 1 and 2, else NULL; tables:
// [B, MB] int32 pool block ids, each in [0, P); cur: [B] int32; pad: [B]
// int32 or NULL. All contiguous. D must be 64 or 128.
extern "C" int sdl_paged_flash_decode(const void* q, const void* k,
                                      const void* v, const void* scales,
                                      const void* tables, const void* cur,
                                      const void* pad, void* o, int B, int Hkv,
                                      int rep, int S, int D, int bs, int MB,
                                      int is_bf16, int kv_kind, void* stream) {
  if (B <= 0 || Hkv <= 0 || S <= 0) return cudaSuccess;
  if (rep <= 0 || bs <= 0 || MB <= 0) return cudaErrorInvalidValue;
  if ((kv_kind != 0) != (scales != nullptr)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scales);
  const auto* tb = static_cast<const int*>(tables);
  const auto* cu = static_cast<const int*>(cur);
  const auto* pd = static_cast<const int*>(pad);
  return is_bf16
      ? launch_q<__nv_bfloat16>(kv_kind, D, q, k, v, sc, tb, cu, pd, o, B, Hkv,
                                rep, S, bs, MB, st)
      : launch_q<float>(kv_kind, D, q, k, v, sc, tb, cu, pd, o, B, Hkv, rep, S,
                        bs, MB, st);
}
