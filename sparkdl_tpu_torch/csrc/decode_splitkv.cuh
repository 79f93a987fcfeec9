// Split-KV decode attention for Hopper (sm_90a): the device template that
// csrc/flash_decode.cu (contiguous cache) and csrc/paged_flash_decode.cu
// (block-table pool) instantiate.
//
// What it computes: query row r = i * rep + g of (slot b, kv head h) is
// query i of head h * rep + g; it attends positions [start, last + i],
// start = max(pad[b], 0), clipped to the npos positions the cache or the
// table holds. The paged kernel's last is cur[b]; flash_decode's is
// cur[b] - 1 (its cur is exclusive) with S = 1. f32 math throughout, and
// the TPU kernels' semantics: NEG_INF is finite; p is 0 while a row's
// running max is NEG_INF; l = 0 divides by 1, so a row with nothing to
// attend outputs 0; quantized scales fold in after each product,
// (q.k) * s_k and p * (v * s_v).
//
// What bounds it: bytes. Each live K/V row is read once per row group and
// feeds 2 * rows * D multiply-adds, far below the H100's ~295 operations
// a byte, so the least time is the live rows' bytes (plus one scale pair
// per live page) over 3.35 TB/s.
//
// Design:
// - Grid (B * Hkv * groups, n_splits). A row group holds rt query rows
//   (1 or 2); n_splits = ceil(npos / chunk). The caller's plan
//   (ops/flash_decode.split_plan) picks rt and chunk from static shapes
//   only, never from cur, which lies on the device: the grid of a
//   captured CUDA graph stays right when cur changes; launch() checks
//   them against what this kernel was built for. A block whose chunk
//   lies wholly outside [start, end) is an empty partial (m = NEG_INF,
//   l = 0, which weighs 0 in the merge): it reads no K/V, writes nothing
//   and leaves at once. A block whose accumulator is at most 16 floats a
//   thread is held to 64 registers, so that 4 of them (32 warps) share an
//   SM.
// - A block's q rows and its chunk's table entries are loaded together
//   with cur and pad, before the block knows whether it is live; a live
//   block then turns its chunk's positions into pool row indices (and,
//   for codes, the pages' (s_k, s_v), while the first tiles load) in
//   shared memory, so the streaming loop does no dependent load and no
//   division.
// - A tile is 16 bytes a thread (4 KB of K and 4 KB of V for 256 threads)
//   and streams through a ring of NST stages with cp.async; a position
//   outside [start, end) is zero-filled instead of read, so whatever it
//   holds, NaN included, never reaches the math, and a left pad or dead
//   tail inside a page is masked, not skipped row by row.
// - Each thread owns the 16-byte slot of the ring it copies into: key
//   slot j = tid / CPR of every tile, columns (tid % CPR) * EPC .. + EPC.
//   It reads only that slot, so its own cp.async.wait_group is all the
//   streaming loop waits for: no barrier while streaming. The CPR lanes
//   of a key reduce its scores with log2(CPR) shuffles (4 for bf16 at
//   D 128), and each thread keeps its own online softmax (log2 units)
//   over the keys it owns (rescaled only when its max rises). After the
//   chunk, the key slots of a warp merge by shuffles and the 8 warps
//   through shared memory.
// - Combine in the same launch: each live block writes (m, l, acc[D]) for
//   its rows to a workspace, __threadfence(), and bumps the group's
//   counter; the live block that arrives last (every block computes the
//   number of live splits from cur and pad) merges the live partials in
//   split index order (bitwise independent of arrival order), writes O,
//   and resets the counter to 0 for the next launch. A group with one
//   live split writes O from that block (the merge of one partial is the
//   partial, bit for bit), and a group with nothing live at all has its
//   zero output written by split 0.
// - For checks, an optional int32[2] (NULL on the main path) counts the
//   blocks that ran and those that found a live position, one atomic
//   each.
//
// The counters are a zeroed int32 buffer per group that the wrapper keeps
// per device; the kernel leaves them at 0. A refused launch never runs and
// never touches them; a fault inside the kernel leaves the CUDA context
// unusable, so a stale count is never observed. Two launches running at
// once on two streams must not share a counter buffer (the port issues
// every call on PyTorch's current stream).
#pragma once

#include "common.cuh"

#include <cuda_fp8.h>
#include <stdint.h>

namespace sdl {
namespace splitkv {

constexpr int NT = 256;                  // threads a block
constexpr int WARPS = NT / 32;
constexpr int TILE_BYTES = NT * 16;      // one K (or V) tile
constexpr int NST = 4;                   // ring stages
constexpr int RING_FLOATS = 2 * NST * TILE_BYTES / 4;
constexpr int MAX_CHUNK = 512;           // positions a split, at most
constexpr int MAX_RT = 2;                // query rows a block, at most

template <typename T> struct Elt;  // elements in 16 bytes, code or not
template <> struct Elt<float> { static constexpr int N = 4; static constexpr bool CODE = false; };
template <> struct Elt<__nv_bfloat16> { static constexpr int N = 8; static constexpr bool CODE = false; };
template <> struct Elt<int8_t> { static constexpr int N = 16; static constexpr bool CODE = true; };
template <> struct Elt<__nv_fp8_e4m3> { static constexpr int N = 16; static constexpr bool CODE = true; };

// 16 bytes of T (as read from shared memory) as f32 values; codes are
// returned as their values, the page's scale is applied by the caller.
__device__ __forceinline__ void unpack(float, const uint4& w, float* out) {
  out[0] = __uint_as_float(w.x); out[1] = __uint_as_float(w.y);
  out[2] = __uint_as_float(w.z); out[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(__nv_bfloat16, const uint4& w, float* out) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ws[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(int8_t, const uint4& w, float* out) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)  // sign-extend byte i % 4 of word i / 4
    out[i] = static_cast<float>(static_cast<int>(ws[i / 4] << (24 - 8 * (i % 4))) >> 24);
}
__device__ __forceinline__ void unpack(__nv_fp8_e4m3, const uint4& w, float* out) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __half_raw hr = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>((ws[i / 4] >> (8 * (i % 4))) & 0xffu), __NV_E4M3);
    out[i] = __half2float(__half(hr));  // e4m3 -> f16 is exact
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Params {
  const void* q;         // [B, Hkv * rep, S, D], TQ
  const void* k;         // pool [P, Hkv, bs, D] or cache [B, Hkv, L, D], TK
  const void* v;
  const float* scales;   // [P, Hkv, 2] for code pools, else NULL
  const int* tables;     // [B, MB] (table pages only)
  const int* cur;        // [B], or NULL for cur_scalar (contiguous only)
  int cur_scalar;
  const int* pad;        // [B] or NULL
  void* o;               // like q
  float* ws;             // workspace, ws_floats(...) floats
  int* counters;         // [B * Hkv * groups] int32, zero between launches
  int* blocks;           // NULL, or [2]: += blocks run, blocks live
  int Hkv, rep, S, bs, MB, L;
  int npos, chunk, n_splits, groups;
  float qscale;          // 1 / sqrt(D) * log2(e): scores in log2 units
};

// Workspace floats for a launch: (m, l) and acc[D] per (group, split, row).
inline size_t ws_floats(int G, int n_splits, int rt, int D) {
  return static_cast<size_t>(G) * n_splits * rt * (D + 2);
}

// Page-address policies: the table entry a position's row needs (a load,
// made before the block knows whether its chunk is live), the row of
// position p of (b, h) from it, its page's index in the scale plane, and
// the position query 0 attends up to.
struct TablePages {  // page j of slot b is tables[b, j]: bs rows of one (block, kv head)
  __device__ static int last(const Params& P, int b) { return P.cur[b]; }
  __device__ static int entry(const Params& P, int b, int p) {
    return P.tables[static_cast<size_t>(b) * P.MB + p / P.bs];
  }
  __device__ static uint32_t page(const Params& P, int ent, int, int h) {
    return static_cast<uint32_t>(ent) * P.Hkv + h;
  }
  __device__ static uint32_t row(const Params& P, uint32_t page, int p) {
    return page * P.bs + p % P.bs;
  }
};
struct ContiguousPages {  // cache rows of (b, h) in order; cur is exclusive
  __device__ static int last(const Params& P, int b) {
    return (P.cur ? P.cur[b] : P.cur_scalar) - 1;
  }
  __device__ static int entry(const Params&, int, int) { return 0; }
  __device__ static uint32_t page(const Params& P, int, int b, int h) {
    return static_cast<uint32_t>(b * P.Hkv + h);
  }
  __device__ static uint32_t row(const Params& P, uint32_t page, int p) {
    return page * P.L + p;
  }
};

// Blocks per SM the registers must allow, by the f32 accumulator a thread
// keeps (RT rows of its 16-byte chunk): 64 registers up to 16 floats.
template <typename TK, int RT>
constexpr int min_blocks() {
  return RT * Elt<TK>::N <= 16 ? 4 : RT * Elt<TK>::N <= 32 ? 2 : 1;
}

template <typename TQ, typename TK, int D, int RT, class Pages>
__global__ void __launch_bounds__(NT, (min_blocks<TK, RT>()))
splitkv_kernel(const Params P) {
  constexpr int EPC = Elt<TK>::N;                  // elements a thread's chunk
  constexpr int CPR = D * int(sizeof(TK)) / 16;    // chunks a row
  constexpr int TR = NT / CPR;                     // rows a tile
  constexpr bool QUANT = Elt<TK>::CODE;
  static_assert(CPR <= 32 && 32 % CPR == 0, "a row's chunks lie in one warp");

  __shared__ __align__(16) float ring[RING_FLOATS];  // K/V ring, then combine space
  __shared__ __align__(16) float sq[RT][D];          // q * qscale
  __shared__ uint32_t srow[MAX_CHUNK];
  __shared__ float2 sscale[QUANT ? MAX_CHUNK : 1];
  __shared__ float sml[WARPS][RT][2];
  __shared__ float smax[RT];
  __shared__ int slim[RT];
  __shared__ int last_block;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x, split = blockIdx.y, n = P.n_splits;
  const int grp = g % P.groups, bh = g / P.groups;
  const int b = bh / P.Hkv, h = bh % P.Hkv;
  const int R = P.S * P.rep, Hq = P.Hkv * P.rep;
  // Loads that need nothing of cur go out together with cur and pad: this
  // block's q rows and its chunk's table entries.
  constexpr int QPT = (RT * D + NT - 1) / NT;
  constexpr int EPT = MAX_CHUNK / NT;
  const int pad_b = P.pad ? P.pad[b] : 0;
  const int last = Pages::last(P, b);
  TQ qraw[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int idx = tid + u * NT, r = idx / D, rg = grp * RT + r;
    qraw[u] = from_float<TQ>(0.f);
    if (idx < RT * D && rg < R) {
      const int i = rg / P.rep, head = h * P.rep + rg % P.rep;
      qraw[u] = static_cast<const TQ*>(P.q)[
          ((static_cast<size_t>(b) * Hq + head) * P.S + i) * D + idx % D];
    }
  }
  const int c0 = split * P.chunk;
  int ent[EPT];
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const int k = tid + u * NT;
    ent[u] = k < P.chunk && c0 + k < P.npos ? Pages::entry(P, b, c0 + k) : 0;
  }
  const int start = max(pad_b, 0);
  const int end = min(last + P.S, P.npos);
  const int lo = max(c0, start), hi = min(c0 + P.chunk, end);
  if (P.blocks != nullptr && tid == 0) {
    atomicAdd(P.blocks, 1);
    if (lo < hi) atomicAdd(P.blocks + 1, 1);
  }
  float* ws_ml = P.ws + (static_cast<size_t>(g) * n + split) * RT * 2;
  float* ws_acc = P.ws + static_cast<size_t>(gridDim.x) * n * RT * 2 +
                  (static_cast<size_t>(g) * n + split) * RT * D;

  // Splits [s_lo, s_lo + nl) meet [start, end); every other split is an
  // empty partial (m = NEG_INF, l = 0), which weighs 0 in the merge: its
  // block reads nothing, writes nothing and leaves at once, and the
  // counter waits for the nl live splits only (every block of the group
  // computes the same nl from cur and pad).
  const int s_lo = start < end ? start / P.chunk : 0;
  const int nl = start < end ? (end - 1) / P.chunk + 1 - s_lo : 0;
  if (nl == 0) {  // nothing to attend in any split: O = 0, from split 0
    if (split == 0) {
      for (int idx = tid; idx < RT * D; idx += NT) {
        const int rg = grp * RT + idx / D;
        if (rg < R) {
          const int i = rg / P.rep, head = h * P.rep + rg % P.rep;
          static_cast<TQ*>(P.o)[((static_cast<size_t>(b) * Hq + head) * P.S + i) * D + idx % D] =
              from_float<TQ>(0.f);
        }
      }
    }
    return;
  }
  if (lo >= hi) return;

  {
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int idx = tid + u * NT, r = idx / D, rg = grp * RT + r;
      if (idx < RT * D) {
        sq[r][idx % D] = to_float(qraw[u]) * P.qscale;
        if (idx % D == 0) slim[r] = rg < R ? last + rg / P.rep : -1;  // row r's last position
      }
    }
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int k = tid + u * NT, p = c0 + k;
      if (p >= lo && p < hi) srow[k] = Pages::row(P, Pages::page(P, ent[u], b, h), p);
    }
    __syncthreads();

    const int j = tid / CPR, seg = tid % CPR;  // key slot, column chunk
    const TK* kp = static_cast<const TK*>(P.k);
    const TK* vp = static_cast<const TK*>(P.v);
    const uint32_t kring = static_cast<uint32_t>(__cvta_generic_to_shared(ring)) + tid * 16;
    const uint32_t vring = kring + NST * TILE_BYTES;
    const int t0 = (lo - c0) / TR, nt = (hi - c0 + TR - 1) / TR - t0;
    auto issue = [&](int t, int stage) {
      const int k = t * TR + j, p = c0 + k;
      const bool ok = p >= lo && p < hi;
      const size_t off = ok ? static_cast<size_t>(srow[k]) * D + seg * EPC : 0;
      cp_async16(kring + stage * TILE_BYTES, kp + off, ok ? 16 : 0);
      cp_async16(vring + stage * TILE_BYTES, vp + off, ok ? 16 : 0);
    };
#pragma unroll
    for (int st = 0; st < NST; ++st) {
      if (st < nt) issue(t0 + st, st);
      cp_async_commit();
    }
    if constexpr (QUANT) {  // the pages' scales, while the first tiles load
#pragma unroll
      for (int u = 0; u < EPT; ++u) {
        const int k = tid + u * NT, p = c0 + k;
        if (p >= lo && p < hi)
          sscale[k] = *reinterpret_cast<const float2*>(
              P.scales + static_cast<size_t>(Pages::page(P, ent[u], b, h)) * 2);
      }
      __syncthreads();
    }

    float m[RT], l[RT], acc[RT][EPC];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[r][e] = 0.f;
    }
    for (int it = 0; it < nt; ++it) {
      cp_async_wait<NST - 1>();  // this thread's copies of tile it landed
      const int stage = it % NST, k = (t0 + it) * TR + j, p = c0 + k;
      const bool ok = p >= lo && p < hi;
      float kf[EPC], vf[EPC];
      unpack(TK(), *reinterpret_cast<const uint4*>(ring + (stage * TILE_BYTES + tid * 16) / 4), kf);
      unpack(TK(), *reinterpret_cast<const uint4*>(ring + ((NST + stage) * TILE_BYTES + tid * 16) / 4), vf);
      float sk = 1.f, sv = 1.f;
      if constexpr (QUANT) {
        if (ok) {
          sk = sscale[k].x;
          sv = sscale[k].y;
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(&sq[r][seg * EPC + e]);
          s = fmaf(qv.x, kf[e], s);
          s = fmaf(qv.y, kf[e + 1], s);
          s = fmaf(qv.z, kf[e + 2], s);
          s = fmaf(qv.w, kf[e + 3], s);
        }
#pragma unroll
        for (int off = CPR / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        s = (ok && p <= slim[r]) ? s * sk : NEG_INF;
        if (s > m[r]) {  // a new running max: rescale (alpha is 1 otherwise)
          const float alpha = ex2(m[r] - s);
          l[r] *= alpha;
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[r][e] *= alpha;
          m[r] = s;
        }
        // a masked key, or nothing live yet (m = NEG_INF), adds p = 0
        const float pr = s > NEG_INF ? ex2(s - m[r]) : 0.f;
        l[r] += pr;
        const float pv = pr * sv;
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[r][e] = fmaf(pv, vf[e], acc[r][e]);
      }
      if (it + NST < nt) issue(t0 + it + NST, stage);  // this thread's slot only
      cp_async_commit();
    }
    cp_async_wait<0>();

    // merge the key slots of a warp (lanes CPR apart), then the warps
#pragma unroll
    for (int off = CPR; off < 32; off <<= 1) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float lo2 = __shfl_xor_sync(0xffffffffu, l[r], off);
        const float mn = fmaxf(m[r], mo);
        const float a = ex2(m[r] - mn), c = ex2(mo - mn);
        l[r] = l[r] * a + lo2 * c;
        m[r] = mn;
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          acc[r][e] = acc[r][e] * a + __shfl_xor_sync(0xffffffffu, acc[r][e], off) * c;
      }
    }
    __syncthreads();  // the ring is free: it holds the warps' partials now
    if (lane < CPR) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int e = 0; e < EPC; ++e) ring[(warp * RT + r) * D + lane * EPC + e] = acc[r][e];
        if (lane == 0) {
          sml[warp][r][0] = m[r];
          sml[warp][r][1] = l[r];
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < RT * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sml[w][r][0]);
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float c = ex2(sml[w][r][0] - mx);
        lsum = fmaf(sml[w][r][1], c, lsum);
        a = fmaf(ring[(w * RT + r) * D + d], c, a);
      }
      if (nl == 1) {  // the only live split: its partial is the answer
        const int rg = grp * RT + r;
        if (rg < R) {
          const int i = rg / P.rep, head = h * P.rep + rg % P.rep;
          static_cast<TQ*>(P.o)[((static_cast<size_t>(b) * Hq + head) * P.S + i) * D + d] =
              from_float<TQ>(a / (lsum > 0.f ? lsum : 1.f));
        }
        continue;
      }
      ws_acc[r * D + d] = a;
      if (d == 0) {
        ws_ml[2 * r] = mx;
        ws_ml[2 * r + 1] = lsum;
      }
    }
  }
  if (nl == 1) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(P.counters + g, 1) == nl - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();

  // The last live block of the group merges the live partials in split
  // order (the empty ones weigh 0).
  const float* ml = P.ws + (static_cast<size_t>(g) * n + s_lo) * RT * 2;
  const float* pacc = P.ws + static_cast<size_t>(gridDim.x) * n * RT * 2 +
                      (static_cast<size_t>(g) * n + s_lo) * RT * D;
  float* wts = ring;  // [RT][nl]: each split's m, then its weight
  for (int idx = tid; idx < RT * nl; idx += NT) {
    const int r = idx / nl, s = idx % nl;
    wts[idx] = __ldcg(ml + (static_cast<size_t>(s) * RT + r) * 2);
  }
  __syncthreads();
  if (warp < RT) {
    float mx = NEG_INF;
    for (int s = lane; s < nl; s += 32) mx = fmaxf(mx, wts[warp * nl + s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) smax[warp] = mx;
  }
  __syncthreads();
  for (int idx = tid; idx < RT * nl; idx += NT) {
    const float mv = wts[idx];  // a row with nothing live in the split weighs 0
    wts[idx] = mv > NEG_INF ? ex2(mv - smax[idx / nl]) : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < RT * D; idx += NT) {
    const int r = idx / D, d = idx % D, rg = grp * RT + r;
    if (rg >= R) continue;
    float lsum = 0.f, a = 0.f;
#pragma unroll 8
    for (int s = 0; s < nl; ++s) {  // independent loads, summed in order
      const float w = wts[r * nl + s];
      lsum = fmaf(__ldcg(ml + (static_cast<size_t>(s) * RT + r) * 2 + 1), w, lsum);
      a = fmaf(__ldcg(pacc + (static_cast<size_t>(s) * RT + r) * D + d), w, a);
    }
    const int i = rg / P.rep, head = h * P.rep + rg % P.rep;
    static_cast<TQ*>(P.o)[((static_cast<size_t>(b) * Hq + head) * P.S + i) * D + d] =
        from_float<TQ>(a / (lsum > 0.f ? lsum : 1.f));
  }
  if (tid == 0) P.counters[g] = 0;
}

// Launches one call over npos positions a row with the caller's plan:
// rt query rows a block, chunk positions a split. Refuses, before any
// launch, a plan this kernel was not built for (a chunk of whole tiles of
// every element type, up to 64 rows a tile, and at most MAX_CHUNK table
// entries; the merge holds rt weights a split in the ring) or a workspace
// smaller than the plan needs.
template <typename TQ, typename TK, int D, class Pages>
cudaError_t launch(Params P, int B, long long npos, int rt, int chunk,
                   size_t ws_given, cudaStream_t st) {
  if (rt < 1 || rt > MAX_RT || chunk <= 0 || chunk % 64 || chunk > MAX_CHUNK)
    return cudaErrorInvalidValue;
  const long long n_splits = (npos + chunk - 1) / chunk;
  if (npos <= 0 || rt * n_splits > RING_FLOATS) return cudaErrorInvalidValue;
  P.npos = static_cast<int>(npos);
  const int R = P.S * P.rep;
  P.groups = (R + rt - 1) / rt;
  P.chunk = chunk;
  P.n_splits = static_cast<int>(n_splits);
  const int G = B * P.Hkv * P.groups;
  if (ws_given < ws_floats(G, P.n_splits, rt, D)) return cudaErrorInvalidValue;
  P.qscale = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  const dim3 grid(G, P.n_splits);
  if (rt == 1) splitkv_kernel<TQ, TK, D, 1, Pages><<<grid, NT, 0, st>>>(P);
  else splitkv_kernel<TQ, TK, D, 2, Pages><<<grid, NT, 0, st>>>(P);
  return cudaGetLastError();
}

}  // namespace splitkv
}  // namespace sdl
