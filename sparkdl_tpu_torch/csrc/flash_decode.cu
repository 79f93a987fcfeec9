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
// Design: the split-KV template of decode_splitkv.cuh with the contiguous
// page policy, S = 1 and a last position of cur - 1 (cur is exclusive
// here, inclusive in the paged kernel). The L positions of each (b, kv
// head) split into chunks of 256 (the wrapper's split_plan) spread over
// the grid, each chunk's live rows stream through a cp.async ring, and the
// partials merge in the same launch. The dead tail past cur and the left pad are never
// read (the TPU kernel's O(cur) contract). A block holds 2 query rows of
// a kv head's GQA group; a larger group (rep 4, 8) reads the head's K/V
// once per 2 rows, the rereads mostly from L2 (fewer rows a block ran
// faster on the card than one block for the whole group: PERF.md).
#include "decode_splitkv.cuh"

namespace {

namespace skv = sdl::splitkv;

template <typename T, int D>
cudaError_t launch_d(const skv::Params& p, int B, int L, int rt, int chunk,
                     size_t ws, cudaStream_t st) {
  return skv::launch<T, T, D, skv::ContiguousPages>(p, B, L, rt, chunk, ws, st);
}

}  // namespace

// q, o: [B, Hkv*rep, 1, D]; k, v: [B, Hkv, L, D]; all contiguous, f32
// (is_bf16 = 0) or bf16. cur: [B] int32, or NULL to use cur_scalar for
// every row. pad: [B] int32 or NULL (no left pad). D must be 64 or 128,
// rep 1, 2, 4 or 8. rt, chunk: the plan (query rows a block, 1 or 2;
// positions a split, a multiple of 64 up to 512). ws: ws_floats f32 of
// workspace; counters: [B * Hkv * ceil(rep / rt)] int32, zero before the
// launch and left zero by it; blocks: NULL, or int32[2] that the launch
// adds its blocks run and its live blocks to.
extern "C" int sdl_flash_decode(const void* q, const void* k, const void* v,
                                void* o, const void* cur, int cur_scalar,
                                const void* pad, int B, int Hkv, int rep,
                                int L, int D, int is_bf16, int rt, int chunk,
                                void* ws, long long ws_floats, void* counters,
                                void* blocks, void* stream) {
  if (B <= 0 || Hkv <= 0) return cudaSuccess;
  if (rep != 1 && rep != 2 && rep != 4 && rep != 8) return cudaErrorInvalidValue;
  if (ws == nullptr || counters == nullptr) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  skv::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.cur = static_cast<const int*>(cur);
  p.cur_scalar = cur_scalar;
  p.pad = static_cast<const int*>(pad);
  p.o = o;
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.blocks = static_cast<int*>(blocks);
  p.Hkv = Hkv;
  p.rep = rep;
  p.S = 1;
  p.L = L;
  const size_t wsf = static_cast<size_t>(ws_floats);
  if (D == 64)
    return is_bf16 ? launch_d<__nv_bfloat16, 64>(p, B, L, rt, chunk, wsf, st)
                   : launch_d<float, 64>(p, B, L, rt, chunk, wsf, st);
  if (D == 128)
    return is_bf16 ? launch_d<__nv_bfloat16, 128>(p, B, L, rt, chunk, wsf, st)
                   : launch_d<float, 128>(p, B, L, rt, chunk, wsf, st);
  return cudaErrorInvalidValue;
}
