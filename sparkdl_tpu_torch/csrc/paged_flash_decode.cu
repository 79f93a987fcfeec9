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
// Design: the split-KV template of decode_splitkv.cuh with the table
// page policy. The MB * bs positions of each (slot, kv head, group of up
// to 2 query rows) split into chunks of 256 (the wrapper's split_plan);
// a block reads its chunk's table entries (and, for codes, each page's
// scale pair) into shared memory once, streams the chunk's live rows
// through a cp.async ring, and the partials merge in the same launch.
// The dead tail, the left pad and every block no table names are never
// read (the TPU kernel's O(cur) contract; there a clamped index map
// skipped the DMA). The rows are (query i, GQA member g) pairs flattened
// as i * rep + g; a window with S * rep above 2 splits into groups that
// each read the rows again (mostly from L2; PERF.md has the alternatives
// measured). At LlamaConfig.small's decode step (8 slots, 8 kv heads,
// 132 blocks of 16 a table) the grid is 64 x 9 blocks.
#include "decode_splitkv.cuh"

namespace {

namespace skv = sdl::splitkv;

template <typename TQ, typename TK>
cudaError_t launch_t(int D, const skv::Params& p, int B, long long npos,
                     int rt, int chunk, size_t ws, cudaStream_t st) {
  if (D == 64) return skv::launch<TQ, TK, 64, skv::TablePages>(p, B, npos, rt, chunk, ws, st);
  if (D == 128) return skv::launch<TQ, TK, 128, skv::TablePages>(p, B, npos, rt, chunk, ws, st);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_q(int kv_kind, int D, const skv::Params& p, int B,
                     long long npos, int rt, int chunk, size_t ws,
                     cudaStream_t st) {
  switch (kv_kind) {
    case 0: return launch_t<TQ, TQ>(D, p, B, npos, rt, chunk, ws, st);
    case 1: return launch_t<TQ, int8_t>(D, p, B, npos, rt, chunk, ws, st);
    case 2: return launch_t<TQ, __nv_fp8_e4m3>(D, p, B, npos, rt, chunk, ws, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: [B, Hkv*rep, S, D], f32 (is_bf16 = 0) or bf16; k, v pools:
// [P, Hkv, bs, D] in q's type (kv_kind 0), int8 codes (1) or e4m3 codes
// (2); scales: [P, Hkv, 2] f32 for kv_kind 1 and 2, else NULL; tables:
// [B, MB] int32 pool block ids, each in [0, P); cur: [B] int32; pad: [B]
// int32 or NULL. All contiguous. D must be 64 or 128. rt, chunk: the
// plan (query rows a block, 1 or 2; positions a split, a multiple of 64
// up to 512). ws: ws_floats f32 of workspace; counters: [B * Hkv *
// ceil(S * rep / rt)] int32, zero before the launch and left zero by it;
// blocks: NULL, or int32[2] that the launch adds its blocks run and its
// live blocks to.
extern "C" int sdl_paged_flash_decode(const void* q, const void* k,
                                      const void* v, const void* scales,
                                      const void* tables, const void* cur,
                                      const void* pad, void* o, int B, int Hkv,
                                      int rep, int S, int D, int bs, int MB,
                                      int is_bf16, int kv_kind, int rt,
                                      int chunk, void* ws, long long ws_floats,
                                      void* counters, void* blocks,
                                      void* stream) {
  if (B <= 0 || Hkv <= 0 || S <= 0) return cudaSuccess;
  if (rep <= 0 || bs <= 0 || MB <= 0) return cudaErrorInvalidValue;
  if ((kv_kind != 0) != (scales != nullptr)) return cudaErrorInvalidValue;
  if (ws == nullptr || counters == nullptr) return cudaErrorInvalidValue;
  skv::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.scales = static_cast<const float*>(scales);
  p.tables = static_cast<const int*>(tables);
  p.cur = static_cast<const int*>(cur);
  p.pad = static_cast<const int*>(pad);
  p.o = o;
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.blocks = static_cast<int*>(blocks);
  p.Hkv = Hkv;
  p.rep = rep;
  p.S = S;
  p.bs = bs;
  p.MB = MB;
  const long long npos = static_cast<long long>(MB) * bs;
  auto st = static_cast<cudaStream_t>(stream);
  const size_t wsf = static_cast<size_t>(ws_floats);
  return is_bf16 ? launch_q<__nv_bfloat16>(kv_kind, D, p, B, npos, rt, chunk, wsf, st)
                 : launch_q<float>(kv_kind, D, p, B, npos, rt, chunk, wsf, st);
}
