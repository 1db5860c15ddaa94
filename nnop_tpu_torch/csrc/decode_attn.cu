// The C entry of kernel D, decode attention (the kernel and its design:
// decode_attn.cuh). Each padded head dim's launchers are instantiated in
// its own file, decode_attn_e{64,128,256}.cu.

#include "decode_attn.cuh"

namespace nnop_decode {
extern template cudaError_t launch<64>(const Params&);
extern template cudaError_t launch<128>(const Params&);
extern template cudaError_t launch<256>(const Params&);
}  // namespace nnop_decode

// q (B, QH, T, E) and o bf16, or f32 when q_is_f32; caches stacked
// (n_layers, n_blocks, KH, S, E) of q's dtype, or int8 when cache_is_int8
// with scales (n_layers, n_blocks, KH, S) f32; staging (B, n_layers, KH,
// W, E) bf16 or null; lengths (B,) int32. Linear when page_table is null
// (n_blocks = B); else pools of n_blocks pages of S keys (S a multiple of
// 32) and page_table (B, max_pages) int32. E <= 256 with E % 16 == 0,
// QH / KH <= 8 and W <= 32. window > 0 keeps the last `window` positions
// and softcap > 0 caps the scores; 0 turns either off. T > 1 (the verify
// mode) needs a linear cache and the staging with T <= staged_n.
// n_split > 1 (at most 128) splits each (slot, KV head, z)'s keys over
// that many blocks: ws then holds at least B * KH * Z * n_split * R *
// (E + 2) f32 of its ws_elems and tickets at least B * KH * Z of its
// n_tickets int32 zeros (left zero), with R the rows a block holds and Z
// the z-blocks (rows_m); a smaller ws or tickets is refused.
extern "C" int nnop_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                     const void* k_scale, const void* v_scale,
                                     const void* k_stage, const void* v_stage,
                                     const void* lengths, const void* page_table, void* o,
                                     void* ws, void* tickets, long long ws_elems, int n_tickets,
                                     int B, int QH, int KH, int S, int E,
                                     int T, int n_blocks, int max_pages, int n_layers, int layer,
                                     int W, int staged_n, float scale, int window, float softcap,
                                     int q_is_f32, int cache_is_int8, int n_split, void* stream) {
  using namespace nnop_decode;
  const bool paged = page_table != nullptr;
  if (E < 16 || E > 256 || E % 16 != 0 || QH % KH != 0 || QH / KH > kMaxG || W > kMaxStage ||
      staged_n > W || window < 0 || (cache_is_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      (paged ? S % kPageMultiple != 0 : n_blocks != B) || T < 1 ||
      (T > 1 && (paged || k_stage == nullptr || T > staged_n)) || n_split < 1 ||
      n_split > kMaxSplit || (n_split > 1 && (ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k_cache = k_cache;
  p.v_cache = v_cache;
  p.k_scale = cache_is_int8 ? static_cast<const float*>(k_scale) : nullptr;
  p.v_scale = cache_is_int8 ? static_cast<const float*>(v_scale) : nullptr;
  p.k_stage = static_cast<const __nv_bfloat16*>(k_stage);
  p.v_stage = static_cast<const __nv_bfloat16*>(v_stage);
  p.lengths = static_cast<const int*>(lengths);
  p.table = static_cast<const int*>(page_table);
  p.o = o;
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<int*>(tickets);
  p.ws_elems = ws_elems, p.n_tickets = n_tickets;
  p.B = B, p.QH = QH, p.KH = KH, p.S = S, p.E = E, p.n_draft = T, p.n_blocks = n_blocks;
  p.max_pages = max_pages, p.n_layers = n_layers, p.layer = layer, p.W = W;
  p.staged_n = k_stage != nullptr ? staged_n : 0;
  p.window = window, p.q_f32 = q_is_f32, p.n_split = n_split;
  p.kv_kind = cache_is_int8 ? 2 : q_is_f32 ? 1 : 0;
  p.scale = scale, p.softcap = softcap;
  p.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t e = E <= 64 ? launch<64>(p) : E <= 128 ? launch<128>(p) : launch<256>(p);
  return static_cast<int>(e);
}
