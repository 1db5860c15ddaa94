// The C entries of the flash-attention backward (the kernels and their
// design: flash_bwd.cuh). Each head dim's launchers are instantiated in
// its own file, flash_bwd_e{64,128,256}.cu.

#include "flash_bwd.cuh"

namespace nnop_bwd {
extern template cudaError_t launch_dq<64>(const Params&);
extern template cudaError_t launch_dq<128>(const Params&);
extern template cudaError_t launch_dq<256>(const Params&);
extern template cudaError_t launch_dkv<64>(const Params&);
extern template cudaError_t launch_dkv<128>(const Params&);
extern template cudaError_t launch_dkv<256>(const Params&);
}  // namespace nnop_bwd

namespace {

// The operands both entries take; each entry adds its outputs.
nnop_bwd::Params common(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* kpad, const void* pair, const void* q_seg,
                        const void* kv_seg, int B, int QH, int KH, int QL, int KL, int pair_f32,
                        float scale, int causal, int window, float softcap, void* stream) {
  nnop_bwd::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.kpad = static_cast<const uint8_t*>(kpad);
  p.pair = pair;
  p.qseg = static_cast<const int*>(q_seg);
  p.kseg = static_cast<const int*>(kv_seg);
  p.B = B, p.QH = QH, p.KH = KH, p.QL = QL, p.KL = KL, p.pair_f32 = pair_f32;
  p.scale = scale, p.causal = causal, p.window = window, p.softcap = softcap;
  p.stream = static_cast<cudaStream_t>(stream);
  return p;
}

}  // namespace

// q, o, dout, dq (B, QH, QL, E); k, v (B, KH, KL, E): bf16, contiguous.
// lse, delta (B, QH, QL) f32 (delta is written); kpad (B, KL) uint8 or
// null; pair (B, QH, QL, KL) f32 (pair_f32) or bf16, or null, and dpair
// of its shape and dtype (written) or null; q_seg (B, QL) and kv_seg
// (B, KL) int32, both or neither. E is 64, 128 or 256. window > 0 (with
// causal) keeps the last `window` positions; softcap > 0 caps the scores
// (no pair with it); 0 turns either off.
extern "C" int nnop_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, const void* kpad,
                                 const void* pair, const void* q_seg, const void* kv_seg,
                                 void* dq, void* dpair, void* delta, int B, int QH, int KH,
                                 int QL, int KL, int E, int pair_f32, float scale, int causal,
                                 int window, float softcap, void* stream) {
  nnop_bwd::Params p = common(q, k, v, dout, lse, kpad, pair, q_seg, kv_seg, B, QH, KH, QL, KL,
                              pair_f32, scale, causal, window, softcap, stream);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dpair = dpair;
  p.delta = static_cast<float*>(delta);
  switch (E) {
    case 64: return static_cast<int>(nnop_bwd::launch_dq<64>(p));
    case 128: return static_cast<int>(nnop_bwd::launch_dq<128>(p));
    case 256: return static_cast<int>(nnop_bwd::launch_dq<256>(p));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, dout (B, QH, QL, E); k, v, dk, dv (B, KH, KL, E): bf16, contiguous.
// lse, delta (B, QH, QL) f32 (delta from nnop_flash_bwd_dq); kpad, pair,
// q_seg, kv_seg, E, window and softcap as for nnop_flash_bwd_dq.
extern "C" int nnop_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, const void* kpad,
                                  const void* pair, const void* q_seg, const void* kv_seg,
                                  void* dk, void* dv, int B, int QH, int KH, int QL, int KL,
                                  int E, int pair_f32, float scale, int causal, int window,
                                  float softcap, void* stream) {
  nnop_bwd::Params p = common(q, k, v, dout, lse, kpad, pair, q_seg, kv_seg, B, QH, KH, QL, KL,
                              pair_f32, scale, causal, window, softcap, stream);
  p.delta = static_cast<float*>(const_cast<void*>(delta));
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  switch (E) {
    case 64: return static_cast<int>(nnop_bwd::launch_dkv<64>(p));
    case 128: return static_cast<int>(nnop_bwd::launch_dkv<128>(p));
    case 256: return static_cast<int>(nnop_bwd::launch_dkv<256>(p));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
