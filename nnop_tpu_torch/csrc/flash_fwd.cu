// The C entry of the flash-attention forward, kernel C (the kernel and its
// design: flash_fwd.cuh). Each head dim's launcher is instantiated in its
// own file, flash_fwd_e{64,128,256}.cu.

#include "flash_fwd.cuh"

namespace nnop_fwd {
extern template cudaError_t launch<64>(const Args&);
extern template cudaError_t launch<128>(const Args&);
extern template cudaError_t launch<256>(const Args&);
}  // namespace nnop_fwd

// q (B, QH, QL, E), k/v (B, KH, KL, E), o (B, QH, QL, E): bf16, contiguous,
// 16-byte aligned (as the pair: TMA reads them). kpad (B, KL) uint8 or
// null; pair (B, QH, QL, KL) f32 (pair_f32) or bf16, or null; q_seg (B, QL)
// and kv_seg (B, KL) int32, both or neither; lse (B, QH, QL) f32. E is 64,
// 128 or 256. window > 0 (with causal) keeps the last `window` positions;
// softcap > 0 caps the scores; 0 turns either off. The softcap takes no
// pair.
extern "C" int nnop_flash_fwd(const void* q, const void* k, const void* v, const void* kpad,
                              const void* pair, const void* q_seg, const void* kv_seg, void* o,
                              void* lse, int B, int QH, int KH, int QL, int KL, int E,
                              int pair_f32, float scale, int causal, int offset, int window,
                              float softcap, void* stream) {
  const nnop_fwd::Args a{q,  k,  v,  kpad, pair,     q_seg,  kv_seg, o,      lse,   B,      QH,
                         KH, QL, KL, pair_f32, causal, offset, window, scale, softcap,
                         static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  switch (E) {
    case 64: e = nnop_fwd::launch<64>(a); break;
    case 128: e = nnop_fwd::launch<128>(a); break;
    case 256: e = nnop_fwd::launch<256>(a); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* nnop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
