// Kernel D's launchers at padded head dim 128 (decode_attn.cuh): every
// cache type, linear and paged, with and without the softcap.

#include "decode_attn.cuh"

namespace nnop_decode {
template cudaError_t launch<128>(const Params&);
}  // namespace nnop_decode
