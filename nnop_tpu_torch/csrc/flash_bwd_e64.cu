// The flash-attention backward's launchers at head dim 64 (flash_bwd.cuh):
// the dQ and dK/dV kernels in every combination of the window, the
// softcap and the extra score terms.

#include "flash_bwd.cuh"

namespace nnop_bwd {
template cudaError_t launch_dq<64>(const Params&);
template cudaError_t launch_dkv<64>(const Params&);
}  // namespace nnop_bwd
