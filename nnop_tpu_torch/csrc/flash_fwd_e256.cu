// Kernel C's launcher at head dim 256 (flash_fwd.cuh): the forward in every
// combination of the softcap, the window and the extra score terms.

#include "flash_fwd.cuh"

namespace nnop_fwd {
template cudaError_t launch<256>(const Args&);
}  // namespace nnop_fwd
