// Staging flush for Hopper (sm_90a): write the W staged bf16 tokens of
// every layer into the stacked floating-point KV caches, in place.
//
// Replaces nnop_tpu/ops/kv_write.py:flush_staging (_flush_kernel) for
// floating-point caches.
//
// Bound on the H100: device-memory bandwidth; it is a copy with a cast
// (2 * n_layers * B * KH * W * E elements read and written once per decode
// chunk). The TPU kernel read-modify-wrote an aligned (W + 32)-row window
// because its DMAs needed 32-row alignment; here each block writes exactly
// its W rows at the slot's unaligned base, so no row outside them is read
// or written. Consecutive threads write consecutive elements.
//
// Semantics (kv_write.py:205-231): for every slot b, layer l and KV head kh,
// cache[l, b, kh, lengths[b] + w, :] = stage[b, l, kh, w, :] for all
// w < W, even when fewer than W staged tokens are live (the tail lies
// above the slot's length and is overwritten by later flushes). Rows that
// would fall past the cache end are dropped.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Grid (KH, n_layers, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flush_kernel(const __nv_bfloat16* __restrict__ k_stage, const __nv_bfloat16* __restrict__ v_stage,
             T* __restrict__ k_cache, T* __restrict__ v_cache, const int* __restrict__ lengths,
             int B, int n_layers, int KH, int S, int W, int E) {
  const int kh = blockIdx.x, l = blockIdx.y, b = blockIdx.z;
  const int base = lengths[b];
  const int rows = min(W, S - base);
  if (rows <= 0) return;
  const size_t src = (((size_t)b * n_layers + l) * KH + kh) * (size_t)W * E;
  const size_t dst = ((((size_t)l * B + b) * KH + kh) * (size_t)S + base) * E;
  for (int i = threadIdx.x; i < rows * E; i += kThreads) {
    k_cache[dst + i] = nnop::from_float<T>(nnop::to_float(k_stage[src + i]));
    v_cache[dst + i] = nnop::from_float<T>(nnop::to_float(v_stage[src + i]));
  }
}

}  // namespace

// staging (B, n_layers, KH, W, E) bf16; caches (n_layers, B, KH, S, E) bf16,
// or f32 when cache_is_f32; lengths (B,) int32.
extern "C" int nnop_flush_staging(const void* k_stage, const void* v_stage, void* k_cache,
                                  void* v_cache, const void* lengths, int B, int n_layers, int KH,
                                  int S, int W, int E, int cache_is_f32, void* stream) {
  const dim3 grid(KH, n_layers, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* ks = static_cast<const __nv_bfloat16*>(k_stage);
  const auto* vs = static_cast<const __nv_bfloat16*>(v_stage);
  const auto* lens = static_cast<const int*>(lengths);
  if (cache_is_f32) {
    flush_kernel<float><<<grid, kThreads, 0, st>>>(ks, vs, static_cast<float*>(k_cache),
                                                   static_cast<float*>(v_cache), lens, B,
                                                   n_layers, KH, S, W, E);
  } else {
    flush_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        ks, vs, static_cast<__nv_bfloat16*>(k_cache), static_cast<__nv_bfloat16*>(v_cache), lens,
        B, n_layers, KH, S, W, E);
  }
  return static_cast<int>(cudaGetLastError());
}
