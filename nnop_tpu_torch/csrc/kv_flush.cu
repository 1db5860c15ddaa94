// Staging flush for Hopper (sm_90a): write the W staged bf16 tokens of
// every layer into the stacked KV caches, in place; an int8 cache is
// quantized on the way, one scale per token.
//
// Replaces nnop_tpu/ops/kv_write.py:flush_staging (_flush_kernel) for
// floating-point and int8 caches.
//
// Bound on the H100: device-memory bandwidth; it is a copy with a cast
// (2 * n_layers * B * KH * W * E elements read and written once per decode
// chunk). The TPU kernel read-modify-wrote an aligned (W + 32)-row window
// because its DMAs needed 32-row alignment; here each block writes exactly
// its W rows at the slot's unaligned base, so no row outside them is read
// or written. Consecutive threads write consecutive elements. The int8
// mode gives each row to one warp: the row's absolute maximum is a warp
// reduction, and the row never leaves registers and L1 between the two
// passes. The TPU kernel computed the scales in XLA and scattered them
// after the pallas call; here the warp writes its row's scale itself.
//
// Semantics (kv_write.py:205-231): for every slot b, layer l and KV head kh,
// cache[l, b, kh, lengths[b] + w, :] = stage[b, l, kh, w, :] for all
// w < W, even when fewer than W staged tokens are live (the tail lies
// above the slot's length and is overwritten by later flushes). Rows that
// would fall past the cache end are dropped. int8 (:155-162, :227-231):
// s = max(amax, 1e-8) / 127 is the row's scale, and the values are
// clip(rint(x / max(s, 1e-8)), -127, 127), with IEEE division and rounding
// half to even, so values and scales are bit-exact against the plain flush.

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

// One staged row (E values at st) -> int8 values at q and its scale at sc.
// Called by a whole warp.
__device__ __forceinline__ void quantize_row(const __nv_bfloat16* __restrict__ st,
                                             int8_t* __restrict__ q, float* __restrict__ sc,
                                             int E, int lane) {
  float amax = 0.f;
  for (int e = lane; e < E; e += 32) amax = fmaxf(amax, fabsf(nnop::to_float(st[e])));
  amax = nnop::warp_max(amax);
  const float s = fmaxf(amax, 1e-8f) / 127.0f;
  const float d = fmaxf(s, 1e-8f);
  for (int e = lane; e < E; e += 32)
    q[e] = static_cast<int8_t>(fminf(fmaxf(rintf(nnop::to_float(st[e]) / d), -127.f), 127.f));
  if (lane == 0) *sc = s;
}

// Grid (KH, n_layers, B); warp w quantizes rows w, w + 8, ...
__global__ void __launch_bounds__(kThreads)
flush_q8_kernel(const __nv_bfloat16* __restrict__ k_stage,
                const __nv_bfloat16* __restrict__ v_stage, int8_t* __restrict__ k_cache,
                int8_t* __restrict__ v_cache, float* __restrict__ k_scale,
                float* __restrict__ v_scale, const int* __restrict__ lengths, int B, int n_layers,
                int KH, int S, int W, int E) {
  const int kh = blockIdx.x, l = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = lengths[b];
  const int rows = min(W, S - base);
  const size_t src = (((size_t)b * n_layers + l) * KH + kh) * (size_t)W * E;
  const size_t srow = (((size_t)l * B + b) * KH + kh) * (size_t)S + base;  // first scale row
  for (int w = warp; w < rows; w += kThreads / 32) {
    const size_t o = src + (size_t)w * E;
    quantize_row(k_stage + o, k_cache + (srow + w) * E, k_scale + srow + w, E, lane);
    quantize_row(v_stage + o, v_cache + (srow + w) * E, v_scale + srow + w, E, lane);
  }
}

}  // namespace

// staging (B, n_layers, KH, W, E) bf16; caches (n_layers, B, KH, S, E) of
// cache_kind 0 bf16, 1 f32, 2 int8 (then scales (n_layers, B, KH, S) f32);
// lengths (B,) int32.
extern "C" int nnop_flush_staging(const void* k_stage, const void* v_stage, void* k_cache,
                                  void* v_cache, void* k_scale, void* v_scale,
                                  const void* lengths, int B, int n_layers, int KH, int S, int W,
                                  int E, int cache_kind, void* stream) {
  if (cache_kind == 2 && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(KH, n_layers, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* ks = static_cast<const __nv_bfloat16*>(k_stage);
  const auto* vs = static_cast<const __nv_bfloat16*>(v_stage);
  const auto* lens = static_cast<const int*>(lengths);
  if (cache_kind == 2) {
    flush_q8_kernel<<<grid, kThreads, 0, st>>>(
        ks, vs, static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache),
        static_cast<float*>(k_scale), static_cast<float*>(v_scale), lens, B, n_layers, KH, S, W,
        E);
  } else if (cache_kind == 1) {
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
