// Staging flush for Hopper (sm_90a): write the W staged bf16 tokens of
// every layer into the stacked KV caches, or through a page table into a
// page pool, in place; an int8 cache is quantized on the way, one scale
// per token. Also the one-token cache write.
//
// Replaces nnop_tpu/ops/kv_write.py:flush_staging (_flush_kernel),
// flush_staging_paged (_paged_flush_kernel) and write_kv_token
// (_write_kernel) for floating-point and int8 caches.
//
// Bound on the H100: device-memory bandwidth; a flush is a copy with a
// cast (2 * n_layers * B * KH * W * E elements read and written once per
// decode chunk). The TPU kernels read-modify-wrote 32-row-aligned windows
// (two of them per slot when paged) because their DMAs needed the
// alignment; here each block writes exactly its W rows at the slot's
// unaligned base, so no row outside them is read or written. One warp
// owns one row: consecutive lanes write consecutive elements, the int8
// row's absolute maximum is a warp reduction, and the row never leaves
// registers and L1 between the two passes. The TPU kernels computed the
// scales in XLA and scattered them after the pallas call (or RMWed
// 128-lane scale windows); here the warp writes its row's scale itself.
//
// Semantics (kv_write.py:205-231): for every slot b, layer l and KV head kh,
// cache[l, b, kh, lengths[b] + w, :] = stage[b, l, kh, w, :] for all
// w < W, even when fewer than W staged tokens are live (the tail lies
// above the slot's length and is overwritten by later flushes). Rows that
// would fall past the cache end are dropped. int8 (:155-162, :227-231):
// s = max(amax, 1e-8) / 127 is the row's scale, and the values are
// clip(rint(x / max(s, 1e-8)), -127, 127), with IEEE division and rounding
// half to even, so values and scales are bit-exact against the plain flush.
//
// Paged (kv_write.py:300-543): row w goes to row g % page of page
// table[b][g / page], g = lengths[b] + w, so the lookup is per row; rows
// past the table's last page are dropped. A slot with lengths[b] == 0
// holds no request and is skipped: its table row may be stale and point
// at a live slot's or a cached prefix's page. The TPU flush writes such a
// slot's junk rows all the same, which is a fault of the reference.
//
// write_kv_token (kv_write.py:30-92): cache[b, kh, positions[b], :] =
// new[b, kh, 0, :], in place, one block per (b, kh); a position outside
// [0, S) writes nothing.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// One staged row (E values at st) -> the cache row at dst, a warp's work:
// a cast, or for int8 the quantized values and the row's scale at sc.
template <typename T>
__device__ __forceinline__ void write_row(const __nv_bfloat16* __restrict__ st, T* __restrict__ dst,
                                          float* __restrict__ sc, int E, int lane) {
  if constexpr (std::is_same<T, int8_t>::value) {
    float amax = 0.f;
    for (int e = lane; e < E; e += 32) amax = fmaxf(amax, fabsf(nnop::to_float(st[e])));
    amax = nnop::warp_max(amax);
    const float s = fmaxf(amax, 1e-8f) / 127.0f;
    const float d = fmaxf(s, 1e-8f);
    for (int e = lane; e < E; e += 32)
      dst[e] = static_cast<int8_t>(fminf(fmaxf(rintf(nnop::to_float(st[e]) / d), -127.f), 127.f));
    if (lane == 0) *sc = s;
  } else {
    for (int e = lane; e < E; e += 32) dst[e] = nnop::from_float<T>(nnop::to_float(st[e]));
  }
}

// Grid (KH, n_layers, B); warp w writes rows w, w + 8, ... Caches
// (n_layers, n_blocks, KH, S, E) of T (int8 with scales (n_layers,
// n_blocks, KH, S) f32): n_blocks = B linear, or n_pages paged with S =
// page and table (B, max_pages).
template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads)
flush_kernel(const __nv_bfloat16* __restrict__ k_stage, const __nv_bfloat16* __restrict__ v_stage,
             T* __restrict__ k_cache, T* __restrict__ v_cache, float* __restrict__ k_scale,
             float* __restrict__ v_scale, const int* __restrict__ lengths,
             const int* __restrict__ table, int n_blocks, int max_pages, int n_layers, int KH,
             int S, int W, int E) {
  const int kh = blockIdx.x, l = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = lengths[b];
  if (kPaged && base == 0) return;  // an idle slot: its table row may be stale
  const int rows = min(W, (kPaged ? max_pages * S : S) - base);
  const size_t src = (((size_t)b * n_layers + l) * KH + kh) * (size_t)W * E;
  for (int w = warp; w < rows; w += kWarps) {
    const int g = base + w;
    const int blk = kPaged ? table[(size_t)b * max_pages + g / S] : b;
    const size_t row = (((size_t)l * n_blocks + blk) * KH + kh) * (size_t)S + (kPaged ? g % S : g);
    const size_t o = src + (size_t)w * E;
    write_row(k_stage + o, k_cache + row * E, k_scale ? k_scale + row : nullptr, E, lane);
    write_row(v_stage + o, v_cache + row * E, v_scale ? v_scale + row : nullptr, E, lane);
  }
}

template <bool kPaged>
int flush(const void* k_stage, const void* v_stage, void* k_cache, void* v_cache, void* k_scale,
          void* v_scale, const void* lengths, const void* table, int B, int n_blocks,
          int max_pages, int n_layers, int KH, int S, int W, int E, int cache_kind,
          void* stream) {
  if ((cache_kind == 2 && (k_scale == nullptr || v_scale == nullptr)) ||
      (!kPaged && n_blocks != B))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(KH, n_layers, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* ks = static_cast<const __nv_bfloat16*>(k_stage);
  const auto* vs = static_cast<const __nv_bfloat16*>(v_stage);
  const auto* lens = static_cast<const int*>(lengths);
  const auto* tab = static_cast<const int*>(table);
  auto* ksc = static_cast<float*>(k_scale);
  auto* vsc = static_cast<float*>(v_scale);
#define NNOP_FLUSH_LAUNCH(T)                                                                   \
  flush_kernel<T, kPaged><<<grid, kThreads, 0, st>>>(ks, vs, static_cast<T*>(k_cache),       \
                                                      static_cast<T*>(v_cache), ksc, vsc, lens, \
                                                      tab, n_blocks, max_pages, n_layers, KH,   \
                                                      S, W, E)
  if (cache_kind == 2)
    NNOP_FLUSH_LAUNCH(int8_t);
  else if (cache_kind == 1)
    NNOP_FLUSH_LAUNCH(float);
  else
    NNOP_FLUSH_LAUNCH(__nv_bfloat16);
#undef NNOP_FLUSH_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// Grid (KH, B): copy the D elements of new[b, kh, 0] over
// cache[b, kh, positions[b]], as raw words of the element's size.
template <typename U>
__global__ void __launch_bounds__(kThreads)
write_token_kernel(U* __restrict__ cache, const U* __restrict__ src,
                   const int* __restrict__ positions, int KH, int S, int D) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int pos = positions[b];
  if (pos < 0 || pos >= S) return;
  const size_t bk = (size_t)b * KH + kh;
  U* dst = cache + (bk * S + pos) * D;
  const U* in = src + bk * D;
  for (int i = threadIdx.x; i < D; i += kThreads) dst[i] = in[i];
}

}  // namespace

// staging (B, n_layers, KH, W, E) bf16; caches (n_layers, n_blocks, KH,
// S, E) of cache_kind 0 bf16, 1 f32, 2 int8 (then scales (n_layers,
// n_blocks, KH, S) f32); lengths (B,) int32. Linear when page_table is
// null (n_blocks = B); else pools of n_blocks pages of S tokens and
// page_table (B, max_pages) int32.
extern "C" int nnop_flush_staging(const void* k_stage, const void* v_stage, void* k_cache,
                                  void* v_cache, void* k_scale, void* v_scale,
                                  const void* lengths, const void* page_table, int B,
                                  int n_blocks, int max_pages, int n_layers, int KH, int S, int W,
                                  int E, int cache_kind, void* stream) {
  return page_table != nullptr
             ? flush<true>(k_stage, v_stage, k_cache, v_cache, k_scale, v_scale, lengths,
                           page_table, B, n_blocks, max_pages, n_layers, KH, S, W, E, cache_kind,
                           stream)
             : flush<false>(k_stage, v_stage, k_cache, v_cache, k_scale, v_scale, lengths,
                            nullptr, B, n_blocks, 0, n_layers, KH, S, W, E, cache_kind, stream);
}

// cache (B, KH, S, D) and new (B, KH, 1, D) of one dtype whose elements
// are elem_bytes (1, 2 or 4) wide; positions (B,) int32.
extern "C" int nnop_write_kv_token(void* cache, const void* new_rows, const void* positions, int B,
                                   int KH, int S, int D, int elem_bytes, void* stream) {
  const dim3 grid(KH, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pos = static_cast<const int*>(positions);
  if (elem_bytes == 4)
    write_token_kernel<uint32_t><<<grid, kThreads, 0, st>>>(
        static_cast<uint32_t*>(cache), static_cast<const uint32_t*>(new_rows), pos, KH, S, D);
  else if (elem_bytes == 2)
    write_token_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        static_cast<uint16_t*>(cache), static_cast<const uint16_t*>(new_rows), pos, KH, S, D);
  else if (elem_bytes == 1)
    write_token_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        static_cast<uint8_t*>(cache), static_cast<const uint8_t*>(new_rows), pos, KH, S, D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
