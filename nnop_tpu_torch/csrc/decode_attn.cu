// Decode attention for Hopper (sm_90a): T query tokens per sequence over
// the stacked KV cache, or one over a page pool through a page table, plus
// the bf16 staging buffer.
//
// Replaces nnop_tpu/ops/attention_decode.py:decode_attention (_decode_kernel
// with _decode_step_b / _decode_step_b_flat / _staging_step_b), T = 1 and
// the speculative-verify mode T > 1, and
// nnop_tpu/ops/attention_decode_paged.py:paged_decode_attention
// (_paged_kernel, T = 1) for a floating-point or int8 cache, with the
// sliding window and the score softcap, at head dim 128 or 256.
//
// Bound on the H100: device-memory bandwidth. Each step reads every live
// cache row of the layer once (lengths[b] * E * 2 values per KV head)
// against ~4 * G flops per value, far below the flop/byte ridge. The
// design reads each K and V row once for all G query heads of its KV head
// (one block per (slot, KV head) holds the G heads) and only live rows
// (< lengths[b]); an int8 cache halves those bytes and is dequantized as
// its tile lands in shared memory. A block stages each 32-row K/V tile in
// shared memory with 16-byte loads issued together (so their latencies
// overlap), scores one (head, key) pair per thread, and accumulates P V
// with one output column per thread; the online-softmax state stays on
// chip. It is the simple form: 64 blocks at the serving batch cannot fill
// 132 SMs, so split-KV with a combine pass is the next step.
//
// Semantics (attention_decode.py:48-171, 404-481): lengths[b] counts
// FLUSHED tokens, so cache rows [0, lengths[b]) are live; staging rows
// [0, staged_n) hold the newest tokens and are masked for a slot with
// lengths[b] == 0. The cache part rounds P to the cache dtype before the
// PV product; the staging part runs with q and P rounded to bf16. Query
// row g of KV head kh is query head kh * G + g. A slot with no live key
// writes zeros (l == 0 is guarded).
//
// int8 cache (the engine's TPU path, _decode_step_b_flat, :282-401): per
// token f32 scales k_scale/v_scale (n_layers, B, KH, S). q is rounded to
// bf16 for the cache part too; a score is (q . k) * scale * k_scale[key];
// the softmax max and sum are taken before the V scale, which is folded
// into P; P * v_scale is rounded to bf16 for the PV product (int8 values
// are exact in bf16).
//
// Paged mode (attention_decode_paged.py:39-282): the cache is a pool
// (n_layers, n_pages, KH, page, E) and key c of slot b sits in row
// c % page of page table[b][c / page]. With page % 32 == 0 a 32-key tile
// never crosses a page, so the mode changes only where a tile's rows and
// scales start (`tile_row`); the table entry of a page is read only for
// pages below ceil(len / page), as the TPU kernel clamps the rest. The
// TPU kernel steps its online softmax once per page and the linear mode
// here once per tile; both round P at their own steps.
//
// Window (attention_decode.py:187-197, 310-314, 438-441; paged :128-129,
// 182-183, 244-246): the query sits at position len + staged_n - 1, so a
// cache row p is live iff p >= len + staged_n - window and a staged row w
// iff w >= staged_n - window. Each block starts its walk at the tile (in
// paged mode, inside the page) that holds its own slot's first live row,
// so a slot reads at most window + 31 cache rows whatever its length (the
// TPU kernel skips dead blocks from the batch group's minimum). The first
// tile's dead rows and the dead staged rows are masked. Softcap: s = c * tanh(s / c) on the scaled score (after the K
// scale of an int8 cache), before any mask.
//
// Head dim: one thread per output column, so E threads a block (4 warps
// at 128, 8 at 256). K and V tiles of 32 keys are staged as f32 in
// shared memory: static at E = 128 (38 KB), dynamic at E = 256 (74 KB).
// The E = 128 kernel on dynamic shared memory ran markedly slower (fewer
// registers, spills); at E = 256, 16-key tiles that fit static shared
// memory ran slower still (twice the serial tile steps).
//
// Verify mode (T > 1, attention_decode.py:86-90, 306-313, 431-441; the
// engine's speculative decoding): the T query tokens are the last T staged
// ones, so draft t sits at position len + staged_n - T + t. A block holds
// the R = T * G rows [draft t][head g] of its (slot, KV head) and reads
// each live K/V tile once for all of them, so a verify step moves the
// cache bytes of one decode step, not T of them. The cache part is the
// same for every row but for the window edge, which is per row: the walk
// starts at the tile of the block's lowest draft's edge and each row
// masks its own. In the staging part draft t sees the staged rows w <=
// staged_n - T + t (causal among the drafts). Rows are bounded at compile
// time (kMaxRows); past it the launch splits whole drafts over
// gridDim.z, each z-block reading the cache once for its drafts. The
// mode is a template flag (kVerify), so the T = 1 instantiations are
// compiled as before; its shared memory is dynamic (53 KB at E = 128,
// 101 KB at E = 256), and a linear cache only (the paged op is T = 1).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 32;      // keys per tile; the staging buffer (W <= 32) is one tile
constexpr int kMaxG = 8;       // query heads per KV head
constexpr int kMaxRows = 32;   // query rows (draft x head) a verify block holds

// kRows query rows: kMaxG for T = 1, kMaxRows in the verify mode
template <int E, int kRows = kMaxG>
struct DecodeSmem {
  static constexpr int kRow = E + 1;  // padded row (floats): row-strided reads hit distinct banks
  float q[kRows][E];
  float k[kTile][kRow];
  float v[kTile][kRow];
  float p[kRows][kTile];  // scores, then the (rounded) probabilities
  float m[kRows], l[kRows], alpha[kRows];
  float ks[kTile], vs[kTile];  // the tile's per-token scales (int8 cache)
};

// The verify mode's per-row key range in a tile: row r (draft dt = r /
// group of the block) sees keys [lo + dt * lo_step, min(n, hi + dt *
// hi_step)), where lo is the block's first row's (it may be negative).
struct RowEdges {
  int group, lo_step, hi, hi_step;
};

// Copy n (<= kTile) rows of E values at src into dst as floats, with E
// threads. All of a thread's 16-byte loads are issued before any store,
// so their latencies overlap.
template <int E, typename KV>
__device__ __forceinline__ void load_tile(const KV* __restrict__ src, int n,
                                          float (*dst)[E + 1]) {
  constexpr int kVec = 16 / sizeof(KV);            // values per 16-byte vector
  constexpr int kVecs = E / kVec;                  // vectors per row
  constexpr int kPer = kTile * kVecs / E;          // vectors per thread per tile
  uint4 raw[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * E, r = i / kVecs, c = (i % kVecs) * kVec;
    raw[u] = r < n ? *reinterpret_cast<const uint4*>(src + (size_t)r * E + c)
                   : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * E, r = i / kVecs, c = (i % kVecs) * kVec;
    const KV* vals = reinterpret_cast<const KV*>(&raw[u]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r][c + e] = nnop::to_float(vals[e]);
  }
}

// Online-softmax update of the `rows` query rows with the keys [lo, n)
// (n <= kTile) of the tile at kt / vt (rows of E): keys below lo are
// window-dead and keys from n on are past the slot's length; both are
// masked. In the verify mode each row narrows that range by `edges`. PT
// is the type P is rounded to for the PV product. ksc / vsc: the keys'
// scales of an int8 tile (unread for a floating-point one). kSoftcap caps
// the scores at softcap (inv_cap = 1 / softcap).
template <int E, int kRows, bool kVerify, bool kSoftcap, typename KV, typename PT>
__device__ __forceinline__ void attend_tile(const KV* __restrict__ kt, const KV* __restrict__ vt,
                                            const float* __restrict__ ksc,
                                            const float* __restrict__ vsc, int lo, int n, int rows,
                                            RowEdges edges, float scale, float softcap,
                                            float inv_cap, DecodeSmem<E, kRows>& sm, float* acc) {
  constexpr int kWarps = E / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr bool q8 = std::is_same<KV, int8_t>::value;
  load_tile<E>(kt, n, sm.k);
  load_tile<E>(vt, n, sm.v);
  if (q8 && threadIdx.x < n) {
    sm.ks[threadIdx.x] = ksc[threadIdx.x];
    sm.vs[threadIdx.x] = vsc[threadIdx.x];
  }
  __syncthreads();
  // scores: one (query row, key) pair per thread
  for (int i = threadIdx.x; i < rows * kTile; i += E) {
    const int gq = i / kTile, j = i % kTile;
    if (j < n) {
      float d = 0.f;
#pragma unroll 16
      for (int e = 0; e < E; ++e) d += sm.q[gq][e] * sm.k[j][e];
      d = q8 ? d * scale * sm.ks[j] : d * scale;
      if constexpr (kSoftcap) d = softcap * tanhf(d * inv_cap);
      sm.p[gq][j] = d;
    }
  }
  __syncthreads();
  // softmax state: warp w updates query rows w, w + kWarps
  const bool live_all = lane >= lo && lane < n;
  for (int gq = warp; gq < rows; gq += kWarps) {
    bool live = live_all;
    if constexpr (kVerify) {
      const int dt = gq / edges.group;
      live = lane >= lo + dt * edges.lo_step && lane < min(n, edges.hi + dt * edges.hi_step);
    }
    const float m_old = sm.m[gq];
    const float s = live ? sm.p[gq][lane] : nnop::kMaskValue;
    const float m_new = fmaxf(m_old, nnop::warp_max(s));
    const float p = live ? __expf(s - m_new) : 0.f;
    // int8: the V scale folds into P after the sum, P rounds to bf16
    sm.p[gq][lane] = q8 ? (live ? nnop::round_to<__nv_bfloat16>(p * sm.vs[lane]) : 0.f)
                        : nnop::round_to<PT>(p);
    const float sum = nnop::warp_sum(p);
    if (lane == 0) {
      const float alpha = __expf(m_old - m_new);
      sm.alpha[gq] = alpha;
      sm.m[gq] = m_new;
      sm.l[gq] = sm.l[gq] * alpha + sum;
    }
  }
  __syncthreads();
  // acc = acc * alpha + P V for column e = threadIdx.x
  const int e = threadIdx.x;
#pragma unroll
  for (int gq = 0; gq < kRows; ++gq)
    if (gq < rows) acc[gq] *= sm.alpha[gq];
  // the first row's lo is the lowest (keys a row does not see have P = 0)
  for (int j = kVerify ? max(lo, 0) : lo; j < n; ++j) {
    const float vv = sm.v[j][e];
#pragma unroll
    for (int gq = 0; gq < kRows; ++gq)
      if (gq < rows) acc[gq] += sm.p[gq][j] * vv;
  }
  __syncthreads();  // the next tile overwrites sm.k, sm.v and sm.p
}

// The first cache row (in units of E values) of the tile starting at key
// c0 of slot b. A linear cache has n_blocks = B blocks of S keys per
// layer, and slot b's rows start at `base` (its block's first row); a
// pool has n_blocks = n_pages pages of S = page keys, found through the
// slot's row of the page table.
template <bool kPaged>
__device__ __forceinline__ size_t tile_row(size_t base, int layer, int n_blocks, int kh, int KH,
                                           int S, const int* __restrict__ slot_table, int c0) {
  if constexpr (kPaged)
    return (((size_t)layer * n_blocks + slot_table[c0 / S]) * KH + kh) * (size_t)S + c0 % S;
  else
    return base + c0;
}

// Grid (KH, B), E threads; in the verify mode (KH, B, Z), block z taking
// drafts [z * tpz, min(T, (z + 1) * tpz)) with tpz = kMaxRows / G. Caches
// (n_layers, n_blocks, KH, S, E) of KV (T, or int8 with scales
// (n_layers, n_blocks, KH, S) f32): n_blocks = B linear, or n_pages
// paged with S = page and table (B, max_pages); staging (B, n_layers, KH,
// W, E) bf16 or null; q, o (B, QH, T, E) of T. window 0 turns the window
// off; kSoftcap compiles the softcap in.
template <int E, typename T, typename KV, bool kPaged, bool kSoftcap, bool kVerify>
__global__ void __launch_bounds__(E)
decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_cache,
              const KV* __restrict__ v_cache, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, const __nv_bfloat16* __restrict__ k_stage,
              const __nv_bfloat16* __restrict__ v_stage, const int* __restrict__ lengths,
              const int* __restrict__ table, T* __restrict__ o, int B, int QH, int KH, int S,
              int n_blocks, int max_pages, int n_layers, int layer, int W, int staged_n,
              float scale, int window, float softcap, float inv_cap, int n_draft) {
  constexpr bool kQ8 = std::is_same<KV, int8_t>::value;
  constexpr int kRows = kVerify ? kMaxRows : kMaxG;
  using PT = typename std::conditional<kQ8, __nv_bfloat16, KV>::type;
  DecodeSmem<E, kRows>& sm = nnop::block_smem<DecodeSmem<E, kRows>>();
  const int kh = blockIdx.x, b = blockIdx.y, G = QH / KH;
  const int len = lengths[b];
  // this block's drafts [t0, t0 + rows / G); row r is draft t0 + r / G, head r % G
  int t0 = 0, rows = G;
  if constexpr (kVerify) {
    const int tpz = kMaxRows / G;
    t0 = blockIdx.z * tpz;
    rows = min(tpz, n_draft - t0) * G;
    for (int i = threadIdx.x; i < rows * E; i += E) {
      const int r = i / E;
      const float v = nnop::to_float(
          q[(((size_t)b * QH + (size_t)kh * G + r % G) * n_draft + t0 + r / G) * E + i % E]);
      sm.q[r][i % E] = kQ8 ? nnop::round_to<__nv_bfloat16>(v) : v;
    }
  } else {
    const T* qb = q + ((size_t)b * QH + (size_t)kh * G) * E;
    for (int i = threadIdx.x; i < G * E; i += E) {
      const float v = nnop::to_float(qb[i]);
      sm.q[i / E][i % E] = kQ8 ? nnop::round_to<__nv_bfloat16>(v) : v;
    }
  }
  if (threadIdx.x < kRows) {
    sm.m[threadIdx.x] = nnop::kMaskValue;
    sm.l[threadIdx.x] = 0.f;
  }
  float acc[kRows];
#pragma unroll
  for (int gq = 0; gq < kRows; ++gq) acc[gq] = 0.f;
  __syncthreads();

  // the first live cache row (of the block's first draft), and the tile
  // that holds it; `edge` is that draft's window edge, unclamped
  const int edge = len + staged_n - (kVerify ? n_draft - t0 : 1) + 1 - window;
  const int first = window > 0 ? max(0, edge) : 0;
  const RowEdges cache_edges{G, window > 0 ? 1 : 0, kTile, 0};
  const size_t base = (((size_t)layer * n_blocks + b) * KH + kh) * (size_t)S;
  const int* slot_table = kPaged ? table + (size_t)b * max_pages : nullptr;
  for (int c0 = first < len ? first / kTile * kTile : len; c0 < len; c0 += kTile) {
    const size_t row = tile_row<kPaged>(base, layer, n_blocks, kh, KH, S, slot_table, c0);
    attend_tile<E, kRows, kVerify, kSoftcap, KV, PT>(
        k_cache + row * E, v_cache + row * E, kQ8 ? k_scale + row : nullptr,
        kQ8 ? v_scale + row : nullptr, kVerify && window > 0 ? edge - c0 : max(0, first - c0),
        min(kTile, len - c0), rows, cache_edges, scale, softcap, inv_cap, sm, acc);
  }
  if (k_stage != nullptr && len > 0 && staged_n > 0) {
    // the staging part runs with q rounded to bf16 (every cache tile is done)
    for (int i = threadIdx.x; i < rows * E; i += E)
      sm.q[i / E][i % E] = nnop::round_to<__nv_bfloat16>(sm.q[i / E][i % E]);
    __syncthreads();
    const size_t st_off = (((size_t)b * n_layers + layer) * KH + kh) * (size_t)W * E;
    // the block's first draft sits at staged row `own`: it sees [own + 1 - window, own]
    const int own = staged_n - (kVerify ? n_draft - t0 : 1);
    const RowEdges stage_edges{G, window > 0 ? 1 : 0, own + 1, 1};
    attend_tile<E, kRows, kVerify, kSoftcap, __nv_bfloat16, __nv_bfloat16>(
        k_stage + st_off, v_stage + st_off, nullptr, nullptr,
        kVerify ? (window > 0 ? own + 1 - window : 0) : (window > 0 ? max(0, staged_n - window) : 0),
        staged_n, rows, stage_edges, scale, softcap, inv_cap, sm, acc);
  }
#pragma unroll
  for (int gq = 0; gq < kRows; ++gq) {
    if (gq < rows) {
      const float l = sm.l[gq];
      const size_t orow = kVerify ? ((size_t)b * QH + (size_t)kh * G + gq % G) * n_draft + t0 +
                                        gq / G
                                  : (size_t)b * QH + (size_t)kh * G + gq;
      o[orow * E + threadIdx.x] = nnop::from_float<T>(acc[gq] / (l == 0.f ? 1.f : l));
    }
  }
}

template <int E, typename T, typename KV, bool kPaged, bool kSoftcap, bool kVerify>
cudaError_t launch_one(const void* q, const void* k_cache, const void* v_cache,
                       const void* k_scale, const void* v_scale, const void* k_stage,
                       const void* v_stage, const void* lengths, const void* table, void* o,
                       int B, int QH, int KH, int S, int n_blocks, int max_pages, int n_layers,
                       int layer, int W, int staged_n, float scale, int window,
                       cudaStream_t st, float softcap, int n_draft) {
  using Smem = DecodeSmem<E, kVerify ? kMaxRows : kMaxG>;
  constexpr int kDynamic = nnop::dynamic_smem_bytes<Smem>;
  static const cudaError_t opt_in =
      nnop::opt_in_dynamic_smem<Smem>(decode_kernel<E, T, KV, kPaged, kSoftcap, kVerify>);
  if (opt_in != cudaSuccess) return opt_in;
  const int tpz = kMaxRows / (QH / KH);  // drafts a verify block holds
  const dim3 grid(KH, B, kVerify ? (n_draft + tpz - 1) / tpz : 1);
  decode_kernel<E, T, KV, kPaged, kSoftcap, kVerify><<<grid, E, kDynamic, st>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_cache), static_cast<const KV*>(v_cache),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(k_stage), static_cast<const __nv_bfloat16*>(v_stage),
      static_cast<const int*>(lengths), static_cast<const int*>(table), static_cast<T*>(o), B,
      QH, KH, S, n_blocks, max_pages, n_layers, layer, W, staged_n, scale, window, softcap,
      kSoftcap ? 1.f / softcap : 0.f, n_draft);
  return cudaGetLastError();
}

// The verify mode (n_draft > 1) is built for a linear cache only.
template <int E, typename T, typename KV, bool kPaged, typename... Args>
cudaError_t launch(float softcap, int n_draft, Args... args) {
  if constexpr (!kPaged) {
    if (n_draft > 1)
      return softcap > 0.f ? launch_one<E, T, KV, false, true, true>(args..., softcap, n_draft)
                           : launch_one<E, T, KV, false, false, true>(args..., softcap, n_draft);
  }
  return softcap > 0.f ? launch_one<E, T, KV, kPaged, true, false>(args..., softcap, 1)
                       : launch_one<E, T, KV, kPaged, false, false>(args..., softcap, 1);
}

template <int E, bool kPaged>
cudaError_t dispatch_types(const void* q, const void* k_cache, const void* v_cache,
                           const void* k_scale, const void* v_scale, const void* k_stage,
                           const void* v_stage, const void* lengths, const void* table, void* o,
                           int B, int QH, int KH, int S, int n_blocks, int max_pages,
                           int n_layers, int layer, int W, int staged_n, float scale, int window,
                           float softcap, int q_is_f32, int cache_is_int8, int n_draft,
                           cudaStream_t st) {
#define NNOP_DECODE_LAUNCH(T, KV)                                                              \
  launch<E, T, KV, kPaged>(softcap, n_draft, q, k_cache, v_cache, k_scale, v_scale, k_stage,   \
                           v_stage, lengths, table, o, B, QH, KH, S, n_blocks, max_pages,      \
                           n_layers, layer, W, staged_n, scale, window, st)
  if (cache_is_int8)
    return q_is_f32 ? NNOP_DECODE_LAUNCH(float, int8_t) : NNOP_DECODE_LAUNCH(__nv_bfloat16, int8_t);
  return q_is_f32 ? NNOP_DECODE_LAUNCH(float, float)
                  : NNOP_DECODE_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef NNOP_DECODE_LAUNCH
}

template <bool kPaged>
int dispatch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
             const void* v_scale, const void* k_stage, const void* v_stage, const void* lengths,
             const void* table, void* o, int B, int QH, int KH, int S, int E, int n_draft,
             int n_blocks, int max_pages, int n_layers, int layer, int W, int staged_n,
             float scale, int window, float softcap, int q_is_f32, int cache_is_int8,
             void* stream) {
  if ((E != 128 && E != 256) || QH % KH != 0 || QH / KH > kMaxG || W > kTile ||
      staged_n > W || window < 0 || (cache_is_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      (kPaged ? S % kTile != 0 : n_blocks != B) || n_draft < 1 ||
      (n_draft > 1 && (kPaged || k_stage == nullptr || n_draft > staged_n)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cache_is_int8) k_scale = v_scale = nullptr;
#define NNOP_DECODE_ARGS                                                                    \
  q, k_cache, v_cache, k_scale, v_scale, k_stage, v_stage, lengths, table, o, B, QH, KH, S,  \
      n_blocks, max_pages, n_layers, layer, W, staged_n, scale, window, softcap, q_is_f32,    \
      cache_is_int8, n_draft, st
  const cudaError_t e = E == 128 ? dispatch_types<128, kPaged>(NNOP_DECODE_ARGS)
                                 : dispatch_types<256, kPaged>(NNOP_DECODE_ARGS);
#undef NNOP_DECODE_ARGS
  return static_cast<int>(e);
}

}  // namespace

// q (B, QH, T, E) and o bf16, or f32 when q_is_f32; caches stacked
// (n_layers, n_blocks, KH, S, E) of q's dtype, or int8 when cache_is_int8
// with scales (n_layers, n_blocks, KH, S) f32; staging (B, n_layers, KH,
// W, E) bf16 or null; lengths (B,) int32. Linear when page_table is null
// (n_blocks = B); else pools of n_blocks pages of S keys (S a multiple of
// 32) and page_table (B, max_pages) int32. E must be 128 or 256, QH / KH
// <= 8 and W <= 32. window > 0 keeps the last `window` positions and
// softcap > 0 caps the scores; 0 turns either off. T > 1 (the verify
// mode) needs a linear cache and the staging with T <= staged_n.
extern "C" int nnop_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                     const void* k_scale, const void* v_scale,
                                     const void* k_stage, const void* v_stage,
                                     const void* lengths, const void* page_table, void* o, int B,
                                     int QH, int KH, int S, int E, int T, int n_blocks,
                                     int max_pages, int n_layers, int layer, int W, int staged_n,
                                     float scale, int window, float softcap, int q_is_f32,
                                     int cache_is_int8, void* stream) {
  return page_table != nullptr
             ? dispatch<true>(q, k_cache, v_cache, k_scale, v_scale, k_stage, v_stage, lengths,
                              page_table, o, B, QH, KH, S, E, T, n_blocks, max_pages, n_layers,
                              layer, W, staged_n, scale, window, softcap, q_is_f32,
                              cache_is_int8, stream)
             : dispatch<false>(q, k_cache, v_cache, k_scale, v_scale, k_stage, v_stage, lengths,
                               nullptr, o, B, QH, KH, S, E, T, n_blocks, 0, n_layers, layer, W,
                               staged_n, scale, window, softcap, q_is_f32, cache_is_int8,
                               stream);
}
