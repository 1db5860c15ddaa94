// Decode attention for Hopper (sm_90a): kernel D. T query tokens per
// sequence over the stacked KV cache, or one over a page pool through a
// page table, plus the bf16 staging buffer; split-KV over blocks, with
// the splits' combine inside the same launch.
//
// Replaces nnop_tpu/ops/attention_decode.py:decode_attention (_decode_kernel
// with _decode_step_b / _decode_step_b_flat / _staging_step_b), T = 1 and
// the speculative-verify mode T > 1, and
// nnop_tpu/ops/attention_decode_paged.py:paged_decode_attention
// (_paged_kernel, T = 1) for a bf16, f32 or int8 cache, with the sliding
// window and the score softcap, at any head dim E <= 256 with E % 16 == 0.
//
// Bound on the H100: device-memory bytes. Each call reads every live K/V
// row of one layer once (lengths[b] * E values per KV head, twice)
// against ~4 * T * G flops a value, far below the flop/byte ridge. So the
// design (a) keeps enough bytes in flight on all 132 SMs and (b) keeps the
// arithmetic off the critical path as the T * G query rows grow:
//
// Split-KV, no host sync. Grid (KH, B, n_split * Z): block (kh, b, s, z)
// takes the contiguous range of its slot's live 64-key tiles that
// ops/attention_decode.py:split_tiles gives split s (this source repeats
// its formula), found on the device from lengths[b] and the window edge of
// its first draft; the host picks n_split from B, KH, Z, the cache's span
// and the SM count (split_count) and never reads lengths. The staged rows
// belong to the last split. A block whose range is empty writes an empty
// partial.
//
// Tensor cores. A block's 4 warps each take every fourth 16-key chunk of
// the block's range (cache chunks, then the staging's) and run an
// online softmax of their own: S = q K^T and O += P V on mma.sync
// m16n8k16 (bf16 in, f32 sums), the block's T * G query rows padded to
// kM whole 16-row tiles and read as A fragments with ldmatrix, K and V
// as B fragments (ldmatrix, .trans for V, where the tile is bf16). The
// scale, the int8 K scale, the softcap, each row's own visible range
// (length, window edge, and the causal bound among the drafts) and the
// int8 V scale (folded into P) are applied on the score fragments; P is
// rounded to bf16 in registers and is the A fragment of P V.
//
// bf16 tiles in a pipeline. Each warp streams its chunks through a ring of
// kStages slots in shared memory with cp.async (16 bytes a lane, rows past
// the live ones zero-filled, so no garbage reaches an mma), so the next
// chunk's bytes are in flight while the current one computes; a warp only
// syncs with itself. Tiles land in the cache's own width: bf16 as is; int8
// turned to bf16 as the fragments are built (exact); f32 (the f32 mode)
// rounded to bf16 there too. In paged mode a chunk never crosses a page
// (pages hold whole 32-key tiles) and its page-table entry is read one
// chunk ahead.
//
// The combine inside the launch. The 4 warps' (max, sum, o) merge in
// shared memory; then each block writes its partial (m, l, unnormalised o,
// f32) to a workspace and takes a ticket from a per-(slot, KV head, z)
// int32 counter (after __threadfence); the last block of the group merges
// all partials in split order (the (o, lse) monoid of
// nnop_tpu/ops/flash_attention.py:lse_merge in (m, l) form), writes o and
// resets the counter. One call is one launch, and the sums run in one
// fixed order, so reruns give the same bits. With n_split 1 the block
// writes o directly.
//
// Semantics (attention_decode.py:48-171, 404-481): lengths[b] counts
// FLUSHED tokens, so cache rows [0, lengths[b]) are live; staging rows
// [0, staged_n) hold the newest tokens, at positions lengths[b] + w. Draft
// t (the T queries are the last T staged tokens) sits at position qpos =
// len + staged_n - T + t and sees position p iff p <= qpos and, with a
// window, p > qpos - window: the intra-draft causal mask and each draft's
// own window edge are one rule in position space. A slot with lengths[b]
// == 0 sees nothing and writes zeros (l == 0 is guarded). Query row r of
// a block is draft t0 + r / G, head kh * G + r % G. q is rounded to bf16
// and P is rounded to bf16 in every part and mode: the TPU rounds P to the
// cache type (bf16) and runs the staging part and the int8 cache in bf16;
// an f32 cache and f32 q run here as the TPU's default-precision f32 dots
// do, as bf16 passes. int8 cache (_decode_step_b_flat, :282-401): per-token
// f32 scales; a score is (q . k) * scale * k_scale[key]; the softmax max
// and sum are taken before the V scale, which folds into P before P's
// bf16 rounding (int8 values are exact in bf16). The softcap is s = c *
// tanh(s / c) on the scaled score, before any mask. The online softmax
// steps once per 16-key chunk (the TPU kernel once per block or page):
// the two round P at their own steps.
//
// Head dim: the kernel is built for Ep = 64, 128 and 256 (one .cu file
// each) and takes the true E <= Ep at run time: a tile row is read from
// its own stride (E values), only E / 16 k-steps and E / 16 column pairs
// run, and o stores E lanes, so no copy is made per call. ptxas -v on
// sm_90a: no spill in any instantiation; Ep 128 takes 124-128 registers
// (213-226 with two row tiles), Ep 256 196-206, Ep 64 94-96 (144-163).

#pragma once

#include <type_traits>

#include "common.cuh"

namespace nnop_decode {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;                  // keys a warp takes at a time: one k-step of P V
constexpr int kTileKeys = kWarps * kChunk;  // the split plan's tile (ops/attention_decode.py)
constexpr int kMaxG = 8;                    // query heads per KV head
constexpr int kMaxStage = 32;               // staging rows
constexpr int kMaxSplit = 128;              // splits of one (slot, KV head, z)
constexpr int kPageMultiple = 32;           // a page holds whole 32-key tiles

// What the entry takes (null where absent; window 0 and softcap 0 are
// off). kv_kind: 0 bf16, 1 f32, 2 int8.
struct Params {
  const void* q;
  const void *k_cache, *v_cache;
  const float *k_scale, *v_scale;
  const __nv_bfloat16 *k_stage, *v_stage;
  const int* lengths;
  const int* table;
  void* o;
  float* ws;
  int* tickets;
  long long ws_elems;  // ws's f32 elements and tickets' int32s, checked by launch_m
  int n_tickets;
  int B, QH, KH, S, E, n_draft, n_blocks, max_pages, n_layers, layer, W, staged_n;
  int window, q_f32, kv_kind, n_split;
  float scale, softcap;
  cudaStream_t stream;
};

// The launchers of one padded head dim, instantiated in decode_attn_e<Ep>.cu.
template <int Ep>
cudaError_t launch(const Params& p);

// Query rows a block holds: kM 16-row tiles. A verify step with more than
// 16 rows takes two tiles where the registers allow (Ep <= 128, linear);
// past a block's rows whole drafts split over gridDim.z. The same rule as
// ops/attention_decode.py:block_rows.
__host__ __device__ constexpr int rows_m(int n_rows, int Ep, bool paged) {
  return !paged && n_rows > 16 && Ep <= 128 ? 2 : 1;
}

template <typename A, typename B>
constexpr A cmax(A a, B b) { return a > b ? a : static_cast<A>(b); }

// Shared memory of one instantiation (bytes): each warp's ring of cp.async
// slots (a slot: the K tile, the V tile, the int8 scales), which after the
// walk holds the warps' merge slab and then the splits' (m, l);
// the q tile; the warps' and the block's row max and sum.
template <int Ep, int kM, typename KV>
struct Layout {
  static constexpr int kRows = 16 * kM;
  // a slot's element bytes: the staging's bf16 tiles share the ring
  static constexpr int kElem = cmax(static_cast<int>(sizeof(KV)), 2);
  static constexpr int kRS = Ep * kElem + 16;  // a tile row, padded: conflict-free fragments
  static constexpr int kSlot = 2 * kChunk * kRS + 2 * kChunk * 4;
  // chunks in flight a warp: the ring within ~100 KB, so that two blocks
  // fit an SM (at Ep 256 one chunk a warp, and the SM's other block's
  // warps overlap its loads)
  static constexpr int kStages = Ep == 256 ? 1
                                 : kWarps * kSlot * 3 <= 100 * 1024 ? 3
                                 : kWarps * kSlot * 2 <= 100 * 1024 ? 2
                                                                    : 1;
  static constexpr int kRing = kWarps * kStages * kSlot;
  static constexpr int kSlabRow = Ep + 4;  // floats
  static constexpr int kSlab = kWarps * kRows * kSlabRow * 4;
  static constexpr int kWeights = 2 * kMaxSplit * kRows * 4;
  static constexpr int kBig = cmax(cmax(kRing, kSlab), kWeights);
  static constexpr int kQRow = Ep * 2 + 16;
  static constexpr int kQ = kRows * kQRow;
  static constexpr int kBytes = kBig + kQ + (2 * kWarps * kRows + 2 * kRows) * 4 + 16;
  static_assert(kBig % 16 == 0 && kQ % 16 == 0, "16-byte aligned regions");
  static_assert(kBytes <= 227 * 1024, "a block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (or, with ok false, 16 zeros) from global to shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two values of a tile (lo, hi) -> one register of two bf16 (exact for
// int8 and bf16, rounded for f32).
__device__ __forceinline__ uint32_t bf16x2_of(int8_t lo, int8_t hi) {
  return nnop::pack_bf16x2(static_cast<float>(lo), static_cast<float>(hi));
}
__device__ __forceinline__ uint32_t bf16x2_of(float lo, float hi) {
  return nnop::pack_bf16x2(lo, hi);
}

// The B fragments of S = q K^T for k-step kk (head dims kk*16 .. +15) and
// the chunk's two 8-key column tiles: b[0..1] keys 0-7, b[2..3] keys 8-15.
// A tile row is a key (kRS bytes); lane = 4 * g + t.
template <typename Tile, int kRS>
__device__ __forceinline__ void k_frags(const unsigned char* kt, int kk, int lane, uint32_t* b) {
  if constexpr (std::is_same<Tile, __nv_bfloat16>::value) {
    ldsm_x4(b, kt + ((lane & 7) + ((lane >> 4) << 3)) * kRS + (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const Tile* row = reinterpret_cast<const Tile*>(kt + (n * 8 + g) * kRS) + kk * 16 + 2 * t;
      b[2 * n] = bf16x2_of(row[0], row[1]);
      b[2 * n + 1] = bf16x2_of(row[8], row[9]);
    }
  }
}

// The B fragments of O += P V for head-dim columns np*16 .. +15 (two
// 8-wide column tiles): b[0..1] the first tile's, b[2..3] the second's.
template <typename Tile, int kRS>
__device__ __forceinline__ void v_frags(const unsigned char* vt, int np, int lane, uint32_t* b) {
  if constexpr (std::is_same<Tile, __nv_bfloat16>::value) {
    ldsm_x4_trans(b, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * kRS + (np * 16 + (lane >> 4) * 8) * 2);
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Tile* col = reinterpret_cast<const Tile*>(vt) + (np * 2 + h) * 8 + g;
      constexpr int kStride = kRS / static_cast<int>(sizeof(Tile));
      b[2 * h] = bf16x2_of(col[(2 * t) * kStride], col[(2 * t + 1) * kStride]);
      b[2 * h + 1] = bf16x2_of(col[(2 * t + 8) * kStride], col[(2 * t + 9) * kStride]);
    }
  }
}

// Issue the copies of one chunk: rows [row0, row0 + n_valid) of E values
// of Tile from the K and V arrays into a slot (rows past n_valid are
// zeros), and with kScales the rows' int8 scales.
template <typename Tile, int kRS, bool kScales>
__device__ __forceinline__ void load_chunk(unsigned char* slot, const void* k, const void* v,
                                           const float* ks, const float* vs, size_t row0,
                                           int n_valid, int E, int lane) {
  const int vecs = E * static_cast<int>(sizeof(Tile)) / 16;  // 16-byte vectors a row
  const size_t row_bytes = static_cast<size_t>(E) * sizeof(Tile);
  const unsigned char* kb = static_cast<const unsigned char*>(k) + row0 * row_bytes;
  const unsigned char* vb = static_cast<const unsigned char*>(v) + row0 * row_bytes;
  for (int i = lane; i < kChunk * vecs; i += 32) {
    const int r = i / vecs, c = (i % vecs) * 16;
    const bool ok = r < n_valid;
    const size_t off = ok ? r * row_bytes + c : 0;
    cp_async16(slot + r * kRS + c, kb + off, ok);
    cp_async16(slot + (kChunk + r) * kRS + c, vb + off, ok);
  }
  if constexpr (kScales) {
    const int r = lane & (kChunk - 1);
    const float* src = (lane < kChunk ? ks : vs) + row0;
    cp_async4(slot + 2 * kChunk * kRS + lane * 4, src + (r < n_valid ? r : 0), r < n_valid);
  }
}

// One chunk's online-softmax step of this warp's kM row tiles: the keys
// at positions p0 .. p0 + 15 (those < end, within each row's [lo, hi])
// of the tiles in `slot`. kScaled: an int8 tile, with its K and V scales.
template <int Ep, int kM, int kRS, typename Tile, bool kScaled, bool kSoftcap>
__device__ __forceinline__ void attend_chunk(const unsigned char* slot, const unsigned char* qs,
                                             int E, int p0, int end, const int (&lo)[kM][2],
                                             const int (&hi)[kM][2], float scale, float softcap,
                                             float inv_cap, float (&m)[kM][2], float (&l)[kM][2],
                                             float (&acc)[kM][Ep / 8][4]) {
  constexpr int kQRow = Ep * 2 + 16;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const unsigned char* kt = slot;
  const unsigned char* vt = slot + kChunk * kRS;
  const float* ksc = reinterpret_cast<const float*>(slot + 2 * kChunk * kRS);

  float s[kM][2][4];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt)
#pragma unroll
    for (int n = 0; n < 2; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < Ep / 16; ++kk) {
    if (kk * 16 < E) {
      uint32_t kb[4];
      k_frags<Tile, kRS>(kt, kk, lane, kb);
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, qs + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kQRow +
                       (kk * 16 + (lane >> 4) * 8) * 2);
        nnop::mma_bf16_16816(s[mt][0], a, kb);
        nnop::mma_bf16_16816(s[mt][1], a, kb + 2);
      }
    }
  }

  // element (n, e) of a row tile: row g + 8 * (e >> 1), key n * 8 + 2t + (e & 1)
  float ksv[4], vsv[4];
  if constexpr (kScaled) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = (i >> 1) * 8 + 2 * t + (i & 1);
      ksv[i] = ksc[key];
      vsv[i] = ksc[kChunk + key];
    }
  }
  uint32_t pa[kM][4];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
    float mx[2] = {nnop::kMaskValue, nnop::kMaskValue};
    uint32_t vis = 0;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, pos = p0 + n * 8 + 2 * t + (e & 1);
        float x = s[mt][n][e] * scale;
        if constexpr (kScaled) x *= ksv[n * 2 + (e & 1)];
        if constexpr (kSoftcap) x = softcap * tanhf(x * inv_cap);
        const bool v = pos < end && pos >= lo[mt][h] && pos <= hi[mt][h];
        vis |= static_cast<uint32_t>(v) << (n * 4 + e);
        s[mt][n][e] = x;
        if (v) mx[h] = fmaxf(mx[h], x);
      }
    }
    float sum[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[mt][h], mx[h]);
      alpha[h] = __expf(m[mt][h] - m_new);
      m[mt][h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = (vis >> (n * 4 + e)) & 1u ? __expf(s[mt][n][e] - m[mt][h]) : 0.f;
        sum[h] += p;
        // int8: the V scale folds into P after the sum
        s[mt][n][e] = kScaled ? p * vsv[n * 2 + (e & 1)] : p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[mt][h] = l[mt][h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int nt = 0; nt < Ep / 8; ++nt) {
      acc[mt][nt][0] *= alpha[0];
      acc[mt][nt][1] *= alpha[0];
      acc[mt][nt][2] *= alpha[1];
      acc[mt][nt][3] *= alpha[1];
    }
    // P (rounded to bf16): the score fragments of the two key tiles are
    // the A fragment of the chunk's one 16-key k-step
    pa[mt][0] = nnop::pack_bf16x2(s[mt][0][0], s[mt][0][1]);
    pa[mt][1] = nnop::pack_bf16x2(s[mt][0][2], s[mt][0][3]);
    pa[mt][2] = nnop::pack_bf16x2(s[mt][1][0], s[mt][1][1]);
    pa[mt][3] = nnop::pack_bf16x2(s[mt][1][2], s[mt][1][3]);
  }
#pragma unroll
  for (int np = 0; np < Ep / 16; ++np) {
    if (np * 16 < E) {
      uint32_t vb[4];
      v_frags<Tile, kRS>(vt, np, lane, vb);
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) {
        nnop::mma_bf16_16816(acc[mt][2 * np], pa[mt], vb);
        nnop::mma_bf16_16816(acc[mt][2 * np + 1], pa[mt], vb + 2);
      }
    }
  }
}

// o[row r][e .. e + 3] of a block, in q's type (x / l, or zeros where l
// is 0): row r is draft t0 + r / G of head kh * G + r % G.
__device__ __forceinline__ void store_o4(const Params& p, int b, int kh, int G, int t0, int r,
                                         int e, float4 x, float l) {
  const float inv = l == 0.f ? 0.f : 1.f / l;
  x = make_float4(x.x * inv, x.y * inv, x.z * inv, x.w * inv);
  const size_t i =
      ((static_cast<size_t>(b) * p.QH + kh * G + r % G) * p.n_draft + t0 + r / G) * p.E + e;
  if (p.q_f32)
    *reinterpret_cast<float4*>(static_cast<float*>(p.o) + i) = x;
  else
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.o) + i) =
        make_uint2(nnop::pack_bf16x2(x.x, x.y), nnop::pack_bf16x2(x.z, x.w));
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
  acc.x += w * v.x;
  acc.y += w * v.y;
  acc.z += w * v.z;
  acc.w += w * v.w;
}

// Grid (KH, B, n_split * Z), kThreads threads; block (kh, b, split, z)
// with blockIdx.z = z * n_split + split. KV: the cache's type; kPaged:
// pools and a page table; kSoftcap compiles the softcap in.
template <int Ep, int kM, typename KV, bool kPaged, bool kSoftcap>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Params p) {
  using L = Layout<Ep, kM, KV>;
  constexpr int kRows = L::kRows, kRS = L::kRS, kStages = L::kStages;
  constexpr bool kQ8 = std::is_same<KV, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* big = smem;
  unsigned char* qs = smem + L::kBig;
  float* wm = reinterpret_cast<float*>(qs + L::kQ);  // [kWarps][kRows]: each warp's row max
  float* wl = wm + kWarps * kRows;                    // [kWarps][kRows]: its row sum
  float* rm = wl + kWarps * kRows;                    // [kRows]: the block's row max
  float* rl = rm + kRows;                             // [kRows]: its row sum
  int* last = reinterpret_cast<int*>(rl + kRows);

  const int kh = blockIdx.x, b = blockIdx.y;
  const int split = blockIdx.z % p.n_split, z = blockIdx.z / p.n_split;
  const int Z = gridDim.z / p.n_split, G = p.QH / p.KH, E = p.E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int len = p.lengths[b];
  const int tpz = kRows / G;  // drafts a block holds
  const int t0 = z * tpz;
  const int rows = min(tpz, p.n_draft - t0) * G;

  // the block's q rows, rounded to bf16 (rows past `rows` are zeros)
  for (int i = threadIdx.x; i < kRows * (Ep / 8); i += kThreads) {
    const int r = i / (Ep / 8), c = (i % (Ep / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows && c < E) {
      const size_t off =
          ((static_cast<size_t>(b) * p.QH + kh * G + r % G) * p.n_draft + t0 + r / G) * E + c;
      if (p.q_f32) {
        const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(p.q) + off);
        const float4 x = src[0], y = src[1];
        v = make_uint4(nnop::pack_bf16x2(x.x, x.y), nnop::pack_bf16x2(x.z, x.w),
                       nnop::pack_bf16x2(y.x, y.y), nnop::pack_bf16x2(y.z, y.w));
      } else {
        v = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.q) + off);
      }
    }
    *reinterpret_cast<uint4*>(qs + r * L::kQRow + c * 2) = v;
  }

  // this lane's rows (g and g + 8 of each row tile) see positions [lo, hi]
  int lo[kM][2], hi[kM][2];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      const int qpos = len + p.staged_n - p.n_draft + t0 + r / G;
      const bool live = r < rows && len > 0;
      lo[mt][h] = !live ? (1 << 30) : p.window > 0 ? qpos + 1 - p.window : 0;
      hi[mt][h] = live ? qpos : -1;
    }
  }

  // the split: this block's 64-key tiles of the slot's live cache rows
  // [first, len), first at its first draft's window edge
  // (ops/attention_decode.py:split_tiles), as 16-key chunks [c0, c1)
  const int first =
      p.window > 0 ? max(0, len + p.staged_n - p.n_draft + t0 + 1 - p.window) : 0;
  int c0 = 0, c1 = 0;
  if (first < len) {
    const int t_first = first / kTileKeys, t_end = (len + kTileKeys - 1) / kTileKeys;
    const int per = (t_end - t_first + p.n_split - 1) / p.n_split;
    const int tb = t_first + split * per, te = min(t_end, tb + per);
    if (tb < te) {
      c0 = max(tb * kWarps, first / kChunk);
      c1 = min(te * kWarps, (len + kChunk - 1) / kChunk);
    }
  }
  const int n_cache = c1 - c0;
  const int n_stage = split == p.n_split - 1 && len > 0 && p.k_stage != nullptr
                          ? (p.staged_n + kChunk - 1) / kChunk
                          : 0;
  const int n_items = n_cache + n_stage;
  // this warp's items: list entries warp, warp + kWarps, ...
  const int my_n = n_items > warp ? (n_items - warp + kWarps - 1) / kWarps : 0;

  const size_t cache_base =
      ((static_cast<size_t>(p.layer) * p.n_blocks + b) * p.KH + kh) * static_cast<size_t>(p.S);
  const size_t stage_base =
      ((static_cast<size_t>(b) * p.n_layers + p.layer) * p.KH + kh) * static_cast<size_t>(p.W);
  const int* slot_table = kPaged ? p.table + static_cast<size_t>(b) * p.max_pages : nullptr;
  // the first row (of the cache, or of the staging) of this warp's item j
  auto row_of = [&](int j) -> size_t {
    const int e = warp + kWarps * j;
    if (e >= n_cache) return stage_base + static_cast<size_t>(e - n_cache) * kChunk;
    const int key = (c0 + e) * kChunk;
    if constexpr (kPaged)
      return ((static_cast<size_t>(p.layer) * p.n_blocks + slot_table[key / p.S]) * p.KH + kh) *
                 static_cast<size_t>(p.S) +
             key % p.S;
    else
      return cache_base + key;
  };
  unsigned char* ring = big + warp * kStages * L::kSlot;
  size_t pending = my_n > 0 ? row_of(0) : 0;  // read one item ahead (a page-table entry)
  auto issue = [&](int j) {
    const int e = warp + kWarps * j;
    unsigned char* slot = ring + (j % kStages) * L::kSlot;
    if (e >= n_cache) {
      load_chunk<__nv_bfloat16, kRS, false>(slot, p.k_stage, p.v_stage, nullptr, nullptr,
                                            pending, p.staged_n - (e - n_cache) * kChunk, E, lane);
    } else {
      load_chunk<KV, kRS, kQ8>(slot, p.k_cache, p.v_cache, p.k_scale, p.v_scale, pending,
                               len - (c0 + e) * kChunk, E, lane);
    }
    if (j + 1 < my_n) pending = row_of(j + 1);
  };

  float m[kM][2], l[kM][2], acc[kM][Ep / 8][4];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
    m[mt][0] = m[mt][1] = nnop::kMaskValue;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < Ep / 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  }
  const float inv_cap = kSoftcap ? 1.f / p.softcap : 0.f;
  __syncthreads();  // the q tile

  // the walk: a ring of kStages chunks in flight per warp
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < my_n) issue(j);
    cp_async_commit();
  }
  for (int j = 0; j < my_n; ++j) {
    if (j + kStages - 1 < my_n) issue(j + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* slot = ring + (j % kStages) * L::kSlot;
    const int e = warp + kWarps * j;
    if (e >= n_cache) {
      attend_chunk<Ep, kM, kRS, __nv_bfloat16, false, kSoftcap>(
          slot, qs, E, len + (e - n_cache) * kChunk, len + p.staged_n, lo, hi, p.scale,
          p.softcap, inv_cap, m, l, acc);
    } else {
      attend_chunk<Ep, kM, kRS, KV, kQ8, kSoftcap>(slot, qs, E, (c0 + e) * kChunk, len, lo, hi,
                                                  p.scale, p.softcap, inv_cap, m, l, acc);
    }
    __syncwarp();  // the slot is refilled next
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it takes the merge slab

  // the warps' merge: each warp's max, sum and unnormalised o rows
  float* slab = reinterpret_cast<float*>(big);
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (t == 0) {
        wm[warp * kRows + r] = m[mt][h];
        wl[warp * kRows + r] = l[mt][h];
      }
#pragma unroll
      for (int nt = 0; nt < Ep / 8; ++nt) {
        if (nt * 8 < E)
          *reinterpret_cast<float2*>(slab + (warp * kRows + r) * L::kSlabRow + nt * 8 + 2 * t) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kRows) {  // each warp's weight exp(m_w - M), in place of its max
    const int r = threadIdx.x;
    float M = nnop::kMaskValue, sum = 0.f;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * kRows + r]);
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(wm[w * kRows + r] - M);
      wm[w * kRows + r] = f;
      sum += wl[w * kRows + r] * f;
    }
    rm[r] = M;
    rl[r] = sum;
  }
  __syncthreads();
  // the block's o, 4 columns a thread at a time: sum_w f_w o_w[r][e..e+3]
  const int E4 = E / 4;
  auto block_o4 = [&](int r, int e) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      fma4(x, wm[w * kRows + r],
           *reinterpret_cast<const float4*>(slab + (w * kRows + r) * L::kSlabRow + e));
    return x;
  };
  if (p.n_split == 1) {
    for (int i = threadIdx.x; i < rows * E4; i += kThreads) {
      const int r = i / E4, e = (i % E4) * 4;
      store_o4(p, b, kh, G, t0, r, e, block_o4(r, e), rl[r]);
    }
    return;
  }

  // this split's partial (m, l, unnormalised o), then a ticket; the last
  // block of the (slot, KV head, z) merges the partials in split order
  const size_t group = (static_cast<size_t>(b) * p.KH + kh) * Z + z;
  const size_t n_parts = static_cast<size_t>(p.B) * p.KH * Z * p.n_split;
  float* ws_o = p.ws + (group * p.n_split) * kRows * E;  // [n_split][kRows][E]
  float2* ws_ml = reinterpret_cast<float2*>(p.ws + n_parts * kRows * E) +
                  group * p.n_split * kRows;  // [n_split][kRows]: (m, l)
  for (int i = threadIdx.x; i < rows * E4; i += kThreads) {
    const int r = i / E4, e = (i % E4) * 4;
    *reinterpret_cast<float4*>(ws_o + (static_cast<size_t>(split) * kRows + r) * E + e) =
        block_o4(r, e);
  }
  if (static_cast<int>(threadIdx.x) < rows)
    ws_ml[split * kRows + threadIdx.x] = make_float2(rm[threadIdx.x], rl[threadIdx.x]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int ticket = atomicAdd(p.tickets + group, 1);
    *last = ticket == p.n_split - 1;
    if (*last) p.tickets[group] = 0;  // every other split has taken its ticket
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // the splits' (m, l) into shared memory, every load in flight at once;
  // then each row's weights exp(m_s - M) in place of m_s
  float* sm_m = reinterpret_cast<float*>(big);  // [n_split][kRows]
  float* sm_l = sm_m + kMaxSplit * kRows;       // [n_split][kRows]
  for (int i = threadIdx.x; i < p.n_split * kRows; i += kThreads) {
    const float2 ml = __ldcg(ws_ml + i);
    sm_m[i] = ml.x;
    sm_l[i] = ml.y;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < rows) {
    const int r = threadIdx.x;
    float M = nnop::kMaskValue, sum = 0.f;
    for (int s = 0; s < p.n_split; ++s) M = fmaxf(M, sm_m[s * kRows + r]);
    for (int s = 0; s < p.n_split; ++s) {
      const float f = __expf(sm_m[s * kRows + r] - M);
      sm_m[s * kRows + r] = f;
      sum += sm_l[s * kRows + r] * f;
    }
    rl[r] = sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * E4; i += kThreads) {
    const int r = i / E4, e = (i % E4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < p.n_split; ++s)
      fma4(x, sm_m[s * kRows + r],
           __ldcg(reinterpret_cast<const float4*>(ws_o + (static_cast<size_t>(s) * kRows + r) * E +
                                                  e)));
    store_o4(p, b, kh, G, t0, r, e, x, rl[r]);
  }
}

template <int Ep, int kM, typename KV, bool kPaged, bool kSoftcap>
cudaError_t launch_one(const Params& p, int Z) {
  using L = Layout<Ep, kM, KV>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      decode_kernel<Ep, kM, KV, kPaged, kSoftcap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid(p.KH, p.B, p.n_split * Z);
  decode_kernel<Ep, kM, KV, kPaged, kSoftcap><<<grid, kThreads, L::kBytes, p.stream>>>(p);
  return cudaGetLastError();
}

template <int Ep, int kM, typename KV>
cudaError_t launch_kv(const Params& p, int Z) {
  const bool paged = p.table != nullptr;
  if constexpr (kM == 1) {
    if (paged)
      return p.softcap > 0.f ? launch_one<Ep, 1, KV, true, true>(p, Z)
                             : launch_one<Ep, 1, KV, true, false>(p, Z);
  }
  return p.softcap > 0.f ? launch_one<Ep, kM, KV, false, true>(p, Z)
                         : launch_one<Ep, kM, KV, false, false>(p, Z);
}

template <int Ep, typename KV>
cudaError_t launch_m(const Params& p) {
  const int G = p.QH / p.KH;
  const int kM = rows_m(p.n_draft * G, Ep, p.table != nullptr);
  const int tpz = 16 * kM / G;
  const int Z = (p.n_draft + tpz - 1) / tpz;
  const long long groups = static_cast<long long>(p.B) * p.KH * Z;
  if (p.n_split > 1 &&
      (groups * p.n_split * 16 * kM * (p.E + 2) > p.ws_elems || groups > p.n_tickets))
    return cudaErrorInvalidValue;
  if constexpr (Ep <= 128) {
    if (kM == 2) return launch_kv<Ep, 2, KV>(p, Z);
  }
  return launch_kv<Ep, 1, KV>(p, Z);
}

template <int Ep>
cudaError_t launch(const Params& p) {
  switch (p.kv_kind) {
    case 0: return launch_m<Ep, __nv_bfloat16>(p);
    case 1: return launch_m<Ep, float>(p);
    case 2: return launch_m<Ep, int8_t>(p);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace nnop_decode
