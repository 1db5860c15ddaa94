// Flash-attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel on bf16 tensor cores (mma.sync m16n8k16, fp32 accumulation).
// This header holds the kernels and their launchers; flash_bwd.cu holds
// the two C entries, and flash_bwd_e{64,128,256}.cu instantiate the
// launchers of one head dim each, so that nvcc builds the three sets in
// parallel.
//
// Replaces nnop_tpu/ops/flash_attention_bwd.py:flash_attention_bwd and the
// TPU kernels it dispatches to (_bwd_causal_multicall, _bwd_rect_static,
// _bwd_causal_chunked and the general dQ / dK/dV grids): one pair of
// kernels serves causal and non-causal attention, GQA, the key-padding
// mask, the pair bias (with its gradient dpair), segment ids, the sliding
// window and the score softcap, any length, E = 64, 128 or 256.
//
// Math (per query head; s recomputed exactly as kernel C computes it:
// the fp32 product of bf16 q and k, times scale, then with a softcap c
// t = tanh(s / c) and s = c * t (csrc/flash_fwd.cu's expression, so P
// sums to 1 against C's lse), plus the pair bias in f32):
//   delta = rowsum(dO * O)                 (fused into the dQ kernel)
//   P  = exp(s - lse),  dP = dO V^T,  dS = P * (dP - delta) * (1 - t^2)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
//   dpair = dS (before the scale; nnop_tpu/ops/flash_attention_bwd.py
//           :218-220), in the pair's dtype
// (the factor 1 - t^2 only with the softcap, which takes no pair). The
// window, the softcap and the extra score terms (kExtra: the pair bias
// and segment ids, pointers nullable inside it) are template flags, so a
// call without them runs no test for them: every combination is an
// instantiation (8 a kernel and head dim). With a pair, the dQ kernel
// writes dpair once for each (64-row query tile, key tile) it visits,
// every element (masked ones are exact zeros), and zero-fills the tiles
// past the causal diagonal and before the window that it does not visit:
// every element of dpair is written by the kernel, none left to a
// memset. A null dpair (the pair needs no gradient) skips those stores.
// Both kernels read the pair straight from device memory at each visible
// score (the dK/dV kernel at transposed positions); with a bf16 pair and
// an even KL the dQ kernel reads the pair and writes dpair two columns an
// access, and its zero fill 16 bytes a store where the rows allow. Segment
// ids mask scores but skip no tile yet.
// P and dS are rounded to bf16 as the A operand of their products; masked
// entries are exact zeros (a row with no visible key, lse = kMaskValue,
// gets zero gradients, never NaN); rows and keys past the ends load as
// zeros and are masked, so no garbage reaches an mma.
//
// Bound on the H100: tensor-core throughput. The five products (S, dP,
// dQ; S^T, dP^T, dV, dK recompute S and dP once more, which is not counted
// as work) are 2 * E flops per visible (row, key) pair each against ~(4
// QL + 4 KL) * E * 2 bytes per head. The design follows kernel C: 64-row
// tiles, the score tiles and the softmax recompute in registers, tiles
// above the causal diagonal or wholly outside the window never loaded.
// - dQ: one block per (b, q head, 64-row query tile); it walks the key
//   tiles from its first row's window edge (with a window) up to the
//   diagonal, K and V tiles in shared memory, the dQ accumulator in
//   registers. Q and dO fragments stay in registers at E <= 128; at E 256
//   the accumulator alone is 128 registers a thread, so Q and dO move to
//   shared memory (loaded per 16-deep step) and key tiles are 32 rows (Q,
//   dO 64 x 264 and K, V 32 x 264 bf16: 99 KB of dynamic shared memory),
//   as kernel C does at E 256. It also writes delta (B, QH, QL) f32, which
//   the dK/dV kernel reads, so the dQ kernel runs first.
// - dK/dV: one block per (b, KV head, 64-key tile); it walks every query
//   tile from the diagonal to the last one whose first row the window
//   still lets see the tile's last key, for each of the GQA group's query
//   heads, and accumulates dK and dV on chip: no atomics, so the result is
//   deterministic (the design of the TPU grid (B, KH, num_kv, group,
//   num_q)). Its two 64 x E fp32 accumulators take 128 registers a thread
//   at E = 128, so K, V, Q and dO all stay in shared memory (dynamic, 68 KB
//   at E = 128) and the score tiles are computed 32 queries at a time. At
//   E 256 the accumulators would take 256 registers, so each block owns
//   128 of the 256 columns of dK and dV (a third grid dimension of 2): it
//   computes S^T and dP^T over the whole head dim, as the other half's
//   block does (1.5x the tensor work of one block owning every column),
//   and keeps the accumulators at 128 registers; its query tiles are 32
//   rows (K, V 64 x 264 and Q, dO 32 x 264 bf16: 99 KB).
// Both grids put the tile index in blockIdx.y and hand out the longest
// causal walks first. The simple form: synchronous tile loads, mma.sync;
// wgmma, TMA and a pipelined ring are later work.
#pragma once

#include "common.cuh"

namespace nnop_bwd {

constexpr int kBQ = 64;   // dQ: query rows per block
constexpr int kBKV = 64;  // dK/dV: keys per block
constexpr int kSub = 32;  // score columns computed at once (registers)
constexpr int kThreads = 128;

// What both entries take (null where absent; window 0 and softcap 0 are
// off).
struct Params {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  const uint8_t* kpad;
  const void* pair;
  const int *qseg, *kseg;
  __nv_bfloat16 *dq, *dk, *dv;
  void* dpair;
  int B, QH, KH, QL, KL, pair_f32, causal, window;
  float scale, softcap;
  cudaStream_t stream;
};

// The launchers of one head dim, instantiated in flash_bwd_e<E>.cu.
template <int E>
cudaError_t launch_dq(const Params& p);
template <int E>
cudaError_t launch_dkv(const Params& p);

// Copy kRows x E bf16 rows from src (row stride E) into a padded shared
// tile (row stride kRow); rows past n_valid are zeros.
template <int E, int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int n_valid) {
  constexpr int kRow = E + 8, kVecs = E / 8;
  for (int i = threadIdx.x; i < kRows * kVecs; i += kThreads) {
    const int r = i / kVecs, cv = (i % kVecs) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_valid) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * E + cv);
    *reinterpret_cast<uint4*>(dst + r * kRow + cv) = val;
  }
}

// A fragment (16 rows x 16 deep, row-major) from a padded shared tile.
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* base, int kRow, int row,
                                       int col) {
  const __nv_bfloat16* p = base + row * kRow + col;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 8);
}

// B fragment of X^T for a product against rows of X: B[k][n] = X[n][k]
// (n = tile row n0 + g, k = the 16 deep columns from col).
__device__ __forceinline__ void frag_bt(uint32_t* b, const __nv_bfloat16* base, int kRow, int n,
                                        int col) {
  const __nv_bfloat16* p = base + n * kRow + col;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment of X itself: B[k][n] = X[k][n] (k = 16 tile rows from r0,
// n = column c), two 16-bit loads per register.
__device__ __forceinline__ void frag_b(uint32_t* b, const __nv_bfloat16* base, int kRow, int r0,
                                       int c) {
  const uint16_t* p = reinterpret_cast<const uint16_t*>(base) + r0 * kRow + c;
  b[0] = nnop::pack_u16x2(p[0], p[kRow]);
  b[1] = nnop::pack_u16x2(p[8 * kRow], p[9 * kRow]);
}

template <int E>
struct DqShape {
  static constexpr bool kQSmem = E > 128;        // Q and dO in shared memory, not registers
  static constexpr int kBK = E > 128 ? 32 : 64;  // keys per shared-memory tile
  static constexpr int kRow = E + 8;             // padded shared-memory row, in elements
};

// The dQ block's K and V tiles (and at E 256 its Q and dO rows).
template <int E>
struct alignas(16) DqTiles {
  using S = DqShape<E>;
  __nv_bfloat16 buf[((S::kQSmem ? 2 * kBQ : 0) + 2 * S::kBK) * S::kRow];
};

// kWindow / kSoftcap / kExtra: compiled in only where asked for; inv_cap
// = 1 / softcap comes from the host.
template <int E, bool kWindow, bool kSoftcap, bool kExtra>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                    const uint8_t* __restrict__ kpad, const void* __restrict__ pair,
                    const int* __restrict__ qseg, const int* __restrict__ kseg,
                    __nv_bfloat16* __restrict__ dq, void* __restrict__ dpair,
                    float* __restrict__ delta, int QH, int KH, int QL, int KL, int pair_f32,
                    float scale, int causal, int window, float softcap, float inv_cap) {
  using Shape = DqShape<E>;
  constexpr int kBK = Shape::kBK, kRow = Shape::kRow;
  constexpr bool kQSmem = Shape::kQSmem;
  constexpr int kSteps = E / 16, kOTiles = E / 8;
  __nv_bfloat16* k_s = nnop::block_smem<DqTiles<E>>().buf;
  __nv_bfloat16* v_s = k_s + kBK * kRow;
  __nv_bfloat16* q_s = v_s + kBK * kRow;  // kQSmem only
  __nv_bfloat16* d_s = q_s + kBQ * kRow;  // kQSmem only
  __shared__ int kseg_s[kExtra ? kBK : 1];  // the key tile's segment ids (kExtra)

  const int n_q = (QL + kBQ - 1) / kBQ;
  const int iq = causal ? n_q - 1 - blockIdx.y : blockIdx.y;  // longest walks first
  const int bh = blockIdx.x, b = bh / QH, h = bh % QH;
  const int kh = h / (QH / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = iq * kBQ + warp * 16 + g, r_hi = r_lo + 8;

  const size_t qoff = (size_t)bh * QL * E;
  const __nv_bfloat16* kb = k + (size_t)(b * KH + kh) * KL * E;
  const __nv_bfloat16* vb = v + (size_t)(b * KH + kh) * KL * E;
  const uint8_t* kp = kpad ? kpad + (size_t)b * KL : nullptr;
  // kExtra: this head's pair (and dpair) rows, the keys' segment ids
  // (staged per key tile in kseg_s) and the two rows' own
  const size_t pair_off = (size_t)bh * QL * KL;
  const bool pair_vec = kExtra && !pair_f32 && KL % 2 == 0;  // bf16x2 loads and stores
  const int* ks = kExtra && kseg != nullptr ? kseg + (size_t)b * KL : nullptr;
  int qs_lo = 0, qs_hi = 0;
  if constexpr (kExtra) {
    if (ks != nullptr) {
      if (r_lo < QL) qs_lo = qseg[(size_t)b * QL + r_lo];
      if (r_hi < QL) qs_hi = qseg[(size_t)b * QL + r_hi];
    }
  }

  // Q and dO: fragments in registers (E <= 128) or the block's rows in
  // shared memory (E 256); rows past QL are zeros. delta from dO and O at
  // the fragments' positions, summed over the quad of lanes.
  auto ld = [&](const __nv_bfloat16* base, int r, int c) -> uint32_t {
    return r < QL ? *reinterpret_cast<const uint32_t*>(base + qoff + (size_t)r * E + c) : 0u;
  };
  auto dot2 = [](uint32_t x, uint32_t y) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&y);
    return __low2float(a) * __low2float(c) + __high2float(a) * __high2float(c);
  };
  uint32_t qf[kQSmem ? 1 : kSteps][4], df[kQSmem ? 1 : kSteps][4];
  float dl_lo = 0.f, dl_hi = 0.f;
  if constexpr (kQSmem) {
    load_tile<E, kBQ>(q_s, q + qoff, iq * kBQ, QL);
    load_tile<E, kBQ>(d_s, dout + qoff, iq * kBQ, QL);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int c = s * 16 + 2 * t;
      dl_lo += dot2(ld(dout, r_lo, c), ld(o, r_lo, c)) +
               dot2(ld(dout, r_lo, c + 8), ld(o, r_lo, c + 8));
      dl_hi += dot2(ld(dout, r_hi, c), ld(o, r_hi, c)) +
               dot2(ld(dout, r_hi, c + 8), ld(o, r_hi, c + 8));
    }
  } else {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int c = s * 16 + 2 * t;
      qf[s][0] = ld(q, r_lo, c);
      qf[s][1] = ld(q, r_hi, c);
      qf[s][2] = ld(q, r_lo, c + 8);
      qf[s][3] = ld(q, r_hi, c + 8);
      df[s][0] = ld(dout, r_lo, c);
      df[s][1] = ld(dout, r_hi, c);
      df[s][2] = ld(dout, r_lo, c + 8);
      df[s][3] = ld(dout, r_hi, c + 8);
      dl_lo += dot2(df[s][0], ld(o, r_lo, c)) + dot2(df[s][2], ld(o, r_lo, c + 8));
      dl_hi += dot2(df[s][1], ld(o, r_hi, c)) + dot2(df[s][3], ld(o, r_hi, c + 8));
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, off);
    dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, off);
  }
  const float* lb = lse + (size_t)bh * QL;
  const float ls_lo = r_lo < QL ? lb[r_lo] : 0.f, ls_hi = r_hi < QL ? lb[r_hi] : 0.f;
  if (t == 0) {
    float* db = delta + (size_t)bh * QL;
    if (r_lo < QL) db[r_lo] = dl_lo;
    if (r_hi < QL) db[r_hi] = dl_hi;
  }

  auto visible = [&](int row, int col) -> bool {
    // (the window comes with causal only; this form of the test keeps the
    // featureless dQ as fast as before the window: 2.80 against 2.92 ms)
    return row < QL && col < KL && (kp == nullptr || kp[col] != 0) && (!causal || col <= row) &&
           (!kWindow || row - col < window) &&
           (!kExtra || ks == nullptr || kseg_s[col % kBK] == (row == r_lo ? qs_lo : qs_hi));
  };

  int n_tiles = (KL + kBK - 1) / kBK, j_first = 0;
  if (causal) {  // tiles entirely above the block's last row are never loaded
    n_tiles = min(n_tiles, min(iq * kBQ + kBQ - 1, QL - 1) / kBK + 1);
    if constexpr (kWindow)  // nor tiles entirely before its first row's window
      j_first = max(0, iq * kBQ + 1 - window) / kBK;
  }

  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = j_first; j < n_tiles; ++j) {
    const int c0 = j * kBK;
    __syncthreads();  // every warp is done with the previous tile (and Q, dO have landed)
    load_tile<E, kBK>(k_s, kb, c0, KL);
    load_tile<E, kBK>(v_s, vb, c0, KL);
    if constexpr (kExtra) {
      if (ks != nullptr && threadIdx.x < kBK)
        kseg_s[threadIdx.x] = c0 + threadIdx.x < KL ? ks[c0 + threadIdx.x] : 0;
    }
    __syncthreads();

#pragma unroll
    for (int sub = 0; sub < kBK / kSub; ++sub) {
      constexpr int kN = kSub / 8;
      // S = Q K^T and dP = dO V^T for this warp's 16 rows x 32 keys
      float s[kN][4], dp[kN][4];
#pragma unroll
      for (int n = 0; n < kN; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        uint32_t qs4[4], ds4[4];  // kQSmem: this step's Q and dO fragments
        if constexpr (kQSmem) {
          frag_a(qs4, q_s, kRow, warp * 16 + g, st * 16 + 2 * t);
          frag_a(ds4, d_s, kRow, warp * 16 + g, st * 16 + 2 * t);
        }
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          uint32_t bf[2];
          frag_bt(bf, k_s, kRow, sub * kSub + n * 8 + g, st * 16 + 2 * t);
          nnop::mma_bf16_16816(s[n], kQSmem ? qs4 : qf[st], bf);
          frag_bt(bf, v_s, kRow, sub * kSub + n * 8 + g, st * 16 + 2 * t);
          nnop::mma_bf16_16816(dp[n], kQSmem ? ds4 : df[st], bf);
        }
      }
      // P = exp(s - lse) and dS = P (dP - delta) (1 - t^2), masked entries
      // exact zeros
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        uint32_t pv[2] = {0u, 0u};  // kExtra, pair_vec: two columns of each row a load
        if constexpr (kExtra) {
          const int col = c0 + sub * kSub + n * 8 + 2 * t;  // even: col + 1 < KL too
          const auto* pb = static_cast<const __nv_bfloat16*>(pair) + pair_off;
          if (pair != nullptr && pair_vec && col < KL) {
            if (r_lo < QL) pv[0] = *reinterpret_cast<const uint32_t*>(pb + (size_t)r_lo * KL + col);
            if (r_hi < QL) pv[1] = *reinterpret_cast<const uint32_t*>(pb + (size_t)r_hi * KL + col);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          const int col = c0 + sub * kSub + n * 8 + 2 * t + (e & 1);
          const bool vis = visible(lo ? r_lo : r_hi, col);
          float sv = s[n][e] * scale, dcap = 1.f;  // dcap: the softcap's factor 1 - t^2
          if constexpr (kSoftcap) {
            const float tc = tanhf(sv * inv_cap);
            sv = softcap * tc;
            dcap = 1.f - tc * tc;
          }
          if constexpr (kExtra) {
            const size_t at = pair_off + (size_t)(lo ? r_lo : r_hi) * KL + col;
            if (pair != nullptr && vis)
              sv += pair_vec ? nnop::bf16x2_half(pv[e >> 1], e & 1)
                             : nnop::load_bf16_or_f32(pair, pair_f32, at);
          }
          const float p = vis ? __expf(sv - (lo ? ls_lo : ls_hi)) : 0.f;
          s[n][e] = vis ? p * (dp[n][e] - (lo ? dl_lo : dl_hi)) * dcap : 0.f;
          if constexpr (kExtra) {  // dpair = dS, masked entries 0
            const int row = lo ? r_lo : r_hi;
            if (dpair != nullptr && !pair_vec && row < QL && col < KL)
              nnop::store_bf16_or_f32(dpair, pair_f32, pair_off + (size_t)row * KL + col,
                                      s[n][e]);
          }
        }
        if constexpr (kExtra) {  // the same, two columns a store
          const int col = c0 + sub * kSub + n * 8 + 2 * t;  // even: col + 1 < KL too
          auto* db = static_cast<__nv_bfloat16*>(dpair) + pair_off;
          if (dpair != nullptr && pair_vec && col < KL) {
            if (r_lo < QL)
              *reinterpret_cast<uint32_t*>(db + (size_t)r_lo * KL + col) =
                  nnop::pack_bf16x2(s[n][0], s[n][1]);
            if (r_hi < QL)
              *reinterpret_cast<uint32_t*>(db + (size_t)r_hi * KL + col) =
                  nnop::pack_bf16x2(s[n][2], s[n][3]);
          }
        }
      }
      // dQ += dS K: two adjacent 8-key accumulators are one A fragment
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        const uint32_t da[4] = {
            nnop::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
            nnop::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
            nnop::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            nnop::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
#pragma unroll
        for (int n = 0; n < kOTiles; ++n) {
          uint32_t bf[2];
          frag_b(bf, k_s, kRow, sub * kSub + kk * 16 + 2 * t, n * 8 + g);
          nnop::mma_bf16_16816(acc[n], da, bf);
        }
      }
    }
  }

  if constexpr (kExtra) {  // dpair of the tiles the walk skipped: zeros
    const int r0 = iq * kBQ, nr = min(kBQ, QL - r0), elem = pair_f32 ? 4 : 2;
    // columns [c_from, c_to) of the block's rows
    auto zero_cols = [&](int c_from, int c_to) {
      const int nc = c_to - c_from;
      if (dpair == nullptr || nc <= 0) return;
      if (c_from * elem % 16 == 0 && c_to * elem % 16 == 0 && KL * elem % 16 == 0) {
        const int vecs = nc * elem / 16;  // 16-byte stores per row
        for (int i = threadIdx.x; i < nr * vecs; i += kThreads)
          reinterpret_cast<uint4*>(static_cast<char*>(dpair) +
                                   (pair_off + (size_t)(r0 + i / vecs) * KL + c_from) * elem)
              [i % vecs] = make_uint4(0, 0, 0, 0);
      } else {
        for (int i = threadIdx.x; i < nr * nc; i += kThreads)
          nnop::store_bf16_or_f32(dpair, pair_f32,
                                  pair_off + (size_t)(r0 + i / nc) * KL + c_from + i % nc, 0.f);
      }
    };
    zero_cols(0, min(j_first * kBK, KL));  // before the window
    zero_cols(n_tiles * kBK, KL);          // past the causal diagonal
  }

  __nv_bfloat16* qb = dq + qoff;
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
    const int col = n * 8 + 2 * t;
    if (r_lo < QL)
      *reinterpret_cast<uint32_t*>(qb + (size_t)r_lo * E + col) =
          nnop::pack_bf16x2(acc[n][0] * scale, acc[n][1] * scale);
    if (r_hi < QL)
      *reinterpret_cast<uint32_t*>(qb + (size_t)r_hi * E + col) =
          nnop::pack_bf16x2(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int E>
struct DkvShape {
  static constexpr int kCols = E > 128 ? 128 : E;  // dK/dV columns a block accumulates
  static constexpr int kBQ = E > 128 ? 32 : 64;    // query rows per shared-memory tile
  static constexpr int kRow = E + 8;
};

// K, V (64 keys), Q and dO tiles, lse and delta rows (and with kExtra the
// Q tile's segment ids)
template <int E, bool kExtra>
constexpr int dkv_smem_bytes() {
  using S = DkvShape<E>;
  return (2 * kBKV + 2 * S::kBQ) * S::kRow * 2 + (kExtra ? 3 : 2) * S::kBQ * 4;
}

template <int E, bool kWindow, bool kSoftcap, bool kExtra>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const uint8_t* __restrict__ kpad, const void* __restrict__ pair,
                     const int* __restrict__ qseg, const int* __restrict__ kseg,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int QH,
                     int KH, int QL, int KL, int pair_f32, float scale, int causal, int window,
                     float softcap, float inv_cap) {
  using Shape = DkvShape<E>;
  constexpr int kQT = Shape::kBQ, kRow = Shape::kRow, kCols = Shape::kCols;
  constexpr int kSteps = E / 16, kOTiles = kCols / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + kBKV * kRow;
  __nv_bfloat16* q_s = v_s + kBKV * kRow;
  __nv_bfloat16* d_s = q_s + kQT * kRow;
  float* lse_s = reinterpret_cast<float*>(d_s + kQT * kRow);
  float* dl_s = lse_s + kQT;
  int* qs_s = reinterpret_cast<int*>(dl_s + kQT);  // kExtra with segment ids only

  const int j = blockIdx.y;  // key tile: the longest causal walk (j = 0) first
  const int bkh = blockIdx.x, b = bkh / KH, kh = bkh % KH;
  const int col0 = kCols == E ? 0 : blockIdx.z * kCols;  // the block's columns of dK and dV
  const int group = QH / KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = j * kBKV;
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;  // the two keys this thread holds
  const uint8_t* kp = kpad ? kpad + (size_t)b * KL : nullptr;
  const bool ok_lo = key_lo < KL && (kp == nullptr || kp[key_lo] != 0);
  const bool ok_hi = key_hi < KL && (kp == nullptr || kp[key_hi] != 0);
  const bool has_seg = kExtra && kseg != nullptr;
  const int ks_lo = has_seg && key_lo < KL ? kseg[(size_t)b * KL + key_lo] : 0;
  const int ks_hi = has_seg && key_hi < KL ? kseg[(size_t)b * KL + key_hi] : 0;

  load_tile<E, kBKV>(k_s, k + (size_t)bkh * KL * E, k0, KL);
  load_tile<E, kBKV>(v_s, v + (size_t)bkh * KL * E, k0, KL);

  float dka[kOTiles][4], dva[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n)
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = dva[n][0] = dva[n][1] = dva[n][2] =
        dva[n][3] = 0.f;

  int i0 = 0, i_end = (QL + kQT - 1) / kQT;
  if (causal) {
    i0 = k0 / kQT;  // the first query tile that sees key k0
    if constexpr (kWindow)  // past the last one whose first row sees the tile's last key
      i_end = min(i_end, (k0 + kBKV - 1 + window - 1) / kQT + 1);
  }
  for (int gh = 0; gh < group; ++gh) {
    const int bh = b * QH + kh * group + gh;
    const __nv_bfloat16* qb = q + (size_t)bh * QL * E;
    const __nv_bfloat16* db = dout + (size_t)bh * QL * E;
    const float* lb = lse + (size_t)bh * QL;
    const float* deb = delta + (size_t)bh * QL;
    const size_t pair_off = (size_t)bh * QL * KL;
    for (int i = i0; i < i_end; ++i) {
      const int q0 = i * kQT;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<E, kQT>(q_s, qb, q0, QL);
      load_tile<E, kQT>(d_s, db, q0, QL);
      if (threadIdx.x < kQT) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < QL ? lb[r] : 0.f;
        dl_s[threadIdx.x] = r < QL ? deb[r] : 0.f;
        if constexpr (kExtra)
          if (has_seg) qs_s[threadIdx.x] = r < QL ? qseg[(size_t)b * QL + r] : 0;
      }
      __syncthreads();

#pragma unroll
      for (int sub = 0; sub < kQT / kSub; ++sub) {
        constexpr int kN = kSub / 8;
        // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 queries
        float s[kN][4], dp[kN][4];
#pragma unroll
        for (int n = 0; n < kN; ++n)
          s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          uint32_t ka[4], va[4];
          frag_a(ka, k_s, kRow, warp * 16 + g, st * 16 + 2 * t);
          frag_a(va, v_s, kRow, warp * 16 + g, st * 16 + 2 * t);
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            uint32_t bf[2];
            frag_bt(bf, q_s, kRow, sub * kSub + n * 8 + g, st * 16 + 2 * t);
            nnop::mma_bf16_16816(s[n], ka, bf);
            frag_bt(bf, d_s, kRow, sub * kSub + n * 8 + g, st * 16 + 2 * t);
            nnop::mma_bf16_16816(dp[n], va, bf);
          }
        }
        // P^T and dS^T, masked entries exact zeros
#pragma unroll
        for (int n = 0; n < kN; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool lo = e < 2;
            const int qi = sub * kSub + n * 8 + 2 * t + (e & 1);  // row of the Q tile
            const int key = lo ? key_lo : key_hi;
            const bool vis =
                (lo ? ok_lo : ok_hi) && q0 + qi < QL &&
                (!causal || (key <= q0 + qi && (!kWindow || q0 + qi - key < window))) &&
                (!has_seg || qs_s[qi] == (lo ? ks_lo : ks_hi));
            float sv = s[n][e] * scale, tc = 0.f;
            if constexpr (kSoftcap) {
              tc = tanhf(sv * inv_cap);
              sv = softcap * tc;
            }
            if constexpr (kExtra) {
              if (pair != nullptr && vis)
                sv += nnop::load_bf16_or_f32(pair, pair_f32,
                                             pair_off + (size_t)(q0 + qi) * KL + key);
            }
            const float p = vis ? __expf(sv - lse_s[qi]) : 0.f;
            s[n][e] = p;
            dp[n][e] = vis ? p * (dp[n][e] - dl_s[qi]) : 0.f;
            if constexpr (kSoftcap) dp[n][e] *= 1.f - tc * tc;
          }
        }
        // dV += P^T dO and dK += dS^T Q (the block's columns)
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk) {
          const uint32_t pa[4] = {
              nnop::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
              nnop::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
              nnop::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              nnop::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]),
          };
          const uint32_t da[4] = {
              nnop::pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]),
              nnop::pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]),
              nnop::pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
              nnop::pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]),
          };
#pragma unroll
          for (int n = 0; n < kOTiles; ++n) {
            uint32_t bf[2];
            frag_b(bf, d_s, kRow, sub * kSub + kk * 16 + 2 * t, col0 + n * 8 + g);
            nnop::mma_bf16_16816(dva[n], pa, bf);
            frag_b(bf, q_s, kRow, sub * kSub + kk * 16 + 2 * t, col0 + n * 8 + g);
            nnop::mma_bf16_16816(dka[n], da, bf);
          }
        }
      }
    }
  }

  const size_t koff = (size_t)bkh * KL * E;
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
    const int col = col0 + n * 8 + 2 * t;
    if (key_lo < KL) {
      *reinterpret_cast<uint32_t*>(dk + koff + (size_t)key_lo * E + col) =
          nnop::pack_bf16x2(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + koff + (size_t)key_lo * E + col) =
          nnop::pack_bf16x2(dva[n][0], dva[n][1]);
    }
    if (key_hi < KL) {
      *reinterpret_cast<uint32_t*>(dk + koff + (size_t)key_hi * E + col) =
          nnop::pack_bf16x2(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + koff + (size_t)key_hi * E + col) =
          nnop::pack_bf16x2(dva[n][2], dva[n][3]);
    }
  }
}

template <int E, bool kWindow, bool kSoftcap, bool kExtra>
struct DqLaunch {
  static cudaError_t run(const Params& p) {
    static const cudaError_t opt_in = nnop::opt_in_dynamic_smem<DqTiles<E>>(
        flash_bwd_dq_kernel<E, kWindow, kSoftcap, kExtra>);
    if (opt_in != cudaSuccess) return opt_in;
    const dim3 grid(p.B * p.QH, (p.QL + kBQ - 1) / kBQ);
    flash_bwd_dq_kernel<E, kWindow, kSoftcap, kExtra>
        <<<grid, kThreads, nnop::dynamic_smem_bytes<DqTiles<E>>, p.stream>>>(
        p.q, p.k, p.v, p.o, p.dout, p.lse, p.kpad, p.pair, p.qseg, p.kseg, p.dq, p.dpair,
        p.delta, p.QH, p.KH, p.QL, p.KL, p.pair_f32, p.scale, p.causal, p.window, p.softcap,
        kSoftcap ? 1.f / p.softcap : 0.f);
    return cudaGetLastError();
  }
};

template <int E, bool kWindow, bool kSoftcap, bool kExtra>
struct DkvLaunch {
  static cudaError_t run(const Params& p) {
    constexpr int bytes = dkv_smem_bytes<E, kExtra>();
    const cudaError_t err =
        cudaFuncSetAttribute(flash_bwd_dkv_kernel<E, kWindow, kSoftcap, kExtra>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.B * p.KH, (p.KL + kBKV - 1) / kBKV, E / DkvShape<E>::kCols);
    flash_bwd_dkv_kernel<E, kWindow, kSoftcap, kExtra><<<grid, kThreads, bytes, p.stream>>>(
        p.q, p.k, p.v, p.dout, p.lse, p.delta, p.kpad, p.pair, p.qseg, p.kseg, p.dk, p.dv,
        p.QH, p.KH, p.QL, p.KL, p.pair_f32, p.scale, p.causal, p.window, p.softcap,
        kSoftcap ? 1.f / p.softcap : 0.f);
    return cudaGetLastError();
  }
};

// The instantiation for the flags p asks for (window > 0, softcap > 0,
// the extra terms: a pair or segment ids), chosen one flag at a time.
template <template <int, bool, bool, bool> class Launch, int E, bool... kFlags>
cudaError_t with_flags(const Params& p) {
  constexpr int i = sizeof...(kFlags);
  if constexpr (i == 3) {
    return Launch<E, kFlags...>::run(p);
  } else {
    const bool on = i == 0 ? p.window > 0 : i == 1 ? p.softcap > 0.f
                                                   : p.pair != nullptr || p.qseg != nullptr;
    return on ? with_flags<Launch, E, kFlags..., true>(p)
              : with_flags<Launch, E, kFlags..., false>(p);
  }
}

template <int E>
cudaError_t launch_dq(const Params& p) {
  return with_flags<DqLaunch, E>(p);
}

template <int E>
cudaError_t launch_dkv(const Params& p) {
  return with_flags<DkvLaunch, E>(p);
}

}  // namespace nnop_bwd
