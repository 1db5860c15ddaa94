// Flash-attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel on bf16 tensor cores (mma.sync m16n8k16, fp32 accumulation).
//
// Replaces nnop_tpu/ops/flash_attention_bwd.py:flash_attention_bwd and the
// TPU kernels it dispatches to (_bwd_causal_multicall, _bwd_rect_static,
// _bwd_causal_chunked and the general dQ / dK/dV grids): one pair of
// kernels serves causal and non-causal attention, GQA, the key-padding
// mask, the pair bias (with its gradient dpair) and segment ids, and any
// length, E = 64 or 128.
//
// Math (per query head; s recomputed exactly as kernel C computes it:
// the fp32 product of bf16 q and k, times scale, plus the pair bias in
// f32, so P sums to 1 against C's lse):
//   delta = rowsum(dO * O)                 (fused into the dQ kernel)
//   P  = exp(s - lse),  dP = dO V^T,  dS = P * (dP - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
//   dpair = dS (before the scale; nnop_tpu/ops/flash_attention_bwd.py
//           :218-220), in the pair's dtype
// The pair bias and segment ids are kExtra, a template flag (pointers
// nullable inside it), so the plain paths run no test for them. With a
// pair, the dQ kernel writes dpair once for each (64-row query tile,
// 64-key tile) it visits, every element (masked ones are exact zeros),
// and zero-fills the tiles past the causal diagonal it does not visit:
// every element of dpair is written by the kernel, none left to a
// memset. A null dpair (the pair needs no gradient) skips those stores.
// Both kernels read the pair straight from device memory at each visible
// score (the dK/dV kernel at transposed positions); with a bf16 pair and
// an even KL the dQ kernel reads the pair and writes dpair two columns an
// access, and its zero fill 16 bytes a store where the rows allow. Segment ids mask scores but
// skip no tile yet.
// P and dS are rounded to bf16 as the A operand of their products; masked
// entries are exact zeros (a row with no visible key, lse = kMaskValue,
// gets zero gradients, never NaN); rows and keys past the ends load as
// zeros and are masked, so no garbage reaches an mma.
//
// Bound on the H100: tensor-core throughput. The five products (S, dP,
// dQ; S^T, dP^T, dV, dK recompute S and dP once more, which is not counted
// as work) are 2 * QL * KL * E flops each against ~(4 QL + 4 KL) * E * 2
// bytes per head. The design follows kernel C: 64-row tiles, tiles above
// the causal diagonal never loaded, the score tiles and the softmax
// recompute in registers.
// - dQ: one block per (b, q head, 64-row query tile); it walks the key
//   tiles up to the diagonal, Q and dO fragments in registers, K and V
//   tiles in shared memory, the dQ accumulator in registers. It also
//   writes delta (B, QH, QL) f32, which the dK/dV kernel reads, so the
//   dQ kernel runs first.
// - dK/dV: one block per (b, KV head, 64-key tile); it walks every query
//   tile at or after the diagonal, for each of the GQA group's query
//   heads, and accumulates dK and dV on chip: no atomics, so the result is
//   deterministic (the design of the TPU grid (B, KH, num_kv, group,
//   num_q)). Its two 64 x E fp32 accumulators take 128 registers a thread
//   at E = 128, so K, V, Q and dO all stay in shared memory (dynamic, 68 KB
//   at E = 128) and the score tiles are computed 32 queries at a time.
// Both grids put the tile index last (blockIdx.y) and hand out the longest
// causal walks first. The simple form: synchronous tile loads, mma.sync;
// wgmma, TMA and a pipelined ring are later work.

#include "common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr int kSub = 32;  // score columns computed at once (registers)
constexpr int kThreads = 128;

// Copy `rows` x E bf16 rows from src (row stride E) into a padded shared
// tile (row stride kRow); rows past n_valid are zeros.
template <int E>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int n_valid) {
  constexpr int kRow = E + 8, kVecs = E / 8;
  for (int i = threadIdx.x; i < 64 * kVecs; i += kThreads) {
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

template <int E, bool kExtra>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                    const uint8_t* __restrict__ kpad, const void* __restrict__ pair,
                    const int* __restrict__ qseg, const int* __restrict__ kseg,
                    __nv_bfloat16* __restrict__ dq, void* __restrict__ dpair,
                    float* __restrict__ delta, int QH, int KH, int QL, int KL, int pair_f32,
                    float scale, int causal) {
  constexpr int kSteps = E / 16, kOTiles = E / 8, kRow = E + 8;
  __shared__ __align__(16) __nv_bfloat16 k_s[kBK * kRow];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBK * kRow];
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

  // Q and dO fragments in registers (rows past QL are zeros); delta from
  // dO and O at the same positions, summed over the quad of lanes.
  auto ld = [&](const __nv_bfloat16* base, int r, int c) -> uint32_t {
    return r < QL ? *reinterpret_cast<const uint32_t*>(base + qoff + (size_t)r * E + c) : 0u;
  };
  auto dot2 = [](uint32_t x, uint32_t y) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&y);
    return __low2float(a) * __low2float(c) + __high2float(a) * __high2float(c);
  };
  uint32_t qf[kSteps][4], df[kSteps][4];
  float dl_lo = 0.f, dl_hi = 0.f;
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
    return row < QL && col < KL && (kp == nullptr || kp[col] != 0) && (!causal || col <= row) &&
           (!kExtra || ks == nullptr || kseg_s[col % kBK] == (row == r_lo ? qs_lo : qs_hi));
  };

  int n_tiles = (KL + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, min(iq * kBQ + kBQ - 1, QL - 1) / kBK + 1);

  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int c0 = j * kBK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<E>(k_s, kb, c0, KL);
    load_tile<E>(v_s, vb, c0, KL);
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
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          uint32_t bf[2];
          frag_bt(bf, k_s, kRow, sub * kSub + n * 8 + g, st * 16 + 2 * t);
          nnop::mma_bf16_16816(s[n], qf[st], bf);
          frag_bt(bf, v_s, kRow, sub * kSub + n * 8 + g, st * 16 + 2 * t);
          nnop::mma_bf16_16816(dp[n], df[st], bf);
        }
      }
      // P = exp(s - lse) and dS = P (dP - delta), masked entries exact zeros
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
          float sv = s[n][e] * scale;
          if constexpr (kExtra) {
            const size_t at = pair_off + (size_t)(lo ? r_lo : r_hi) * KL + col;
            if (pair != nullptr && vis)
              sv += pair_vec ? nnop::bf16x2_half(pv[e >> 1], e & 1)
                             : nnop::load_bf16_or_f32(pair, pair_f32, at);
          }
          const float p = vis ? __expf(sv - (lo ? ls_lo : ls_hi)) : 0.f;
          s[n][e] = vis ? p * (dp[n][e] - (lo ? dl_lo : dl_hi)) : 0.f;
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

  if constexpr (kExtra) {  // dpair past the causal diagonal: zeros
    const int c_from = n_tiles * kBK, r0 = iq * kBQ;
    const int nr = min(kBQ, QL - r0), nc = KL - c_from;
    const int elem = pair_f32 ? 4 : 2;
    if (dpair != nullptr && nc > 0 && KL * elem % 16 == 0) {  // 16-byte stores
      const int vecs = nc * elem / 16;  // per row (c_from * elem is a multiple of 16)
      for (int i = threadIdx.x; i < nr * vecs; i += kThreads)
        reinterpret_cast<uint4*>(static_cast<char*>(dpair) +
                                 (pair_off + (size_t)(r0 + i / vecs) * KL + c_from) * elem)
            [i % vecs] = make_uint4(0, 0, 0, 0);
    } else if (dpair != nullptr && nc > 0) {
      for (int i = threadIdx.x; i < nr * nc; i += kThreads)
        nnop::store_bf16_or_f32(dpair, pair_f32,
                                pair_off + (size_t)(r0 + i / nc) * KL + c_from + i % nc, 0.f);
    }
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

// K, V, Q and dO tiles, lse and delta rows (and with kExtra the Q tile's
// segment ids)
template <int E, bool kExtra>
constexpr int dkv_smem_bytes() {
  return 4 * 64 * (E + 8) * 2 + (kExtra ? 3 : 2) * kBQ * 4;
}

template <int E, bool kExtra>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const uint8_t* __restrict__ kpad, const void* __restrict__ pair,
                     const int* __restrict__ qseg, const int* __restrict__ kseg,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int QH,
                     int KH, int QL, int KL, int pair_f32, float scale, int causal) {
  constexpr int kSteps = E / 16, kOTiles = E / 8, kRow = E + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + kBK * kRow;
  __nv_bfloat16* q_s = v_s + kBK * kRow;
  __nv_bfloat16* d_s = q_s + kBQ * kRow;
  float* lse_s = reinterpret_cast<float*>(d_s + kBQ * kRow);
  float* dl_s = lse_s + kBQ;
  int* qs_s = reinterpret_cast<int*>(dl_s + kBQ);  // kExtra with segment ids only

  const int j = blockIdx.y;  // key tile: the longest causal walk (j = 0) first
  const int bkh = blockIdx.x, b = bkh / KH, kh = bkh % KH;
  const int group = QH / KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = j * kBK;
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;  // the two keys this thread holds
  const uint8_t* kp = kpad ? kpad + (size_t)b * KL : nullptr;
  const bool ok_lo = key_lo < KL && (kp == nullptr || kp[key_lo] != 0);
  const bool ok_hi = key_hi < KL && (kp == nullptr || kp[key_hi] != 0);
  const bool has_seg = kExtra && kseg != nullptr;
  const int ks_lo = has_seg && key_lo < KL ? kseg[(size_t)b * KL + key_lo] : 0;
  const int ks_hi = has_seg && key_hi < KL ? kseg[(size_t)b * KL + key_hi] : 0;

  load_tile<E>(k_s, k + (size_t)bkh * KL * E, k0, KL);
  load_tile<E>(v_s, v + (size_t)bkh * KL * E, k0, KL);

  float dka[kOTiles][4], dva[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n)
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = dva[n][0] = dva[n][1] = dva[n][2] =
        dva[n][3] = 0.f;

  const int n_q = (QL + kBQ - 1) / kBQ;
  const int i0 = causal ? k0 / kBQ : 0;  // the first query tile that sees key k0
  for (int gh = 0; gh < group; ++gh) {
    const int bh = b * QH + kh * group + gh;
    const __nv_bfloat16* qb = q + (size_t)bh * QL * E;
    const __nv_bfloat16* db = dout + (size_t)bh * QL * E;
    const float* lb = lse + (size_t)bh * QL;
    const float* deb = delta + (size_t)bh * QL;
    const size_t pair_off = (size_t)bh * QL * KL;
    for (int i = i0; i < n_q; ++i) {
      const int q0 = i * kBQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<E>(q_s, qb, q0, QL);
      load_tile<E>(d_s, db, q0, QL);
      if (threadIdx.x < kBQ) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < QL ? lb[r] : 0.f;
        dl_s[threadIdx.x] = r < QL ? deb[r] : 0.f;
        if constexpr (kExtra)
          if (has_seg) qs_s[threadIdx.x] = r < QL ? qseg[(size_t)b * QL + r] : 0;
      }
      __syncthreads();

#pragma unroll
      for (int sub = 0; sub < kBQ / kSub; ++sub) {
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
                (lo ? ok_lo : ok_hi) && q0 + qi < QL && (!causal || key <= q0 + qi) &&
                (!has_seg || qs_s[qi] == (lo ? ks_lo : ks_hi));
            float sv = s[n][e] * scale;
            if constexpr (kExtra) {
              if (pair != nullptr && vis)
                sv += nnop::load_bf16_or_f32(pair, pair_f32,
                                             pair_off + (size_t)(q0 + qi) * KL + key);
            }
            const float p = vis ? __expf(sv - lse_s[qi]) : 0.f;
            s[n][e] = p;
            dp[n][e] = vis ? p * (dp[n][e] - dl_s[qi]) : 0.f;
          }
        }
        // dV += P^T dO and dK += dS^T Q
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
            frag_b(bf, d_s, kRow, sub * kSub + kk * 16 + 2 * t, n * 8 + g);
            nnop::mma_bf16_16816(dva[n], pa, bf);
            frag_b(bf, q_s, kRow, sub * kSub + kk * 16 + 2 * t, n * 8 + g);
            nnop::mma_bf16_16816(dka[n], da, bf);
          }
        }
      }
    }
  }

  const size_t koff = (size_t)bkh * KL * E;
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
    const int col = n * 8 + 2 * t;
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

template <int E, bool kExtra, typename... Args>
cudaError_t launch_dq(dim3 grid, cudaStream_t st, Args... args) {
  flash_bwd_dq_kernel<E, kExtra><<<grid, kThreads, 0, st>>>(args...);
  return cudaGetLastError();
}

template <int E, bool kExtra, typename... Args>
cudaError_t launch_dkv(dim3 grid, cudaStream_t st, Args... args) {
  constexpr int bytes = dkv_smem_bytes<E, kExtra>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<E, kExtra>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<E, kExtra><<<grid, kThreads, bytes, st>>>(args...);
  return cudaGetLastError();
}

// The instantiation for E (64 or 128) and the extra score terms.
template <template <int, bool> class Launch, typename... Args>
cudaError_t dispatch(int E, bool extra, Args... args) {
  switch (E) {
    case 64: return extra ? Launch<64, true>::run(args...) : Launch<64, false>::run(args...);
    case 128: return extra ? Launch<128, true>::run(args...) : Launch<128, false>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <int E, bool kExtra>
struct DqLaunch {
  template <typename... Args>
  static cudaError_t run(Args... args) { return launch_dq<E, kExtra>(args...); }
};

template <int E, bool kExtra>
struct DkvLaunch {
  template <typename... Args>
  static cudaError_t run(Args... args) { return launch_dkv<E, kExtra>(args...); }
};

}  // namespace

// q, o, dout, dq (B, QH, QL, E); k, v (B, KH, KL, E): bf16, contiguous.
// lse, delta (B, QH, QL) f32 (delta is written); kpad (B, KL) uint8 or
// null; pair (B, QH, QL, KL) f32 (pair_f32) or bf16, or null, and dpair
// of its shape and dtype (written) or null; q_seg (B, QL) and kv_seg
// (B, KL) int32, both or neither. E is 64 or 128.
extern "C" int nnop_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, const void* kpad,
                                 const void* pair, const void* q_seg, const void* kv_seg,
                                 void* dq, void* dpair, void* delta, int B, int QH, int KH,
                                 int QL, int KL, int E, int pair_f32, float scale, int causal,
                                 void* stream) {
  const dim3 grid(B * QH, (QL + kBQ - 1) / kBQ);
  return static_cast<int>(dispatch<DqLaunch>(
      E, pair != nullptr || q_seg != nullptr, grid, static_cast<cudaStream_t>(stream),
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const uint8_t*>(kpad), pair, static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<__nv_bfloat16*>(dq), dpair,
      static_cast<float*>(delta), QH, KH, QL, KL, pair_f32, scale, causal));
}

// q, dout (B, QH, QL, E); k, v, dk, dv (B, KH, KL, E): bf16, contiguous.
// lse, delta (B, QH, QL) f32 (delta from nnop_flash_bwd_dq); kpad (B, KL)
// uint8 or null; pair, q_seg, kv_seg as for nnop_flash_bwd_dq. E is 64
// or 128.
extern "C" int nnop_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, const void* kpad,
                                  const void* pair, const void* q_seg, const void* kv_seg,
                                  void* dk, void* dv, int B, int QH, int KH, int QL, int KL,
                                  int E, int pair_f32, float scale, int causal, void* stream) {
  const dim3 grid(B * KH, (KL + kBK - 1) / kBK);
  return static_cast<int>(dispatch<DkvLaunch>(
      E, pair != nullptr || q_seg != nullptr, grid, static_cast<cudaStream_t>(stream),
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(kpad), pair, static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), QH, KH, QL, KL, pair_f32, scale, causal));
}
