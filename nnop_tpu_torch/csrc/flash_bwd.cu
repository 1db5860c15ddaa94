// Flash-attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel on bf16 tensor cores (mma.sync m16n8k16, fp32 accumulation).
//
// Replaces nnop_tpu/ops/flash_attention_bwd.py:flash_attention_bwd and the
// TPU kernels it dispatches to (_bwd_causal_multicall, _bwd_rect_static,
// _bwd_causal_chunked and the general dQ / dK/dV grids): one pair of
// kernels serves causal and non-causal attention, GQA, the key-padding
// mask and any length, E = 64 or 128.
//
// Math (per query head; s recomputed exactly as kernel C computes it:
// the fp32 product of bf16 q and k, times scale, so P sums to 1 against
// C's lse):
//   delta = rowsum(dO * O)                 (fused into the dQ kernel)
//   P  = exp(s - lse),  dP = dO V^T,  dS = P * (dP - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
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

template <int E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                    const uint8_t* __restrict__ kpad, __nv_bfloat16* __restrict__ dq,
                    float* __restrict__ delta, int QH, int KH, int QL, int KL, float scale,
                    int causal) {
  constexpr int kSteps = E / 16, kOTiles = E / 8, kRow = E + 8;
  __shared__ __align__(16) __nv_bfloat16 k_s[kBK * kRow];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBK * kRow];

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
    return row < QL && col < KL && (kp == nullptr || kp[col] != 0) && (!causal || col <= row);
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
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          const int col = c0 + sub * kSub + n * 8 + 2 * t + (e & 1);
          const bool vis = visible(lo ? r_lo : r_hi, col);
          const float p = vis ? __expf(s[n][e] * scale - (lo ? ls_lo : ls_hi)) : 0.f;
          s[n][e] = vis ? p * (dp[n][e] - (lo ? dl_lo : dl_hi)) : 0.f;
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
constexpr int dkv_smem_bytes() {
  return 4 * 64 * (E + 8) * 2 + 2 * kBQ * 4;
}

template <int E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const uint8_t* __restrict__ kpad, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int QH, int KH, int QL, int KL, float scale,
                     int causal) {
  constexpr int kSteps = E / 16, kOTiles = E / 8, kRow = E + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + kBK * kRow;
  __nv_bfloat16* q_s = v_s + kBK * kRow;
  __nv_bfloat16* d_s = q_s + kBQ * kRow;
  float* lse_s = reinterpret_cast<float*>(d_s + kBQ * kRow);
  float* dl_s = lse_s + kBQ;

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
    for (int i = i0; i < n_q; ++i) {
      const int q0 = i * kBQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<E>(q_s, qb, q0, QL);
      load_tile<E>(d_s, db, q0, QL);
      if (threadIdx.x < kBQ) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < QL ? lb[r] : 0.f;
        dl_s[threadIdx.x] = r < QL ? deb[r] : 0.f;
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
                (lo ? ok_lo : ok_hi) && q0 + qi < QL && (!causal || key <= q0 + qi);
            const float p = vis ? __expf(s[n][e] * scale - lse_s[qi]) : 0.f;
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

template <int E>
cudaError_t launch_dkv(dim3 grid, cudaStream_t st, const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, const __nv_bfloat16* dout, const float* lse,
                       const float* delta, const uint8_t* kpad, __nv_bfloat16* dk,
                       __nv_bfloat16* dv, int QH, int KH, int QL, int KL, float scale,
                       int causal) {
  constexpr int bytes = dkv_smem_bytes<E>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<E><<<grid, kThreads, bytes, st>>>(q, k, v, dout, lse, delta, kpad, dk, dv,
                                                         QH, KH, QL, KL, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B, QH, QL, E); k, v (B, KH, KL, E): bf16, contiguous.
// lse, delta (B, QH, QL) f32 (delta is written); kpad (B, KL) uint8 or
// null. E is 64 or 128.
extern "C" int nnop_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, const void* kpad, void* dq,
                                 void* delta, int B, int QH, int KH, int QL, int KL, int E,
                                 float scale, int causal, void* stream) {
  const dim3 grid(B * QH, (QL + kBQ - 1) / kBQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* op = static_cast<const __nv_bfloat16*>(o);
  const auto* dp = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* pp = static_cast<const uint8_t*>(kpad);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dlp = static_cast<float*>(delta);
  switch (E) {
    case 64:
      flash_bwd_dq_kernel<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, dp, lp, pp, dqp, dlp, QH,
                                                         KH, QL, KL, scale, causal);
      break;
    case 128:
      flash_bwd_dq_kernel<128><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, dp, lp, pp, dqp, dlp,
                                                          QH, KH, QL, KL, scale, causal);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q, dout (B, QH, QL, E); k, v, dk, dv (B, KH, KL, E): bf16, contiguous.
// lse, delta (B, QH, QL) f32 (delta from nnop_flash_bwd_dq); kpad (B, KL)
// uint8 or null. E is 64 or 128.
extern "C" int nnop_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, const void* kpad, void* dk,
                                  void* dv, int B, int QH, int KH, int QL, int KL, int E,
                                  float scale, int causal, void* stream) {
  const dim3 grid(B * KH, (KL + kBK - 1) / kBK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dp = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dlp = static_cast<const float*>(delta);
  const auto* pp = static_cast<const uint8_t*>(kpad);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  cudaError_t err;
  switch (E) {
    case 64:
      err = launch_dkv<64>(grid, st, qp, kp, vp, dp, lp, dlp, pp, dkp, dvp, QH, KH, QL, KL, scale,
                           causal);
      break;
    case 128:
      err = launch_dkv<128>(grid, st, qp, kp, vp, dp, lp, dlp, pp, dkp, dvp, QH, KH, QL, KL,
                            scale, causal);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
