// The quantized and grouped matrix-product kernel for Hopper (sm_90a),
// shared by qmm.cu (kernels F, G, H: one weight matrix) and gmm.cu
// (kernel I: stacked expert weights, one expert per row block).
//
// Design. One templated kernel: a block computes a BM x 128 output tile
// with 4 warps and walks K in steps of 64, through a 4-stage ring of
// shared-memory tiles filled by cp.async (16-byte copies, zero-filled past
// the M and N edges), so several tiles' loads are in flight while the
// tensor cores work on the oldest. A quantized weight tile lands in shared
// memory as raw bytes and is dequantized only when a thread builds its mma
// fragment, in registers: no dequantized weight ever reaches device
// memory, which is the point of the TPU kernels. The weight modes:
//   kI8 / kF8  int8 or fp8-e4m3 bytes -> bf16 (exact), mma.sync m16n8k16
//              bf16 with fp32 accumulation, the per-column scale applied
//              once to the fp32 sum;
//   kI4        packed nibbles times their group scale in f32, rounded to
//              bf16 before the product, as the TPU kernels do;
//   kBF16      bf16 weights as they are (kernel I's bf16 mode);
//   kW8A8      int8 activations, mma.sync m16n8k32 s8.s8.s32: the integer
//              sum is exact, and the epilogue applies the row and column
//              scales in the plain version's order.
// BM is 16 (decode rows) or 64. When the output tiles alone cannot fill
// the card (decode, N = 4096), the caller splits K across blocks: each
// split writes an fp32 partial and `qmm_reduce` sums them in order and
// applies the scale. Shapes whose rows are not 16-byte aligned or whose K
// is not a multiple of 64 take a synchronous path with guarded element
// loads (the same compute). This is the simple form: wgmma and TMA, and a
// transposed weight layout for conflict-free fragment reads, come later.
//
// Grouping (kernel I). Rows come sorted by expert in blocks of block_m
// (nnop_tpu_torch/models/moe.py:sort_tokens_by_expert); BM divides
// block_m, so a row tile lies in one block and reads the weights and
// scales of expert block_groups[m0 / block_m]. A tile whose block holds no
// real row (block_rows) writes zeros and streams no weight: at decode most
// of the padded rows are such tiles.
//
// int4 layout (nnop_tpu/ops/quantization.py:quantize4): inside each pack
// block P of K, packed row r holds row r in its low nibble and row r + P/2
// in its high nibble; a stage covers 32 packed rows, i.e. 32 rows of each
// half, and the matching two 32-column slices of x.
#pragma once

#include <cuda_fp8.h>

#include <type_traits>

#include "common.cuh"

// Internal linkage: each source that includes this instantiates its own
// copies, so no kernel is shared between the objects.
namespace {

enum Mode { kI8 = 0, kF8 = 1, kI4 = 2, kW8A8 = 3, kBF16 = 4 };

constexpr int kThreads = 128;
constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 64;   // K values per stage
constexpr int kStages = 4;

// Stacked expert weights: row tile m0 multiplies by expert
// block_groups[m0 / block_m], whose weights start w_stride bytes and whose
// scales start s_stride floats after the previous expert's. block_groups
// null: one weight matrix. block_rows (null: all rows real) holds the real
// rows of each block, which come first in it.
struct Groups {
  const int* block_groups = nullptr;
  const int* block_rows = nullptr;
  int block_m = 0;
  long long w_stride = 0;
  long long s_stride = 0;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// D += A (16x32 s8) * B (32x8 s8), exact int32 accumulation. Fragments
// (lane = 4 * g + t): a[0] = row g, k 4t..4t+3; a[1] = row g+8; a[2], a[3]
// the same at k + 16; b[0] = k 4t..4t+3 of column g, b[1] at k + 16;
// d as in mma_bf16_16816.
__device__ __forceinline__ void mma_s8_16832(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One weight byte -> float (exact): int8, or fp8 e4m3.
template <int M>
__device__ __forceinline__ float dequant_byte(uint8_t b) {
  if constexpr (M == kF8) {
    __nv_fp8_e4m3 v;
    v.__x = b;
    return static_cast<float>(v);
  } else {
    // 2^23 + (s + 128) as a float, minus 2^23 + 128: the int8 value s
    return __int_as_float(0x4B000000 | (b ^ 0x80u)) - 8388736.f;
  }
}

template <int M, int BM>
struct Cfg {
  static constexpr bool kInt = M == kW8A8;                   // int8 activations
  static constexpr int kXB = kInt ? 1 : 2;                   // bytes per x value
  static constexpr int kXS = kBK * kXB + 16;                 // bytes per shared x row
  static constexpr int kXChunks = kBK * kXB / 16;            // 16-byte chunks per x row
  static constexpr int kWB = M == kBF16 ? 2 : 1;             // bytes per weight value
  static constexpr int kWS = kBN * kWB + 16;                 // bytes per shared weight row
  static constexpr int kWChunks = kBN * kWB / 16;            // 16-byte chunks per weight row
  static constexpr int kWR = M == kI4 ? kBK / 2 : kBK;       // weight rows per stage
  static constexpr int kStageBytes = BM * kXS + kWR * kWS + (M == kI4 ? 2 * kBN * 4 : 0);
  static constexpr int kWM = BM == 16 ? 1 : 2, kWN = 4 / kWM;  // warps along M and N
  static constexpr int kMT = BM / kWM / 16, kNT = kBN / kWN / 8;  // mma tiles per warp
};

// Grid (cdiv(N, 128), cdiv(M, BM), splits). x (M, K) bf16 (int8 for G);
// w (K, N) bytes (int4: (K/2, N) packed, K padded to the pack block; bf16:
// (K, N) bf16), or (E, ...) of them with grp; wscale (N,) f32 (F, G) or
// (K/group, N) f32 (H), or (E, ...) of them; xscale (M,) f32 (G).
// partial != null: write the fp32 sum of this block's K range to
// partial[blockIdx.z] and leave the scale to the reduce kernel.
template <int M, int BM, bool kAligned, typename OutT>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const void* __restrict__ x_, const uint8_t* __restrict__ w,
           const float* __restrict__ wscale, const float* __restrict__ xscale,
           OutT* __restrict__ out, float* __restrict__ partial, int Mrows, int N, int K, int group,
           int pack_block, int tiles_per_split, Groups grp) {
  using C = Cfg<M, BM>;
  using Acc = typename std::conditional<C::kInt, int, float>::type;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* x = static_cast<const uint8_t*>(x_);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int wrow = (warp / C::kWN) * C::kMT * 16, wcol = (warp % C::kWN) * C::kNT * 8;
  const int w_rows = M == kI4 ? K / 2 : K;

  if (grp.block_groups != nullptr) {
    const int b = m0 / grp.block_m;
    if (grp.block_rows != nullptr && grp.block_rows[b] <= m0 % grp.block_m) {
      // no real row in this tile: zeros, and no weight streamed
      for (int i = tid; i < BM * kBN; i += kThreads) {
        const int row = m0 + i / kBN, col = n0 + i % kBN;
        if (row >= Mrows || col >= N) continue;
        const size_t o = (size_t)row * N + col;
        if (partial != nullptr)
          partial[(size_t)blockIdx.z * Mrows * N + o] = 0.f;
        else
          out[o] = nnop::from_float<OutT>(0.f);
      }
      return;
    }
    const int e = grp.block_groups[b];
    w += e * grp.w_stride;
    wscale += e * grp.s_stride;
  }

  // the K positions of stage j: x columns [kx, kx + 64), or for int4 the
  // low-half and high-half slices of its pack block
  auto x_col = [&](int j, int e) {
    if constexpr (M == kI4) {
      const int pr0 = j * (kBK / 2), half = pack_block / 2;
      const int klo = (pr0 / half) * pack_block + pr0 % half;
      return e < kBK / 2 ? klo + e : klo + half + e - kBK / 2;
    } else {
      return j * kBK + e;
    }
  };

  auto load_stage = [&](uint8_t* st, int j) {
    uint8_t* sX = st;
    uint8_t* sW = st + BM * C::kXS;
    float* sS = reinterpret_cast<float*>(sW + C::kWR * C::kWS);
    const int wrow0 = j * C::kWR;
    if constexpr (kAligned) {
      for (int c = tid; c < BM * C::kXChunks; c += kThreads) {
        const int r = c / C::kXChunks, cc = c % C::kXChunks;
        const bool ok = m0 + r < Mrows;
        const int k = x_col(j, cc * (16 / C::kXB));
        cp_async16(sX + r * C::kXS + cc * 16,
                   x + ((size_t)(ok ? m0 + r : 0) * K + k) * C::kXB, ok);
      }
      for (int c = tid; c < C::kWR * C::kWChunks; c += kThreads) {
        const int r = c / C::kWChunks, cc = c % C::kWChunks;
        const int col = n0 + cc * (16 / C::kWB);
        const bool ok = col < N;
        cp_async16(sW + r * C::kWS + cc * 16,
                   w + ((size_t)(wrow0 + r) * N + (ok ? col : 0)) * C::kWB, ok);
      }
      if constexpr (M == kI4) {
        for (int c = tid; c < 2 * (kBN / 4); c += kThreads) {
          const int h = c / (kBN / 4), col = n0 + (c % (kBN / 4)) * 4;
          const bool ok = col < N;
          const int grp_k = x_col(j, h * (kBK / 2)) / group;
          cp_async16(sS + h * kBN + (c % (kBN / 4)) * 4,
                     wscale + (size_t)grp_k * N + (ok ? col : 0), ok);
        }
      }
    } else {
      for (int i = tid; i < BM * kBK; i += kThreads) {
        const int r = i / kBK, e = i % kBK, k = x_col(j, e);
        const bool ok = m0 + r < Mrows && k < K;
        const size_t src = (size_t)(m0 + r) * K + k;
        if constexpr (C::kXB == 2) {
          reinterpret_cast<uint16_t*>(sX + r * C::kXS)[e] =
              ok ? reinterpret_cast<const uint16_t*>(x)[src] : 0;
        } else {
          sX[r * C::kXS + e] = ok ? x[src] : 0;
        }
      }
      for (int i = tid; i < C::kWR * kBN; i += kThreads) {
        const int r = i / kBN, c = i % kBN, row = wrow0 + r, col = n0 + c;
        const bool ok = row < w_rows && col < N;
        const size_t src = (size_t)row * N + col;
        if constexpr (C::kWB == 2) {
          reinterpret_cast<uint16_t*>(sW + r * C::kWS)[c] =
              ok ? reinterpret_cast<const uint16_t*>(w)[src] : 0;
        } else {
          sW[r * C::kWS + c] = ok ? w[src] : 0;
        }
      }
      if constexpr (M == kI4) {
        for (int i = tid; i < 2 * kBN; i += kThreads) {
          const int h = i / kBN, col = n0 + i % kBN;
          const int grp_k = x_col(j, h * (kBK / 2)) / group;
          sS[i] = col < N ? wscale[(size_t)grp_k * N + col] : 0.f;
        }
      }
    }
  };

  Acc acc[C::kMT][C::kNT][4];
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  auto compute_stage = [&](const uint8_t* st) {
    const uint8_t* sX = st;
    const uint8_t* sW = st + BM * C::kXS;
    const float* sS = reinterpret_cast<const float*>(sW + C::kWR * C::kWS);
    // the ldmatrix row address of this lane: matrix lane/8 holds rows
    // +0/+8 (bit 0) and k +0/+8 bf16 or +0/+16 bytes (bit 1)
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_col = (lane >> 4) * 16;  // bytes
    if constexpr (C::kInt) {
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        uint32_t a[C::kMT][4];
#pragma unroll
        for (int mt = 0; mt < C::kMT; ++mt)
          ldmatrix_x4(a[mt], sX + (wrow + mt * 16 + a_row) * C::kXS + kk * 32 + a_col);
#pragma unroll
        for (int nt = 0; nt < C::kNT; ++nt) {
          const uint8_t* col = sW + (kk * 32 + 4 * t) * C::kWS + wcol + nt * 8 + g;
          uint32_t b[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint8_t* c = col + h * 16 * C::kWS;
            b[h] = (uint32_t)c[0] | ((uint32_t)c[C::kWS] << 8) |
                   ((uint32_t)c[2 * C::kWS] << 16) | ((uint32_t)c[3 * C::kWS] << 24);
          }
#pragma unroll
          for (int mt = 0; mt < C::kMT; ++mt) mma_s8_16832(acc[mt][nt], a[mt], b);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[C::kMT][4];
#pragma unroll
        for (int mt = 0; mt < C::kMT; ++mt)
          ldmatrix_x4(a[mt], sX + (wrow + mt * 16 + a_row) * C::kXS + kk * 32 + a_col);
#pragma unroll
        for (int nt = 0; nt < C::kNT; ++nt) {
          const int n = wcol + nt * 8 + g;
          uint32_t b[2];
          if constexpr (M == kI4) {
            // rows 2t, 2t+1, 2t+8, 2t+9 of packed slice kk & 1; nibble kk >> 1
            const uint8_t* col = sW + ((kk & 1) * 16 + 2 * t) * C::kWS + n;
            const float sc = sS[(kk >> 1) * kBN + n];
            auto v = [&](int r) {
              const int byte = static_cast<int8_t>(col[r * C::kWS]);
              const int q = (kk >> 1) ? (byte >> 4) : (static_cast<int>(static_cast<uint32_t>(byte) << 28) >> 28);
              return static_cast<float>(q) * sc;
            };
            b[0] = nnop::pack_bf16x2(v(0), v(1));
            b[1] = nnop::pack_bf16x2(v(8), v(9));
          } else if constexpr (M == kBF16) {
            // rows 2t, 2t+1, 2t+8, 2t+9 of column n, as raw bf16
            constexpr int rs = C::kWS / 2;
            const uint16_t* col =
                reinterpret_cast<const uint16_t*>(sW + (kk * 16 + 2 * t) * C::kWS) + n;
            b[0] = nnop::pack_u16x2(col[0], col[rs]);
            b[1] = nnop::pack_u16x2(col[8 * rs], col[9 * rs]);
          } else {
            const uint8_t* col = sW + (kk * 16 + 2 * t) * C::kWS + n;
            b[0] = nnop::pack_bf16x2(dequant_byte<M>(col[0]), dequant_byte<M>(col[C::kWS]));
            b[1] = nnop::pack_bf16x2(dequant_byte<M>(col[8 * C::kWS]),
                                     dequant_byte<M>(col[9 * C::kWS]));
          }
#pragma unroll
          for (int mt = 0; mt < C::kMT; ++mt) nnop::mma_bf16_16816(acc[mt][nt], a[mt], b);
        }
      }
    }
  };

  const int nk = (K + kBK - 1) / kBK;
  const int j0 = blockIdx.z * tiles_per_split;
  const int n_tiles = min(nk, j0 + tiles_per_split) - j0;
  if constexpr (kAligned) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_tiles) load_stage(smem + s * C::kStageBytes, j0 + s);
      cp_async_commit();
    }
    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage i has landed; stage i - 1 is free for the prefetch
      const int pf = i + kStages - 1;
      if (pf < n_tiles) load_stage(smem + (pf % kStages) * C::kStageBytes, j0 + pf);
      cp_async_commit();
      compute_stage(smem + (i % kStages) * C::kStageBytes);
    }
    cp_async_wait<0>();
  } else {
    for (int i = 0; i < n_tiles; ++i) {
      load_stage(smem, j0 + i);
      __syncthreads();
      compute_stage(smem);
      __syncthreads();
    }
  }

#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + wrow + mt * 16 + g + (i >> 1) * 8;
        const int col = n0 + wcol + nt * 8 + 2 * t + (i & 1);
        if (row >= Mrows || col >= N) continue;
        const size_t o = (size_t)row * N + col;
        if constexpr (C::kInt) {
          out[o] = nnop::from_float<OutT>(static_cast<float>(acc[mt][nt][i]) * xscale[row] *
                                          wscale[col]);
        } else if (partial != nullptr) {
          partial[(size_t)blockIdx.z * Mrows * N + o] = acc[mt][nt][i];
        } else if constexpr (M == kI4 || M == kBF16) {
          out[o] = nnop::from_float<OutT>(acc[mt][nt][i]);
        } else {
          out[o] = nnop::from_float<OutT>(acc[mt][nt][i] * wscale[col]);
        }
      }
}

// out = (sum over splits of partial) * scale[col] (no scale when null),
// summed in split order.
template <typename OutT>
__global__ void qmm_reduce(const float* __restrict__ partial, const float* __restrict__ scale,
                           OutT* __restrict__ out, int Mrows, int N, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)Mrows * N;
  if (i >= total) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[p * total + i];
  if (scale != nullptr) s *= scale[i % N];
  out[i] = nnop::from_float<OutT>(s);
}

template <int M, int BM, bool kAligned, typename OutT>
cudaError_t launch(const void* x, const void* w, const float* wscale, const float* xscale,
                   OutT* out, float* partial, int Mrows, int N, int K, int group, int pack_block,
                   int splits, cudaStream_t st, Groups grp = Groups{}) {
  using C = Cfg<M, BM>;
  auto kern = qmm_kernel<M, BM, kAligned, OutT>;
  const int smem = (kAligned ? kStages : 1) * C::kStageBytes;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int nk = (K + kBK - 1) / kBK;
  const int per = (nk + splits - 1) / splits;
  const dim3 grid((N + kBN - 1) / kBN, (Mrows + BM - 1) / BM, splits);
  kern<<<grid, kThreads, smem, st>>>(x, static_cast<const uint8_t*>(w), wscale, xscale, out,
                                     partial, Mrows, N, K, group, pack_block, per, grp);
  return cudaGetLastError();
}

// K % 64 == 0 and N % 16 == 0: every copy is a whole 16 bytes (cp.async)
inline bool aligned_shape(int N, int K) { return K % kBK == 0 && N % 16 == 0; }

}  // namespace
