// Quantized matrix products for Hopper (sm_90a): kernels F, G and H.
//
// Replaces, in nnop_tpu/ops/quantized_matmul.py:
//   F  quantized_matmul   (_qmm_kernel)   out = (x @ w_q) * scale[N], w_q int8 or fp8-e4m3
//   G  quantized_matmul_w8a8 (_w8a8_kernel) out = (int32 (x_q @ w_q) * xs[M]) * ws[N]
//   H  quantized_matmul4  (_qmm4_kernel)  out = x @ (int4 nibbles * group scale, rounded to bf16)
//
// Bound on the H100. At decode (M = 8) F and H are bound by device-memory
// bandwidth: the weights are read once (K * N bytes for int8, half that
// plus the group scales for int4) against 2 * M flops per weight, far
// below the ~295 flop/byte ridge. At prefill (M >= 256) the products are
// bound by the tensor cores: G's int8 mma runs at twice the bf16 rate.
//
// Design. One templated kernel: a block computes a BM x 128 output tile
// with 4 warps and walks K in steps of 64, through a 4-stage ring of
// shared-memory tiles filled by cp.async (16-byte copies, zero-filled past
// the M and N edges), so several tiles' loads are in flight while the
// tensor cores work on the oldest. The quantized weight tile lands in
// shared memory as raw bytes and is dequantized only when a thread builds
// its mma fragment, in registers: no dequantized weight ever reaches
// device memory, which is the point of the TPU kernels. F and H use
// mma.sync m16n8k16 bf16 with fp32 accumulation (int8 -> bf16 and
// fp8 -> bf16 are exact); F applies the per-column scale once to the fp32
// sum; H folds each group scale into its nibbles in f32 and rounds to bf16
// before the product, as the TPU kernel does. G uses mma.sync m16n8k32
// s8.s8.s32: the integer sum is exact, and the epilogue applies the row
// and column scales in the plain version's order. BM is 16 for M <= 32
// (decode) and 64 otherwise. When the output tiles alone cannot fill the
// card (decode, N = 4096), the caller splits K across blocks: each split
// writes an fp32 partial and a second small kernel sums them in order and
// applies the scale. Shapes whose rows are not 16-byte aligned or whose
// K is not a multiple of 64 take a synchronous path with guarded element
// loads (the same compute). This is the simple form: wgmma and TMA, and a
// transposed weight layout for conflict-free fragment reads, come later.
//
// int4 layout (nnop_tpu/ops/quantization.py:quantize4): inside each pack
// block P of K, packed row r holds row r in its low nibble and row r + P/2
// in its high nibble; a stage covers 32 packed rows, i.e. 32 rows of each
// half, and the matching two 32-column slices of x.

#include <cuda_fp8.h>

#include <type_traits>

#include "common.cuh"

namespace {

enum Mode { kI8 = 0, kF8 = 1, kI4 = 2, kW8A8 = 3 };

constexpr int kThreads = 128;
constexpr int kBN = 128;            // output columns per block
constexpr int kBK = 64;             // K values per stage
constexpr int kWStride = kBN + 16;  // bytes per shared weight row (16-byte aligned)
constexpr int kStages = 4;

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
  static constexpr int kWR = M == kI4 ? kBK / 2 : kBK;       // weight rows per stage
  static constexpr int kStageBytes = BM * kXS + kWR * kWStride + (M == kI4 ? 2 * kBN * 4 : 0);
  static constexpr int kWM = BM == 16 ? 1 : 2, kWN = 4 / kWM;  // warps along M and N
  static constexpr int kMT = BM / kWM / 16, kNT = kBN / kWN / 8;  // mma tiles per warp
};

// Grid (cdiv(N, 128), cdiv(M, BM), splits). x (M, K) bf16 (int8 for G);
// w (K, N) bytes (int4: (K/2, N) packed, K padded to the pack block);
// wscale (N,) f32 (F, G) or (K/group, N) f32 (H); xscale (M,) f32 (G).
// partial != null: write the fp32 sum of this block's K range to
// partial[blockIdx.z] and leave the scale to the reduce kernel.
template <int M, int BM, bool kAligned, typename OutT>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const void* __restrict__ x_, const uint8_t* __restrict__ w,
           const float* __restrict__ wscale, const float* __restrict__ xscale,
           OutT* __restrict__ out, float* __restrict__ partial, int Mrows, int N, int K, int group,
           int pack_block, int tiles_per_split) {
  using C = Cfg<M, BM>;
  using Acc = typename std::conditional<C::kInt, int, float>::type;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* x = static_cast<const uint8_t*>(x_);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int wrow = (warp / C::kWN) * C::kMT * 16, wcol = (warp % C::kWN) * C::kNT * 8;
  const int w_rows = M == kI4 ? K / 2 : K;

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
    float* sS = reinterpret_cast<float*>(sW + C::kWR * kWStride);
    const int wrow0 = j * C::kWR;
    if constexpr (kAligned) {
      for (int c = tid; c < BM * C::kXChunks; c += kThreads) {
        const int r = c / C::kXChunks, cc = c % C::kXChunks;
        const bool ok = m0 + r < Mrows;
        const int k = x_col(j, cc * (16 / C::kXB));
        cp_async16(sX + r * C::kXS + cc * 16,
                   x + ((size_t)(ok ? m0 + r : 0) * K + k) * C::kXB, ok);
      }
      for (int c = tid; c < C::kWR * (kBN / 16); c += kThreads) {
        const int r = c / (kBN / 16), col = n0 + (c % (kBN / 16)) * 16;
        const bool ok = col < N;
        cp_async16(sW + r * kWStride + (c % (kBN / 16)) * 16,
                   w + (size_t)(wrow0 + r) * N + (ok ? col : 0), ok);
      }
      if constexpr (M == kI4) {
        for (int c = tid; c < 2 * (kBN / 4); c += kThreads) {
          const int h = c / (kBN / 4), col = n0 + (c % (kBN / 4)) * 4;
          const bool ok = col < N;
          const int grp = x_col(j, h * (kBK / 2)) / group;
          cp_async16(sS + h * kBN + (c % (kBN / 4)) * 4,
                     wscale + (size_t)grp * N + (ok ? col : 0), ok);
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
        sW[r * kWStride + c] = row < w_rows && col < N ? w[(size_t)row * N + col] : 0;
      }
      if constexpr (M == kI4) {
        for (int i = tid; i < 2 * kBN; i += kThreads) {
          const int h = i / kBN, col = n0 + i % kBN;
          const int grp = x_col(j, h * (kBK / 2)) / group;
          sS[i] = col < N ? wscale[(size_t)grp * N + col] : 0.f;
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
    const float* sS = reinterpret_cast<const float*>(sW + C::kWR * kWStride);
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
          const uint8_t* col = sW + (kk * 32 + 4 * t) * kWStride + wcol + nt * 8 + g;
          uint32_t b[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint8_t* c = col + h * 16 * kWStride;
            b[h] = (uint32_t)c[0] | ((uint32_t)c[kWStride] << 8) |
                   ((uint32_t)c[2 * kWStride] << 16) | ((uint32_t)c[3 * kWStride] << 24);
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
            const uint8_t* col = sW + ((kk & 1) * 16 + 2 * t) * kWStride + n;
            const float sc = sS[(kk >> 1) * kBN + n];
            auto v = [&](int r) {
              const int byte = static_cast<int8_t>(col[r * kWStride]);
              const int q = (kk >> 1) ? (byte >> 4) : (static_cast<int>(static_cast<uint32_t>(byte) << 28) >> 28);
              return static_cast<float>(q) * sc;
            };
            b[0] = nnop::pack_bf16x2(v(0), v(1));
            b[1] = nnop::pack_bf16x2(v(8), v(9));
          } else {
            const uint8_t* col = sW + (kk * 16 + 2 * t) * kWStride + n;
            b[0] = nnop::pack_bf16x2(dequant_byte<M>(col[0]), dequant_byte<M>(col[kWStride]));
            b[1] = nnop::pack_bf16x2(dequant_byte<M>(col[8 * kWStride]),
                                     dequant_byte<M>(col[9 * kWStride]));
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
        } else if constexpr (M == kI4) {
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
                   int splits, cudaStream_t st) {
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
                                     partial, Mrows, N, K, group, pack_block, per);
  return cudaGetLastError();
}

template <int M, typename OutT>
cudaError_t dispatch(const void* x, const void* w, const float* wscale, const float* xscale,
                     OutT* out, float* partial, int Mrows, int N, int K, int group,
                     int pack_block, int splits, cudaStream_t st) {
  const bool aligned = K % kBK == 0 && N % 16 == 0;
#define NNOP_QMM_LAUNCH(BM, AL)                                                             \
  return launch<M, BM, AL, OutT>(x, w, wscale, xscale, out, partial, Mrows, N, K, group, \
                                 pack_block, splits, st)
  if constexpr (M != kW8A8) {  // decode rows: one 16-row mma tile
    if (Mrows <= 32) {
      if (aligned) NNOP_QMM_LAUNCH(16, true);
      NNOP_QMM_LAUNCH(16, false);
    }
  }
  if (aligned) NNOP_QMM_LAUNCH(64, true);
  NNOP_QMM_LAUNCH(64, false);
#undef NNOP_QMM_LAUNCH
}

}  // namespace

// F and H. x (M, K) bf16 (H: K is the packed K, x zero-padded to it);
// w (K, N) int8 / fp8 bytes (mode 0 / 1) or (K/2, N) packed int4 (mode 2);
// scale (N,) f32 (F) or (K/group, N) f32 (H); out (M, N) bf16. With
// splits > 1, partial is an (splits, M, N) f32 scratch and a second kernel
// reduces it.
extern "C" int nnop_qmm(const void* x, const void* w, const void* scale, void* out, void* partial,
                        int M, int N, int K, int mode, int group, int pack_block, int splits,
                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || (splits > 1 && partial == nullptr) ||
      mode < kI8 || mode > kI4 ||
      (mode == kI4 && (pack_block % (2 * kBK) != 0 || K % pack_block != 0 ||
                       group % (kBK / 2) != 0 || (pack_block / 2) % group != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  auto* o = static_cast<__nv_bfloat16*>(out);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  cudaError_t e;
  if (mode == kI8)
    e = dispatch<kI8>(x, w, sc, nullptr, o, part, M, N, K, group, pack_block, splits, st);
  else if (mode == kF8)
    e = dispatch<kF8>(x, w, sc, nullptr, o, part, M, N, K, group, pack_block, splits, st);
  else
    e = dispatch<kI4>(x, w, sc, nullptr, o, part, M, N, K, group, pack_block, splits, st);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t total = (size_t)M * N;
  qmm_reduce<__nv_bfloat16><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, mode == kI4 ? nullptr : sc, o, M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

// G. xv (M, K) int8, xs (M,) f32, w (K, N) int8, ws (N,) f32; out (M, N)
// bf16, or f32 when out_is_f32.
extern "C" int nnop_qmm_w8a8(const void* xv, const void* xs, const void* w, const void* ws,
                             void* out, int M, int N, int K, int out_is_f32, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xsc = static_cast<const float*>(xs);
  const auto* wsc = static_cast<const float*>(ws);
  cudaError_t e;
  if (out_is_f32)
    e = dispatch<kW8A8>(xv, w, wsc, xsc, static_cast<float*>(out), nullptr, M, N, K, 0, 0, 1, st);
  else
    e = dispatch<kW8A8>(xv, w, wsc, xsc, static_cast<__nv_bfloat16*>(out), nullptr, M, N, K, 0,
                        0, 1, st);
  return static_cast<int>(e);
}
