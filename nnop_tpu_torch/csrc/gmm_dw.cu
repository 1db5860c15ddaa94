// The grouped product's weight gradient for Hopper (sm_90a).
//
// dw[e] = sum over expert e's row blocks b of x_b^T @ dy_b, with x (M, K)
// and dy (M, N) bf16 rows sorted by expert in blocks of block_m
// (nnop_tpu_torch/models/moe.py:sort_tokens_by_expert), fp32 sums, dw
// (E, K, N) bf16. Replaces nnop_tpu/ops/grouped_matmul.py:_gmm_dw (its
// Pallas body _gmm_dw_kernel), the backward's weight half; the input half
// (dx) is kernel I's forward on the transposed experts.
//
// Bound on the H100. At Mixtral's training shape (8192 real rows, K 4096,
// N 14336) the product is 0.96 TFLOP against 1.2 GB of operands and
// result: bound by the tensor cores (~0.97 ms at 989 TFLOP/s bf16).
//
// Design (the simple form; wgmma and TMA come later). One block per
// (expert, 128-row tile of K, 128-column tile of N): grid (N/128, K/128,
// E), 4 warps each owning a 64 x 64 quarter of the output tile in fp32
// registers (mma.sync m16n8k16 bf16). The TPU kernel carries its sum
// across sequential grid steps and relies on the row blocks arriving in
// order; here each block walks the rows itself: it scans block_groups for
// its expert's blocks (no host synchronization; the scan also tolerates
// unsorted groups) and, inside each, only the real rows (block_rows),
// 32 rows per stage through a 4-stage cp.async ring of x and dy tiles in
// shared memory (rows past a block's real rows and columns past K or N are
// zero-filled). Both operands are read transposed out of their row-major
// tiles with ldmatrix.trans: the x tile gives the A fragment (x^T), the dy
// tile the B fragment. Each block writes its tile once, so an expert with
// no row gets exact zeros and two runs give the same bits (no atomics; the
// rows are summed in one fixed order). Shapes whose rows are not 16-byte
// aligned (K or N not a multiple of 8) take a synchronous path with
// guarded element loads (the same compute).

#include "qmm.cuh"

namespace {

constexpr int kDwThreads = 128;
constexpr int kDwBM = 128;                     // dw rows (K) per block
constexpr int kDwBN = 128;                     // dw columns (N) per block
constexpr int kDwR = 32;                       // x / dy rows per stage
constexpr int kDwStages = 4;
constexpr int kDwRowBytes = kDwBM * 2 + 16;    // a shared tile row, padded: ldmatrix conflict-free
constexpr int kDwTileBytes = kDwR * kDwRowBytes;
constexpr int kDwStageBytes = 2 * kDwTileBytes;  // the x tile, then the dy tile
static_assert(kDwBM == kDwBN, "the x and dy tiles share one row layout");

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The stages of one expert, in row order: the real rows of each of its
// blocks, kDwR at a time.
struct RowWalk {
  const int* groups;
  const int* rows;  // real rows per block, or null (all block_m)
  int e, block_m, n_blocks;
  int b = 0, r0 = 0;  // the current block and the stage's first row in it

  __device__ int real(int blk) const {
    return rows == nullptr ? block_m : min(max(rows[blk], 0), block_m);
  }
  // move to the first block of expert e at or after b with a row left
  __device__ void settle() {
    while (b < n_blocks && (groups[b] != e || r0 >= real(b))) {
      ++b;
      r0 = 0;
    }
  }
  __device__ bool done() const { return b >= n_blocks; }
  __device__ int row0() const { return b * block_m + r0; }
  __device__ int valid() const { return min(kDwR, real(b) - r0); }
  __device__ void next() {
    r0 += kDwR;
    settle();
  }
};

// Grid (cdiv(N, 128), cdiv(K, 128), E). x (M, K), dy (M, N) bf16; dw
// (E, K, N) bf16, every element written.
template <bool kAligned>
__global__ void __launch_bounds__(kDwThreads)
gmm_dw_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ dy,
              __nv_bfloat16* __restrict__ dw, const int* __restrict__ groups,
              const int* __restrict__ rows, int M, int K, int N, int block_m) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kDwBN, k0 = blockIdx.y * kDwBM, e = blockIdx.z;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 64;  // this warp's quarter

  RowWalk walk{groups, rows, e, block_m, M / block_m};
  walk.settle();
  int n_stages = 0;
  {
    RowWalk count = walk;
    for (; !count.done(); count.next()) ++n_stages;
  }

  auto load_stage = [&](uint8_t* st, int row0, int nvalid) {
    uint8_t* sX = st;
    uint8_t* sY = st + kDwTileBytes;
    if constexpr (kAligned) {
      for (int c = tid; c < kDwR * (kDwBM / 8); c += kDwThreads) {
        const int r = c / (kDwBM / 8), cc = c % (kDwBM / 8);
        const int k = k0 + cc * 8, n = n0 + cc * 8;
        const bool okx = r < nvalid && k < K, oky = r < nvalid && n < N;
        cp_async16(sX + r * kDwRowBytes + cc * 16,
                   x + (okx ? (size_t)(row0 + r) * K + k : 0), okx);
        cp_async16(sY + r * kDwRowBytes + cc * 16,
                   dy + (oky ? (size_t)(row0 + r) * N + n : 0), oky);
      }
    } else {
      for (int i = tid; i < kDwR * kDwBM; i += kDwThreads) {
        const int r = i / kDwBM, c = i % kDwBM;
        const bool rok = r < nvalid;
        reinterpret_cast<uint16_t*>(sX + r * kDwRowBytes)[c] =
            rok && k0 + c < K ? x[(size_t)(row0 + r) * K + k0 + c] : 0;
        reinterpret_cast<uint16_t*>(sY + r * kDwRowBytes)[c] =
            rok && n0 + c < N ? dy[(size_t)(row0 + r) * N + n0 + c] : 0;
      }
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // ldmatrix.trans row addresses: lanes 8i..8i+7 give the rows of matrix
  // i. A (x^T, 16 x 16 over K x rows): matrices (rows +0, K +0), (rows +0,
  // K +8), (rows +8, K +0), (rows +8, K +8) are a[0..3]. B (dy, rows x 8
  // columns, two n8 tiles): (rows +0, N +0), (rows +8, N +0) are b[0..1] of
  // the first tile, (rows +0, N +8), (rows +8, N +8) of the second.
  const int li = lane >> 3, lj = lane & 7;
  const int a_row = lj + (li >> 1) * 8, a_col = (li & 1) * 8;
  const int b_row = lj + (li & 1) * 8, b_col = (li >> 1) * 8;

  auto compute_stage = [&](const uint8_t* st) {
    const uint8_t* sX = st;
    const uint8_t* sY = st + kDwTileBytes;
#pragma unroll
    for (int kk = 0; kk < kDwR / 16; ++kk) {
      uint32_t a[4][4], b[8][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_trans(a[mt], sX + (kk * 16 + a_row) * kDwRowBytes +
                                     (wm + mt * 16 + a_col) * 2);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t q[4];
        ldmatrix_x4_trans(q, sY + (kk * 16 + b_row) * kDwRowBytes + (wn + np * 16 + b_col) * 2);
        b[2 * np][0] = q[0];
        b[2 * np][1] = q[1];
        b[2 * np + 1][0] = q[2];
        b[2 * np + 1][1] = q[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) nnop::mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
    }
  };

  if constexpr (kAligned) {
#pragma unroll
    for (int s = 0; s < kDwStages - 1; ++s) {
      if (s < n_stages) {
        load_stage(smem + s * kDwStageBytes, walk.row0(), walk.valid());
        walk.next();
      }
      cp_async_commit();
    }
    for (int i = 0; i < n_stages; ++i) {
      cp_async_wait<kDwStages - 2>();
      __syncthreads();  // stage i has landed; stage i - 1 is free for the prefetch
      if (i + kDwStages - 1 < n_stages) {
        load_stage(smem + ((i + kDwStages - 1) % kDwStages) * kDwStageBytes, walk.row0(),
                   walk.valid());
        walk.next();
      }
      cp_async_commit();
      compute_stage(smem + (i % kDwStages) * kDwStageBytes);
    }
    cp_async_wait<0>();
  } else {
    for (int i = 0; i < n_stages; ++i) {
      load_stage(smem, walk.row0(), walk.valid());
      walk.next();
      __syncthreads();
      compute_stage(smem);
      __syncthreads();
    }
  }

  __nv_bfloat16* out = dw + (size_t)e * K * N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = k0 + wm + mt * 16 + g + (i >> 1) * 8;
        const int col = n0 + wn + nt * 8 + 2 * t + (i & 1);
        if (row < K && col < N) out[(size_t)row * N + col] = __float2bfloat16_rn(acc[mt][nt][i]);
      }
}

template <bool kAligned>
cudaError_t launch_dw(const void* x, const void* dy, void* dw, const int* groups,
                      const int* rows, int M, int K, int N, int E, int block_m,
                      cudaStream_t st) {
  auto kern = gmm_dw_kernel<kAligned>;
  const int smem = (kAligned ? kDwStages : 1) * kDwStageBytes;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((N + kDwBN - 1) / kDwBN, (K + kDwBM - 1) / kDwBM, E);
  kern<<<grid, kDwThreads, smem, st>>>(static_cast<const uint16_t*>(x),
                                       static_cast<const uint16_t*>(dy),
                                       static_cast<__nv_bfloat16*>(dw), groups, rows, M, K, N,
                                       block_m);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) and dy (M, N) bf16, rows sorted by expert in blocks of block_m;
// block_groups (M / block_m,) int32 expert per block (blocks whose expert
// is outside [0, E) add to no expert); block_rows (M / block_m,) int32 real
// rows per block (rows past them count as zero), or null. dw (E, K, N)
// bf16: every element written, zeros for an expert with no row.
extern "C" int nnop_gmm_dw(const void* x, const void* dy, void* dw, const void* block_groups,
                           const void* block_rows, int M, int K, int N, int E, int block_m,
                           void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || E <= 0 || E > 65535 || block_m <= 0 || M % block_m != 0 ||
      (M > 0 && block_groups == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* groups = static_cast<const int*>(block_groups);
  const auto* rows = static_cast<const int*>(block_rows);
  if (K % 8 == 0 && N % 8 == 0)
    return static_cast<int>(launch_dw<true>(x, dy, dw, groups, rows, M, K, N, E, block_m, st));
  return static_cast<int>(launch_dw<false>(x, dy, dw, groups, rows, M, K, N, E, block_m, st));
}
