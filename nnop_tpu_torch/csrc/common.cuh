// Shared helpers for the Hopper kernels: bf16 conversion, the bf16
// tensor-core product (mma.sync m16n8k16, fp32 accumulation) and warp
// reductions. Plain CUDA, no PyTorch headers: the kernels are bound with
// ctypes (nnop_tpu_torch/utils/build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nnop {

// Large negative instead of -inf for masked scores: avoids inf - inf = NaN
// (the same constant as the TPU kernels' MASK_VALUE).
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// Round a float to the precision of T (identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// Two floats -> one register of two bf16 (lo in the low half, as the mma
// fragments expect the lower-indexed element there).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two raw bf16 values (bit patterns) -> one register.
__device__ __forceinline__ uint32_t pack_u16x2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// D += A (16x16 bf16, row-major fragment) * B (16x8 bf16, column fragment),
// fp32 accumulate. Fragment layouts (lane = 4 * g + t):
//   A: a[0] = (row g,   cols 2t..2t+1), a[1] = (row g+8, cols 2t..2t+1),
//      a[2] = (row g,   cols 2t+8..),   a[3] = (row g+8, cols 2t+8..)
//   B: b[0] = (k 2t..2t+1, col g),      b[1] = (k 2t+8..2t+9, col g)
//   D: d[0..1] = (row g, cols 2t..2t+1), d[2..3] = (row g+8, cols 2t..2t+1)
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One element of an attention pair bias (or its gradient), stored as f32
// or bf16 as `is_f32` says; i is the flat element index.
__device__ __forceinline__ float load_bf16_or_f32(const void* p, int is_f32, size_t i) {
  return is_f32 ? static_cast<const float*>(p)[i]
                : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_bf16_or_f32(void* p, int is_f32, size_t i, float x) {
  if (is_f32)
    static_cast<float*>(p)[i] = x;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
}

// Half `hi` (0: the low, lower-indexed element) of two packed bf16 values,
// as a float.
__device__ __forceinline__ float bf16x2_half(uint32_t x, int hi) {
  return __uint_as_float(hi ? (x & 0xffff0000u) : (x << 16));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// A block's shared memory as a T: a static variable where T fits the 48
// KB static limit, else the launch's dynamic shared memory, which must
// then ask for dynamic_smem_bytes<T> and be opted in to it
// (opt_in_dynamic_smem). Static where it fits: these kernels ran slower on
// dynamic shared memory (fewer registers, spills).
constexpr size_t kStaticSmemLimit = 48 * 1024;

template <typename T>
constexpr int dynamic_smem_bytes = sizeof(T) <= kStaticSmemLimit ? 0 : static_cast<int>(sizeof(T));

template <typename T>
__device__ __forceinline__ T& block_smem() {
  if constexpr (dynamic_smem_bytes<T> == 0) {
    __shared__ T sm;
    return sm;
  } else {
    extern __shared__ __align__(16) unsigned char nnop_dynamic_smem[];
    return *reinterpret_cast<T*>(nnop_dynamic_smem);
  }
}

// Lets `kernel` launch with T's dynamic shared memory (past 48 KB a launch
// fails without it); a no-op for a static T. Callers keep the result in a
// function-local static, so it runs once per kernel.
template <typename T, typename Kernel>
cudaError_t opt_in_dynamic_smem(Kernel* kernel) {
  if constexpr (dynamic_smem_bytes<T> == 0)
    return cudaSuccess;
  else
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                dynamic_smem_bytes<T>);
}

}  // namespace nnop
