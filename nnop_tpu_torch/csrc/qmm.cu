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
// The kernel is qmm.cuh's, which says how it works. Here: BM is 16 for
// M <= 32 (decode; F and H) and 64 otherwise, and F and H split K when
// the output tiles alone cannot fill the card.

#include "qmm.cuh"

namespace {

template <int M, typename OutT>
cudaError_t dispatch(const void* x, const void* w, const float* wscale, const float* xscale,
                     OutT* out, float* partial, int Mrows, int N, int K, int group,
                     int pack_block, int splits, cudaStream_t st) {
  const bool aligned = aligned_shape(N, K);
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
