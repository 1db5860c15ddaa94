// Grouped (mixture-of-experts) matrix products for Hopper (sm_90a): kernel I.
//
// out[m] = x[m] @ w[g(m)], g(m) = block_groups[m / block_m], over tokens
// sorted by expert in blocks of block_m rows (one expert per block).
// Replaces, in nnop_tpu/ops/grouped_matmul.py, with one kernel in four
// modes:
//   bf16      grouped_matmul            (_gmm_fwd_impl, _gmm_kernel)
//   int8      grouped_matmul_quantized  (_gmm_q_kernel)     per-(E, N) scales
//   W8A8      grouped_matmul_w8a8       (_gmm_w8a8_kernel)  int8 x int8 -> int32
//   int4      _grouped_matmul_q4        (_gmm_q4_kernel)    packed nibbles, group scales
//
// Bound on the H100. At decode (a few tokens per expert) the products are
// bound by device-memory bandwidth: each expert that holds a token streams
// its whole slab once per row tile. At prefill (hundreds of rows per
// expert) they are bound by the tensor cores. The kernel is qmm.cuh's,
// with the expert chosen per row tile (qmm.cuh says how): BM = 16 when
// block_m is not a multiple of 64 (decode, block_m 32), else 64, so a row
// tile never straddles two experts; a tile past its block's real rows
// writes zeros without streaming a weight. No split of K yet: the decode
// grid is live row tiles x N / 128 blocks, which fills the card for
// w_gateup (N = 28672) but only about twice over for w_down (N = 4096).

#include "qmm.cuh"

namespace {

template <int M, typename OutT>
cudaError_t dispatch(const void* x, const void* w, const float* wscale, const float* xscale,
                     OutT* out, int Mrows, int N, int K, int group, int pack_block, Groups grp,
                     cudaStream_t st) {
  const bool aligned = aligned_shape(N, K);
#define NNOP_GMM_LAUNCH(BM, AL)                                                          \
  return launch<M, BM, AL, OutT>(x, w, wscale, xscale, out, nullptr, Mrows, N, K, group, \
                                 pack_block, 1, st, grp)
  if (grp.block_m % 64 != 0) {
    if (aligned) NNOP_GMM_LAUNCH(16, true);
    NNOP_GMM_LAUNCH(16, false);
  }
  if (aligned) NNOP_GMM_LAUNCH(64, true);
  NNOP_GMM_LAUNCH(64, false);
#undef NNOP_GMM_LAUNCH
}

}  // namespace

// Kernel I. x (M, K): bf16, or int8 for W8A8 (mode 3) with xs (M,) f32 row
// scales. w: (E, K, N) int8 (mode 0, W8A8), (E, K/2, N) packed int4 with K
// padded to the pack block (mode 2; x zero-padded to that K), or (E, K, N)
// bf16 (mode 4). scale: (E, N) f32 (modes 0, 3), (E, K/group, N) f32
// (mode 2), unused (mode 4). block_groups (M / block_m,) int32 experts in
// [0, E); block_rows (M / block_m,) int32 real rows per block, or null.
// out (M, N) bf16, or f32 for W8A8 with out_is_f32.
extern "C" int nnop_gmm(const void* x, const void* xs, const void* w, const void* scale,
                        void* out, const void* block_groups, const void* block_rows, int M, int N,
                        int K, int block_m, int mode, int group, int pack_block, int out_is_f32,
                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block_m <= 0 || block_m % 16 != 0 || M % block_m != 0 ||
      block_groups == nullptr ||
      !(mode == kI8 || mode == kI4 || mode == kW8A8 || mode == kBF16) ||
      (out_is_f32 && mode != kW8A8) || (mode == kW8A8 && xs == nullptr) ||
      (mode == kI4 && (pack_block % (2 * kBK) != 0 || K % pack_block != 0 ||
                       group % (kBK / 2) != 0 || (pack_block / 2) % group != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  const auto* xsc = static_cast<const float*>(xs);
  Groups grp;
  grp.block_groups = static_cast<const int*>(block_groups);
  grp.block_rows = static_cast<const int*>(block_rows);
  grp.block_m = block_m;
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaError_t e;
  switch (mode) {
    case kI8:
      grp.w_stride = (long long)K * N;
      grp.s_stride = N;
      e = dispatch<kI8>(x, w, sc, nullptr, o, M, N, K, group, pack_block, grp, st);
      break;
    case kI4:
      grp.w_stride = (long long)K / 2 * N;
      grp.s_stride = (long long)K / group * N;
      e = dispatch<kI4>(x, w, sc, nullptr, o, M, N, K, group, pack_block, grp, st);
      break;
    case kBF16:
      grp.w_stride = 2LL * K * N;
      e = dispatch<kBF16>(x, w, sc, nullptr, o, M, N, K, group, pack_block, grp, st);
      break;
    default:  // kW8A8
      grp.w_stride = (long long)K * N;
      grp.s_stride = N;
      if (out_is_f32)
        e = dispatch<kW8A8>(x, w, sc, xsc, static_cast<float*>(out), M, N, K, 0, 0, grp, st);
      else
        e = dispatch<kW8A8>(x, w, sc, xsc, o, M, N, K, 0, 0, grp, st);
  }
  return static_cast<int>(e);
}
