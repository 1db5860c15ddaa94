// Flash-attention forward for Hopper (sm_90a): an FA-2 loop on bf16 tensor
// cores, writing o and the row log-sum-exp (nats).
//
// Replaces nnop_tpu/ops/flash_attention.py:_fwd_impl and every kernel it
// dispatches to on the TPU (_fwd_kernel_rect, _causal_strip_kernel,
// _rect_static_kernel, ...): one kernel serves bucketed prefill (causal)
// and chunked prefill (causal from a row offset, with a key-padding mask).
//
// Bound on the H100: at prefill shapes (512 query rows, head dim 128) the
// work is ~4 * QL * KL * E flops against ~(QL + 2 * KL) * E * 2 bytes per
// head, far above the ~295 flop/byte ridge, so it is bound by tensor-core
// throughput. The design keeps the score tile, the online-softmax state
// and the output accumulator in registers (the S and P tiles never touch
// memory), reuses each K/V tile from shared memory for 64 query rows, and
// turns the causal limit into a loop bound so tiles above the diagonal
// are never loaded. It is the simple form (mma.sync, synchronous tile
// loads, 64x64 tiles); wgmma, TMA and a pipelined ring are later work.
//
// Grid: (cdiv(QL, 64), QH, B); 4 warps, each owning 16 query rows.
// GQA: the block of query head h reads KV head h / (QH / KH).
// Masking: key j is visible to query row i when j < KL, kpad[b, j] (if
// given) and, if causal, j <= i + offset. Masked scores take kMaskValue
// and their probabilities are exact zeros; a row with no visible key
// writes zeros (l == 0 is guarded), never NaN.

#include "common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per shared-memory tile
constexpr int kThreads = 128;

template <int E>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kpad,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int QH, int KH,
                 int QL, int KL, float scale, int causal, int offset) {
  constexpr int kSteps = E / 16;    // 16-deep slices of the head dim (QK^T)
  constexpr int kOTiles = E / 8;    // 8-wide output column tiles
  constexpr int kSTiles = kBK / 8;  // 8-wide score column tiles
  constexpr int kRow = E + 8;       // padded shared-memory row, in elements
  __shared__ __align__(16) __nv_bfloat16 k_s[kBK * kRow];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBK * kRow];

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (QH / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = iq * kBQ + warp * 16 + g;  // the two query rows this thread holds
  const int r_hi = r_lo + 8;

  const __nv_bfloat16* qb = q + (size_t)(b * QH + h) * QL * E;
  const __nv_bfloat16* kb = k + (size_t)(b * KH + kh) * KL * E;
  const __nv_bfloat16* vb = v + (size_t)(b * KH + kh) * KL * E;
  const uint8_t* kp = kpad ? kpad + (size_t)b * KL : nullptr;

  // Q fragments stay in registers for the whole loop (rows past QL are 0).
  auto ld_q = [&](int r, int c) -> uint32_t {
    return r < QL ? *reinterpret_cast<const uint32_t*>(qb + (size_t)r * E + c) : 0u;
  };
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int c = s * 16 + 2 * t;
    qf[s][0] = ld_q(r_lo, c);
    qf[s][1] = ld_q(r_hi, c);
    qf[s][2] = ld_q(r_lo, c + 8);
    qf[s][3] = ld_q(r_hi, c + 8);
  }

  auto visible = [&](int row, int col) -> bool {
    return col < KL && (kp == nullptr || kp[col] != 0) && (!causal || col <= row + offset);
  };

  int n_tiles = (KL + kBK - 1) / kBK;
  if (causal) {  // tiles entirely above the block's last row are never loaded
    const int last_pos = min(iq * kBQ + kBQ - 1, QL - 1) + offset;
    n_tiles = min(n_tiles, last_pos / kBK + 1);
  }

  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = nnop::kMaskValue, m_hi = nnop::kMaskValue, l_lo = 0.f, l_hi = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int c0 = j * kBK;
    __syncthreads();  // every warp is done with the previous tile
    constexpr int kVecs = E / 8;  // 16-byte vectors per row
    for (int i = threadIdx.x; i < kBK * kVecs; i += kThreads) {
      const int r = i / kVecs, cv = (i % kVecs) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;  // rows past KL are zeros
      if (c0 + r < KL) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(c0 + r) * E + cv);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(c0 + r) * E + cv);
      }
      *reinterpret_cast<uint4*>(k_s + r * kRow + cv) = kv;
      *reinterpret_cast<uint4*>(v_s + r * kRow + cv) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
        const __nv_bfloat16* kr = k_s + (n * 8 + g) * kRow + st * 16 + 2 * t;
        const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(kr),
                                *reinterpret_cast<const uint32_t*>(kr + 8)};
        nnop::mma_bf16_16816(s[n], qf[st], bf);
      }
    }

    // online softmax: mask, row max over the quad of lanes sharing a row
    float mx_lo = nnop::kMaskValue, mx_hi = nnop::kMaskValue;
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + n * 8 + 2 * t + (e & 1);
        const float val = visible(e < 2 ? r_lo : r_hi, col) ? s[n][e] * scale : nnop::kMaskValue;
        s[n][e] = val;
        if (e < 2) mx_lo = fmaxf(mx_lo, val); else mx_hi = fmaxf(mx_hi, val);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float a_lo = __expf(m_lo - mn_lo), a_hi = __expf(m_hi - mn_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + n * 8 + 2 * t + (e & 1);
        const bool lo = e < 2;
        const float p =
            visible(lo ? r_lo : r_hi, col) ? __expf(s[n][e] - (lo ? mn_lo : mn_hi)) : 0.f;
        s[n][e] = p;
        if (lo) sum_lo += p; else sum_hi += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) {
      acc[n][0] *= a_lo; acc[n][1] *= a_lo;
      acc[n][2] *= a_hi; acc[n][3] *= a_hi;
    }

    // O += P V: the score accumulators of two adjacent 8-key tiles are
    // exactly the A fragment of one 16-key slice (P rounded to bf16).
    const uint16_t* v16 = reinterpret_cast<const uint16_t*>(v_s);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {
          nnop::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
          nnop::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          nnop::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          nnop::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        const uint16_t* vr = v16 + (kk * 16 + 2 * t) * kRow + n * 8 + g;
        const uint32_t bf[2] = {nnop::pack_u16x2(vr[0], vr[kRow]),
                                nnop::pack_u16x2(vr[8 * kRow], vr[9 * kRow])};
        nnop::mma_bf16_16816(acc[n], pa, bf);
      }
    }
  }

  const float ls_lo = l_lo == 0.f ? 1.f : l_lo, ls_hi = l_hi == 0.f ? 1.f : l_hi;
  const float inv_lo = 1.f / ls_lo, inv_hi = 1.f / ls_hi;
  __nv_bfloat16* ob = o + (size_t)(b * QH + h) * QL * E;
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
    const int col = n * 8 + 2 * t;
    if (r_lo < QL)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r_lo * E + col) =
          nnop::pack_bf16x2(acc[n][0] * inv_lo, acc[n][1] * inv_lo);
    if (r_hi < QL)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r_hi * E + col) =
          nnop::pack_bf16x2(acc[n][2] * inv_hi, acc[n][3] * inv_hi);
  }
  if (t == 0) {
    float* lb = lse + (size_t)(b * QH + h) * QL;
    if (r_lo < QL) lb[r_lo] = m_lo + logf(ls_lo);
    if (r_hi < QL) lb[r_hi] = m_hi + logf(ls_hi);
  }
}

}  // namespace

// q (B, QH, QL, E), k/v (B, KH, KL, E), o (B, QH, QL, E): bf16, contiguous.
// kpad (B, KL) uint8 or null; lse (B, QH, QL) f32. E is 64 or 128.
extern "C" int nnop_flash_fwd(const void* q, const void* k, const void* v, const void* kpad,
                              void* o, void* lse, int B, int QH, int KH, int QL, int KL, int E,
                              float scale, int causal, int offset, void* stream) {
  const dim3 grid((QL + kBQ - 1) / kBQ, QH, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* pp = static_cast<const uint8_t*>(kpad);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  switch (E) {
    case 64:
      flash_fwd_kernel<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, pp, op, lp, QH, KH, QL, KL,
                                                      scale, causal, offset);
      break;
    case 128:
      flash_fwd_kernel<128><<<grid, kThreads, 0, st>>>(qp, kp, vp, pp, op, lp, QH, KH, QL, KL,
                                                       scale, causal, offset);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nnop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
