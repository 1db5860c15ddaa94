// Flash-attention forward for Hopper (sm_90a): an FA-2 loop on bf16 tensor
// cores, writing o and the row log-sum-exp (nats).
//
// Replaces nnop_tpu/ops/flash_attention.py:_fwd_impl and every kernel it
// dispatches to on the TPU (_fwd_kernel_rect, _causal_strip_kernel via
// _fwd_causal_window and _fwd_causal_chunked, _rect_static_kernel, ...):
// one kernel serves bucketed prefill (causal), chunked prefill (causal
// from a row offset, with a key-padding mask), the sliding window, the
// score softcap, and the pair bias and segment ids of packed documents.
//
// Bound on the H100: at prefill shapes (512 query rows, head dim 128) the
// work is ~4 * QL * KL * E flops against ~(QL + 2 * KL) * E * 2 bytes per
// head, far above the ~295 flop/byte ridge, so it is bound by tensor-core
// throughput. The design keeps the score tile, the online-softmax state
// and the output accumulator in registers (the S and P tiles never touch
// memory), reuses each K/V tile from shared memory for 64 query rows, and
// turns the causal limit and the window into loop bounds, so tiles above
// the diagonal or wholly before the window are never loaded: a windowed
// row reads about window + 64 keys, whatever the key length. It is the
// simple form (mma.sync, synchronous tile loads); wgmma, TMA and a
// pipelined ring are later work. Segment ids mask scores but skip no key
// tile yet (a tile wholly outside the row's document is still loaded).
//
// Grid: (cdiv(QL, 64), QH, B); 4 warps, each owning 16 query rows.
// GQA: the block of query head h reads KV head h / (QH / KH).
// Tiles: 64 keys at head dim 64 and 128, with Q's fragments held in
// registers and the K/V tiles in static shared memory. At head dim 256
// the output accumulator alone is 128 f32 registers a thread, so Q stays
// in shared memory (its fragments are loaded per 16-deep step) and key
// tiles are 32 rows; the tiles (Q 64 x 264, K and V 32 x 264 bf16: 66
// KB) are dynamic shared memory. Static shared memory where it fits: the
// same kernel on dynamic shared memory ran slower at head dim 128. The
// softcap and the window are template flags, so a call without them runs
// no per-score test for them (a runtime window test slowed the plain
// causal path). So is kExtra, the "extra score terms": the pair bias
// and the segment ids, each pointer nullable inside it (one flag, not
// two, keeps the instantiations at 24). A bf16 pair with an even KL is
// read two columns a load, for the whole key tile before its QK^T product
// (the loads overlap the product); an f32 pair, or an odd KL, one visible
// score at a time. The key tile's segment ids are staged in shared memory
// with K and V.
// Scores: s = scale * q.k, then with a softcap c, s = c * tanh(s / c),
// then + pair[b, h, i, j] in f32 (the softcap and the pair never meet),
// BEFORE any mask (nnop_tpu/ops/flash_attention.py:119-124).
// Masking: key j is visible to query row i (at position pos = i + offset)
// when j < KL, kpad[b, j] (if given), q_seg[b, i] == kv_seg[b, j] (if
// given) and, if causal, j <= pos and, with a window w, pos - j < w.
// Masked scores take kMaskValue and their
// probabilities are exact zeros; a row with no visible key writes zeros
// (l == 0 is guarded), never NaN.

#include "common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kThreads = 128;

template <int E>
struct FwdShape {
  static constexpr bool kQSmem = E > 128;   // Q in shared memory, not registers
  static constexpr int kBK = E > 128 ? 32 : 64;  // keys per shared-memory tile
  static constexpr int kRow = E + 8;        // padded shared-memory row, in elements
};

// The block's K and V tiles (and at E 256 its Q rows), padded rows.
template <int E>
struct alignas(16) FwdTiles {
  using S = FwdShape<E>;
  __nv_bfloat16 buf[((S::kQSmem ? kBQ : 0) + 2 * S::kBK) * S::kRow];
};

// kSoftcap / kWindow / kExtra: compiled in only where asked for; inv_cap
// = 1 / softcap comes from the host.
template <int E, bool kSoftcap, bool kWindow, bool kExtra>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kpad,
                 const void* __restrict__ pair, const int* __restrict__ qseg,
                 const int* __restrict__ kseg, int pair_f32,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int QH, int KH,
                 int QL, int KL, float scale, int causal, int offset, int window,
                 float softcap, float inv_cap) {
  using Shape = FwdShape<E>;
  constexpr int kBK = Shape::kBK;
  constexpr int kRow = Shape::kRow;
  constexpr bool kQSmem = Shape::kQSmem;
  constexpr int kSteps = E / 16;    // 16-deep slices of the head dim (QK^T)
  constexpr int kOTiles = E / 8;    // 8-wide output column tiles
  constexpr int kSTiles = kBK / 8;  // 8-wide score column tiles
  constexpr int kVecs = E / 8;      // 16-byte vectors per row
  __nv_bfloat16* k_s = nnop::block_smem<FwdTiles<E>>().buf;
  __nv_bfloat16* v_s = k_s + kBK * kRow;
  __nv_bfloat16* q_s = v_s + kBK * kRow;  // used only when kQSmem
  __shared__ int kseg_s[kExtra ? kBK : 1];  // the key tile's segment ids (kExtra)

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
  // kExtra: this head's pair rows, the keys' segment ids (staged per key
  // tile in kseg_s) and the two rows' own
  const size_t pair_off = (size_t)(b * QH + h) * QL * KL;
  const bool pair_vec = kExtra && pair != nullptr && !pair_f32 && KL % 2 == 0;
  const int* ks = kExtra && kseg != nullptr ? kseg + (size_t)b * KL : nullptr;
  int qs_lo = 0, qs_hi = 0;
  if constexpr (kExtra) {
    if (ks != nullptr) {
      if (r_lo < QL) qs_lo = qseg[(size_t)b * QL + r_lo];
      if (r_hi < QL) qs_hi = qseg[(size_t)b * QL + r_hi];
    }
  }

  // Q fragments: in registers for the whole loop (E <= 128), or the block's
  // 64 Q rows in shared memory (E = 256). Rows past QL are 0.
  auto ld_q = [&](int r, int c) -> uint32_t {
    return r < QL ? *reinterpret_cast<const uint32_t*>(qb + (size_t)r * E + c) : 0u;
  };
  uint32_t qf[kQSmem ? 1 : kSteps][4];
  if constexpr (kQSmem) {
    for (int i = threadIdx.x; i < kBQ * kVecs; i += kThreads) {
      const int r = i / kVecs, cv = (i % kVecs) * 8, row = iq * kBQ + r;
      *reinterpret_cast<uint4*>(q_s + r * kRow + cv) =
          row < QL ? *reinterpret_cast<const uint4*>(qb + (size_t)row * E + cv)
                   : make_uint4(0, 0, 0, 0);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int c = s * 16 + 2 * t;
      qf[s][0] = ld_q(r_lo, c);
      qf[s][1] = ld_q(r_hi, c);
      qf[s][2] = ld_q(r_lo, c + 8);
      qf[s][3] = ld_q(r_hi, c + 8);
    }
  }

  auto visible = [&](int row, int col) -> bool {
    const int pos = row + offset;
    return col < KL && (kp == nullptr || kp[col] != 0) &&
           (!causal || (col <= pos && (!kWindow || pos - col < window))) &&
           (!kExtra || ks == nullptr || kseg_s[col % kBK] == (row == r_lo ? qs_lo : qs_hi));
  };

  int n_tiles = (KL + kBK - 1) / kBK, j_first = 0;
  if (causal) {  // tiles entirely above the block's last row are never loaded
    const int last_pos = min(iq * kBQ + kBQ - 1, QL - 1) + offset;
    n_tiles = min(n_tiles, last_pos / kBK + 1);
    if constexpr (kWindow)  // nor tiles entirely before its first row's window
      j_first = max(0, iq * kBQ + offset + 1 - window) / kBK;
  }

  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = nnop::kMaskValue, m_hi = nnop::kMaskValue, l_lo = 0.f, l_hi = 0.f;

  for (int j = j_first; j < n_tiles; ++j) {
    const int c0 = j * kBK;
    __syncthreads();  // every warp is done with the previous tile (and Q has landed)
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
    if constexpr (kExtra) {
      if (ks != nullptr && threadIdx.x < kBK)
        kseg_s[threadIdx.x] = c0 + threadIdx.x < KL ? ks[c0 + threadIdx.x] : 0;
    }
    __syncthreads();

    // kExtra, a bf16 pair and an even KL: the tile's pair values for this
    // thread's two rows, two adjacent columns per register
    uint32_t pv[kExtra ? kSTiles : 1][2];
    if constexpr (kExtra) {
      if (pair_vec) {
        const __nv_bfloat16* pb = static_cast<const __nv_bfloat16*>(pair) + pair_off;
#pragma unroll
        for (int n = 0; n < kSTiles; ++n) {
          const int col = c0 + n * 8 + 2 * t;  // even, so col + 1 < KL too
          pv[n][0] = r_lo < QL && col < KL
                         ? *reinterpret_cast<const uint32_t*>(pb + (size_t)r_lo * KL + col) : 0u;
          pv[n][1] = r_hi < QL && col < KL
                         ? *reinterpret_cast<const uint32_t*>(pb + (size_t)r_hi * KL + col) : 0u;
        }
      }
    }

    // S = Q K^T for this warp's 16 rows x kBK keys
    float s[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const uint32_t* qa;
      uint32_t qs[4];
      if constexpr (kQSmem) {
        const __nv_bfloat16* qr = q_s + (warp * 16 + g) * kRow + st * 16 + 2 * t;
        qs[0] = *reinterpret_cast<const uint32_t*>(qr);
        qs[1] = *reinterpret_cast<const uint32_t*>(qr + 8 * kRow);
        qs[2] = *reinterpret_cast<const uint32_t*>(qr + 8);
        qs[3] = *reinterpret_cast<const uint32_t*>(qr + 8 * kRow + 8);
        qa = qs;
      } else {
        qa = qf[st];
      }
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
        const __nv_bfloat16* kr = k_s + (n * 8 + g) * kRow + st * 16 + 2 * t;
        const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(kr),
                                *reinterpret_cast<const uint32_t*>(kr + 8)};
        nnop::mma_bf16_16816(s[n], qa, bf);
      }
    }

    // scale, softcap, mask; online softmax: row max over the quad of lanes
    // sharing a row. With kExtra each score's visibility is taken once,
    // into a bit of vbits, which the exp pass reads back.
    float mx_lo = nnop::kMaskValue, mx_hi = nnop::kMaskValue;
    uint32_t vbits = 0;
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + n * 8 + 2 * t + (e & 1);
        float val = s[n][e] * scale;
        if constexpr (kSoftcap) val = softcap * tanhf(val * inv_cap);
        if constexpr (kExtra) {
          const int row = e < 2 ? r_lo : r_hi;
          const bool vis = visible(row, col);
          if (vis) {
            vbits |= 1u << (n * 4 + e);
            if (pair_vec)
              val += nnop::bf16x2_half(pv[n][e >> 1], e & 1);
            else if (pair != nullptr && row < QL)
              val += nnop::load_bf16_or_f32(pair, pair_f32, pair_off + (size_t)row * KL + col);
          }
          val = vis ? val : nnop::kMaskValue;
        } else {
          val = visible(e < 2 ? r_lo : r_hi, col) ? val : nnop::kMaskValue;
        }
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
        bool vis;
        if constexpr (kExtra)
          vis = (vbits >> (n * 4 + e)) & 1u;
        else
          vis = visible(lo ? r_lo : r_hi, col);
        const float p = vis ? __expf(s[n][e] - (lo ? mn_lo : mn_hi)) : 0.f;
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

template <int E, bool kSoftcap, bool kWindow, bool kExtra>
cudaError_t launch_one(dim3 grid, cudaStream_t st, const __nv_bfloat16* q,
                       const __nv_bfloat16* k, const __nv_bfloat16* v, const uint8_t* kpad,
                       const void* pair, const int* qseg, const int* kseg, int pair_f32,
                       __nv_bfloat16* o, float* lse, int QH, int KH, int QL, int KL,
                       float scale, int causal, int offset, int window, float softcap) {
  constexpr int kDynamic = nnop::dynamic_smem_bytes<FwdTiles<E>>;
  static const cudaError_t opt_in = nnop::opt_in_dynamic_smem<FwdTiles<E>>(
      flash_fwd_kernel<E, kSoftcap, kWindow, kExtra>);
  if (opt_in != cudaSuccess) return opt_in;
  flash_fwd_kernel<E, kSoftcap, kWindow, kExtra><<<grid, kThreads, kDynamic, st>>>(
      q, k, v, kpad, pair, qseg, kseg, pair_f32, o, lse, QH, KH, QL, KL, scale, causal,
      offset, window, softcap, kSoftcap ? 1.f / softcap : 0.f);
  return cudaGetLastError();
}

// The instantiation for the features asked for (softcap > 0, window > 0,
// extra: a pair bias or segment ids; the softcap only with segment ids).
template <int E, typename... Args>
cudaError_t launch(float softcap, int window, bool extra, Args... args) {
  if (extra) {
    if (softcap > 0.f)
      return window > 0 ? launch_one<E, true, true, true>(args..., window, softcap)
                        : launch_one<E, true, false, true>(args..., window, softcap);
    return window > 0 ? launch_one<E, false, true, true>(args..., window, softcap)
                      : launch_one<E, false, false, true>(args..., window, softcap);
  }
  if (softcap > 0.f)
    return window > 0 ? launch_one<E, true, true, false>(args..., window, softcap)
                      : launch_one<E, true, false, false>(args..., window, softcap);
  return window > 0 ? launch_one<E, false, true, false>(args..., window, softcap)
                    : launch_one<E, false, false, false>(args..., window, softcap);
}

}  // namespace

// q (B, QH, QL, E), k/v (B, KH, KL, E), o (B, QH, QL, E): bf16, contiguous.
// kpad (B, KL) uint8 or null; pair (B, QH, QL, KL) f32 (pair_f32) or bf16,
// or null; q_seg (B, QL) and kv_seg (B, KL) int32, both or neither; lse
// (B, QH, QL) f32. E is 64, 128 or 256. window > 0 (with causal) keeps the
// last `window` positions; softcap > 0 caps the scores; 0 turns either
// off. The softcap takes no pair.
extern "C" int nnop_flash_fwd(const void* q, const void* k, const void* v, const void* kpad,
                              const void* pair, const void* q_seg, const void* kv_seg, void* o,
                              void* lse, int B, int QH, int KH, int QL, int KL, int E,
                              int pair_f32, float scale, int causal, int offset, int window,
                              float softcap, void* stream) {
  const dim3 grid((QL + kBQ - 1) / kBQ, QH, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool extra = pair != nullptr || q_seg != nullptr;
#define NNOP_FWD_ARGS                                                                      \
  grid, st, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),    \
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(kpad), pair,       \
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), pair_f32,            \
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), QH, KH, QL, KL, scale,      \
      causal, offset
  cudaError_t e;
  switch (E) {
    case 64: e = launch<64>(softcap, window, extra, NNOP_FWD_ARGS); break;
    case 128: e = launch<128>(softcap, window, extra, NNOP_FWD_ARGS); break;
    case 256: e = launch<256>(softcap, window, extra, NNOP_FWD_ARGS); break;
    default: e = cudaErrorInvalidValue;
  }
#undef NNOP_FWD_ARGS
  return static_cast<int>(e);
}

extern "C" const char* nnop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
