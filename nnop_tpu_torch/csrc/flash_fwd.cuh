// Flash-attention forward for Hopper (sm_90a), kernel C: o and the row
// log-sum-exp (nats) of softmax(scale q k^T [softcap] [+ pair], masked) v.
//
// Replaces nnop_tpu/ops/flash_attention.py:_fwd_impl (pallas_call at
// :1309) and every kernel it dispatches to on the TPU (_fwd_rect_static
// :536, _fwd_causal_multicall :621, _fwd_causal_gstrips :795, _strip_call
// :833 via _fwd_causal_window and _fwd_causal_chunked): one kernel serves
// bucketed prefill (causal), chunked prefill (causal from a row offset,
// with a key-padding mask), the sliding window, the score softcap, and the
// pair bias and segment ids of packed documents, at head dims 64, 128 and
// 256 (the sources flash_fwd_e{64,128,256}.cu instantiate one head dim
// each, so nvcc builds them in parallel).
//
// What bounds it on the H100: at prefill and training shapes the work is
// ~4 * E flops per visible (row, key) pair against ~(2 QL + 2 KL) * E
// bytes per head, far above the card's ~295 flop/byte ridge, so it is
// bound by the tensor cores; only the pair bias (2 or 4 bytes per pair)
// is bound by memory. The tensor cores reach their rate only through
// wgmma fed from shared memory while the next tiles arrive, and the
// softmax between the two products (an exp per score, on the SFU's much
// lower rate) has to overlap them.
//
// The design. A block owns 128 query rows of one (batch, head): a
// producer warp and two consumer warpgroups of 64 rows each (setmaxnreg
// moves the producer's registers to the consumers: a 64 x 256 f32 output
// accumulator alone is 128 registers a thread). The producer loads the
// block's Q once and then each key tile's K and V (and the block's
// pair-bias box) by TMA into a ring of kStages slots tracked by mbarriers
// (full: the bytes landed; empty: all 8 consumer warps are done with the
// slot), so loads run ahead of the math. Q, K and V land as
// 128-byte-swizzled boxes (E / 64 boxes of 64 columns a tile), which
// wgmma reads without bank conflicts: S = Q K^T takes both K-major from
// shared memory; O += P V takes P from registers (the S accumulator
// fragment packed to bf16 pairs is the A fragment) and V MN-major (the
// transpose flag), so no transposed copy is made. K and V are described
// to TMA as 3-D tensors (E, KL, B * KH), so a tile past KL zero-fills
// instead of reading the next head's rows. TMA wants a box's first byte
// on 16 bytes, which rows of KL kpad bytes or segment ids need not be:
// the producer stages those through its own loads, and a pair whose rows
// are not 16-byte multiples is read by the consumers from global memory.
// The two warpgroups run the same loop and interleave on the SM (one's
// softmax beside the other's products; issuing the next tile's S before
// the softmax, inside one warpgroup, measured no faster). The softmax is
// the parent kernel's arithmetic on the parent's 64-key tiles (scores in
// nats, __expf, the same order of sums), and wgmma sums each 16-deep step
// as mma.sync did, so at head dims 64 and 128 without the softcap (whose
// tanh is now one on the special-function unit) o and lse are the parent
// kernel's bits: the redesign moves data and issues products differently
// and changes no served number of Llama or Mixtral.
//
// The schedule. The key range is a loop bound: tiles past the block's last
// causal position and (with a window) wholly before its first row's window
// are never loaded, and the producer hands each slot's tile index to the
// consumers, so it alone decides the schedule: with segment ids it skips
// every key tile whose [min, max] of kv_seg misses the block's [min, max]
// of q_seg (exact for any ids, sorted or not: disjoint ranges share no
// value; a loaded tile still masks each score). With each index go two
// flags, whether the tile needs the kpad test and the segment test, so a
// tile all visible runs neither. Causal blocks start longest first: the
// grid is (B * QH, row blocks) with the row block reversed, so every
// head's longest blocks lead the launch. A call with at most half the
// card's SMs in blocks (Gemma-2's serving chunk: 8 heads x 512 rows, 32
// blocks) runs blocks of 64 rows, twice as many, whose second warpgroup
// has no row: each warpgroup then has an SM's tensor cores to itself, and
// every row computes exactly as it would in a block of 128 (splitting a
// block's key tiles between its warpgroups, merged at the end, was faster
// at that row, but moved the served logits enough to fail phase 14e's
// logprob gate). A tile is masked per score only where it
// needs it (the diagonal, the window's edge, past KL, a flagged tile); the
// softcap, the window and the extra terms (pair bias and segment ids, each
// nullable inside it) are template flags, so a featureless call runs no
// test for them.
//
// Scores: s = scale * q.k, then with a softcap c, s = c * tanh(s / c),
// then + pair[b, h, i, j] in f32 (the softcap and the pair never meet),
// BEFORE any mask (nnop_tpu/ops/flash_attention.py:119-124); lse is in
// nats.
// Masking: key j is visible to query row i (at position pos = i + offset)
// when j < KL, kpad[b, j] (if given), q_seg[b, i] == kv_seg[b, j] (if
// given) and, if causal, j <= pos and, with a window w, pos - j < w.
// Masked scores take kMaskValue and their probabilities are exact zeros;
// a row with no visible key writes zeros and lse = kMaskValue, never NaN.
// P is rounded to bf16 for the PV product (as the TPU kernel's p.astype).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace nnop_fwd {

constexpr int kBM = 128;       // query rows a block: two consumer warpgroups of 64
constexpr int kThreads = 384;  // the producer warpgroup (one warp works) and the consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 * 40 + 256 * 232 <= 65536
constexpr int kSmemLimit = 232448;                      // a block's shared memory on the H100

// The tile shapes and the shared-memory layout. Key tiles are 64 wide (32
// at head dim 256 with the extra terms, so the pair-bias box of a slot,
// 128 rows x kBN with room for f32, fits beside K and V): below head dim
// 256 the parent kernel's tiles, so the online softmax moves its max at
// the same keys and a row keeps the parent's bits (phase 9a's W8A8 expert
// routing turns a few changed bf16 roundings into first-token cosines
// past its gate; 128-key tiles read 0.839 ms against 0.890 at the 8B
// training geometry). As many slots as fit, up to 4.
template <int E, bool kExtra>
struct Cfg {
  static constexpr int kBN = E == 256 && kExtra ? 32 : 64;
  static constexpr int kChunks = E / 64;          // 64-column (128-byte) swizzled boxes
  static constexpr int kQBytes = kBM * E * 2;
  static constexpr int kKVBytes = kBN * E * 2;    // one K or V tile
  static constexpr int kPairBytes = kExtra ? kBM * kBN * 4 : 0;
  static constexpr int kSegBytes = kExtra ? kBN * 4 : 0;  // the tile's kv_seg
  static constexpr int kPadBytes = kBN;                    // the tile's kpad bytes
  static constexpr int kStageBytes = 2 * kKVBytes + kPairBytes + kSegBytes + kPadBytes;
  static constexpr int kFit = (kSmemLimit - 1024 - 256 - kQBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffPair = kOffV + kStages * kKVBytes;
  static constexpr int kOffSeg = kOffPair + kStages * kPairBytes;
  static constexpr int kOffPad = kOffSeg + kStages * kSegBytes;
  static constexpr int kOffBar = (kOffPad + kStages * kPadBytes + 15) / 16 * 16;
  // full[kStages], empty[kStages], the Q barrier, then each slot's tile index
  static constexpr int kSmem = 1024 + kOffBar + (2 * kStages + 1) * 8 + kStages * 4;
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "the ring does not fit");
};

// The kernel's arguments: the tensor maps (encoded per call on the host)
// and what the consumers read directly.
struct Params {
  CUtensorMap tq, tk, tv;  // 3-D (E, L, B * heads) bf16, 128-byte swizzle, boxes 64 x rows
  CUtensorMap tpair;       // 2-D (KL, B * QH * QL), boxes kBN x 128 rows (pair_tma)
  const uint8_t* kpad;     // (B, KL) or null
  const void* pair;        // (B, QH, QL, KL) bf16 or f32 (pair_f32), or null
  const int* qseg;         // (B, QL) int32, or null: no segment ids
  const int* kseg;         // (B, KL) int32, with qseg
  __nv_bfloat16* o;        // (B, QH, QL, E)
  float* lse;              // (B, QH, QL)
  int pair_f32;
  int pair_tma;  // the pair's rows are 16-byte multiples: TMA boxes; else direct loads
  int rows;      // query rows a block: 128, or 64 (the second warpgroup idle) for few blocks
  int QH, KH, QL, KL, causal, offset, window;
  float scale, softcap, inv_cap;  // inv_cap = 1 / softcap
};

// Raw operands, as the C entry takes them.
struct Args {
  const void *q, *k, *v, *kpad, *pair, *qseg, *kseg;
  void *o, *lse;
  int B, QH, KH, QL, KL, pair_f32, causal, offset, window;
  float scale, softcap;
  cudaStream_t stream;
};

template <int E>
cudaError_t launch(const Args& a);

// A slot's tile index, with two flags: the tile needs the kpad test, the
// segment-id test (no flag: every key passes it).
constexpr int kSlotKpad = 29, kSlotSeg = 30, kSlotTile = (1 << kSlotKpad) - 1;

// The producer warp: Q, then every live key tile's slot, then a slot
// holding -1 that ends the consumers' loop.
template <int E, bool kExtra>
__device__ __forceinline__ void produce(const Params& p, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, uint64_t* qbar, int* slot_tile,
                                        int b, int bh, int kh, int row0, int j_lo, int j_hi) {
  using C = Cfg<E, kExtra>;
  constexpr int kBN = C::kBN;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    nnop::mbar_arrive_tx(qbar, C::kQBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      nnop::tma_load_3d(smem + c * kBM * 128, &p.tq, qbar, c * 64, row0, bh);
  }
  const bool segs = kExtra && p.qseg != nullptr;
  const int n_rows = min(p.rows, p.QL - row0);
  // the block's [min, max] of q_seg
  int q_lo = INT_MAX, q_hi = INT_MIN;
  if (segs) {
    for (int r = row0 + lane; r < row0 + n_rows; r += 32) {
      const int s = p.qseg[(size_t)b * p.QL + r];
      q_lo = min(q_lo, s), q_hi = max(q_hi, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      q_lo = min(q_lo, __shfl_xor_sync(0xffffffffu, q_lo, off));
      q_hi = max(q_hi, __shfl_xor_sync(0xffffffffu, q_hi, off));
    }
  }
  const bool pair_tma = kExtra && p.pair != nullptr && p.pair_tma;
  const uint32_t tx = 2 * C::kKVBytes + (pair_tma ? kBM * kBN * (p.pair_f32 ? 4 : 2) : 0);
  constexpr int kPer = kBN / 32;  // kpad bytes and segment ids a lane stages per tile
  int stage = 0;
  uint32_t phase = 0;
  for (int base = j_lo; base < j_hi; base += 32) {  // 32 tiles at a time, one a lane
    const int jl = base + lane;
    bool live = jl < j_hi;
    int k_lo = INT_MAX, k_hi = INT_MIN;
    if (segs && live) {  // the tile's [min, max] of kv_seg against the block's
      const int c0 = jl * kBN, c1 = min(c0 + kBN, p.KL);
      const int* ks = p.kseg + (size_t)b * p.KL;
#pragma unroll 8
      for (int c = c0; c < c1; ++c) {
        const int s = ks[c];
        k_lo = min(k_lo, s), k_hi = max(k_hi, s);
      }
      live = k_lo <= q_hi && k_hi >= q_lo;
    }
    uint32_t todo = __ballot_sync(0xffffffffu, live);
    while (todo != 0) {
      const int idx = __ffs(todo) - 1, j = base + idx;
      todo &= todo - 1;
      const int c0 = j * kBN;
      // a tile all in the block's one document needs no segment test
      const int t_lo = __shfl_sync(0xffffffffu, k_lo, idx);
      const int t_hi = __shfl_sync(0xffffffffu, k_hi, idx);
      const bool seg_test = segs && !(q_lo == q_hi && t_lo == q_lo && t_hi == q_lo);
      // the tile's kpad bytes and segment ids go through registers (their
      // rows need not start on the 16 bytes TMA needs), read before the
      // slot frees up
      uint32_t kp[kPer], kv[kPer];
      bool kp_all = true;  // every key of the tile below KL passes kpad
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int col = c0 + i * 32 + lane;
        kp[i] = p.kpad != nullptr && col < p.KL ? p.kpad[(size_t)b * p.KL + col] : 0u;
        kv[i] = segs && col < p.KL ? p.kseg[(size_t)b * p.KL + col] : 0;
        kp_all = kp_all && (kp[i] != 0 || col >= p.KL);
      }
      const bool kp_test = p.kpad != nullptr && !__all_sync(0xffffffffu, kp_all);
      if (lane == 0) nnop::mbar_wait(&empty[stage], phase ^ 1);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (p.kpad != nullptr) smem[C::kOffPad + stage * C::kPadBytes + i * 32 + lane] = kp[i];
        if (segs)
          reinterpret_cast<int*>(smem + C::kOffSeg + stage * C::kSegBytes)[i * 32 + lane] = kv[i];
      }
      __syncwarp();  // the stores above happen before lane 0's arrival releases the slot
      if (lane == 0) {
        slot_tile[stage] = j | kp_test << kSlotKpad | seg_test << kSlotSeg;
        nnop::mbar_arrive_tx(&full[stage], tx);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          nnop::tma_load_3d(smem + C::kOffK + stage * C::kKVBytes + c * kBN * 128, &p.tk,
                            &full[stage], c * 64, c0, b * p.KH + kh);
          nnop::tma_load_3d(smem + C::kOffV + stage * C::kKVBytes + c * kBN * 128, &p.tv,
                            &full[stage], c * 64, c0, b * p.KH + kh);
        }
        if (pair_tma)
          nnop::tma_load_2d(smem + C::kOffPair + stage * C::kPairBytes, &p.tpair, &full[stage],
                            c0, bh * p.QL + row0);
      }
      if (++stage == C::kStages) stage = 0, phase ^= 1;
    }
  }
  if (lane == 0) {
    nnop::mbar_wait(&empty[stage], phase ^ 1);
    slot_tile[stage] = -1;
    nnop::mbar_arrive(&full[stage]);
  }
}

// A consumer warpgroup's 64 rows: scores, online softmax, output.
template <int E, bool kSoftcap, bool kWindow, bool kExtra>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, uint64_t* qbar, const int* slot_tile,
                                        int b, int bh, int row0) {
  using C = Cfg<E, kExtra>;
  constexpr int kBN = C::kBN;
  constexpr int kS = kBN / 2;  // score accumulators a thread
  constexpr int kO = E / 2;    // output accumulators a thread
  const int t = threadIdx.x - 128;
  const int wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wr0 = row0 + wg * 64;                          // this warpgroup's first row
  const int wr_last = min(wr0 + 64, min(row0 + p.rows, p.QL)) - 1;  // < wr0: it has none
  const int r_lo = wr0 + warp * 16 + g, r_hi = r_lo + 8;  // this thread's two rows
  const int rl_lo = r_lo - row0;                  // r_lo within the block
  const bool segs = kExtra && p.qseg != nullptr;
  const bool pair = kExtra && p.pair != nullptr;
  int qs_lo = 0, qs_hi = 0;
  if (segs) {
    if (r_lo < p.QL) qs_lo = p.qseg[(size_t)b * p.QL + r_lo];
    if (r_hi < p.QL) qs_hi = p.qseg[(size_t)b * p.QL + r_hi];
  }
  const int pos_lo = r_lo + p.offset, pos_hi = r_hi + p.offset;

  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m_lo = nnop::kMaskValue, m_hi = nnop::kMaskValue, l_lo = 0.f, l_hi = 0.f;
  const __nv_bfloat16* q_s = reinterpret_cast<const __nv_bfloat16*>(smem) + wg * 64 * 64;
  nnop::mbar_wait(qbar, 0);

  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    nnop::mbar_wait(&full[stage], phase);
    const int slot = slot_tile[stage];
    if (slot < 0) break;
    const int c0 = (slot & kSlotTile) * kBN;
    const bool kp_test = slot >> kSlotKpad & 1, seg_test = kExtra && (slot >> kSlotSeg & 1);
    // a warpgroup with no rows, or whose rows all precede the tile or (with
    // a window) all come a window past it, skips it
    const bool skip = wr_last < wr0 || (p.causal && c0 > wr_last + p.offset) ||
                      (kWindow && c0 + kBN <= wr0 + p.offset - p.window + 1);
    if (!skip) {
      const __nv_bfloat16* k_s =
          reinterpret_cast<const __nv_bfloat16*>(smem + C::kOffK + stage * C::kKVBytes);
      const __nv_bfloat16* v_s =
          reinterpret_cast<const __nv_bfloat16*>(smem + C::kOffV + stage * C::kKVBytes);
      float s[kS];
#pragma unroll
      for (int i = 0; i < kS; ++i) s[i] = 0.f;
      nnop::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < E / 16; ++ks) {  // 16-deep steps: 4 in each 64-column box
        const int c = ks / 4, w = ks % 4;
        nnop::wgmma_ss<kBN>(s, nnop::sw128_desc(q_s + c * kBM * 64 + w * 16, 16),
                            nnop::sw128_desc(k_s + c * kBN * 64 + w * 16, 16), ks > 0);
      }
      nnop::wgmma_commit();
      nnop::wgmma_wait_all();
      nnop::fence_regs<kS>(s);

      // scores: scale (and cap), the pair, the mask
      const bool need_mask = c0 + kBN > p.KL || kp_test || seg_test ||
                             (p.causal && c0 + kBN - 1 > wr0 + p.offset) ||
                             (kWindow && wr_last + p.offset - c0 >= p.window);
      // each row's visible keys, as offsets from this thread's first column
      // (cl = n * 8 + 2 * tq below): [lo, hi] from KL, the diagonal, the window
      int hi_lo = p.KL - 1 - c0 - 2 * tq, hi_hi = hi_lo, lo_lo = INT_MIN, lo_hi = INT_MIN;
      if (p.causal) {
        hi_lo = min(hi_lo, pos_lo - c0 - 2 * tq), hi_hi = min(hi_hi, pos_hi - c0 - 2 * tq);
        if (kWindow)
          lo_lo = pos_lo - p.window + 1 - c0 - 2 * tq, lo_hi = pos_hi - p.window + 1 - c0 - 2 * tq;
      }
      const unsigned char* pair_s = smem + C::kOffPair + stage * C::kPairBytes;
      const uint8_t* kpad_s = smem + C::kOffPad + stage * C::kPadBytes;
      const int* kseg_s = reinterpret_cast<const int*>(smem + C::kOffSeg + stage * C::kSegBytes);
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        const int cl = n * 8 + 2 * tq;  // this thread's first column in the tile
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
        if (pair && p.pair_tma) {  // the slot's box: 128 rows of kBN
          if (p.pair_f32) {
            const float2 a = *reinterpret_cast<const float2*>(pair_s + (rl_lo * kBN + cl) * 4);
            const float2 c =
                *reinterpret_cast<const float2*>(pair_s + ((rl_lo + 8) * kBN + cl) * 4);
            pv[0] = a.x, pv[1] = a.y, pv[2] = c.x, pv[3] = c.y;
          } else {
            const uint32_t a =
                *reinterpret_cast<const uint32_t*>(pair_s + (rl_lo * kBN + cl) * 2);
            const uint32_t c =
                *reinterpret_cast<const uint32_t*>(pair_s + ((rl_lo + 8) * kBN + cl) * 2);
            pv[0] = nnop::bf16x2_half(a, 0), pv[1] = nnop::bf16x2_half(a, 1);
            pv[2] = nnop::bf16x2_half(c, 0), pv[3] = nnop::bf16x2_half(c, 1);
          }
        } else if (pair) {  // rows off the 16 bytes TMA needs: each value from global memory
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? r_lo : r_hi, col = c0 + cl + (e & 1);
            if (row < p.QL && col < p.KL)
              pv[e] = nnop::load_bf16_or_f32(p.pair, p.pair_f32,
                                             ((size_t)bh * p.QL + row) * p.KL + col);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n * 4 + e];
          x *= p.scale;
          if constexpr (kSoftcap) x = p.softcap * nnop::tanh_fast(x * p.inv_cap);
          if (kExtra) x += pv[e];
          if (need_mask) {
            const int c = n * 8 + (e & 1);  // the column, less 2 * tq
            bool vis = c <= (e < 2 ? hi_lo : hi_hi);
            if (kWindow) vis = vis && c >= (e < 2 ? lo_lo : lo_hi);
            if (kp_test) vis = vis && kpad_s[cl + (e & 1)] != 0;
            if (seg_test) vis = vis && kseg_s[cl + (e & 1)] == (e < 2 ? qs_lo : qs_hi);
            x = vis ? x : nnop::kMaskValue;
          }
          s[n * 4 + e] = x;
        }
      }

      // online softmax: the row max over the quad of lanes sharing a row
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[n * 4], s[n * 4 + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[n * 4 + 2], s[n * 4 + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      // a row that has seen no visible key keeps kMaskValue as its max; its
      // masked scores must still give exact zeros, so they are taken from 0
      const float sub_lo = mx_lo == nnop::kMaskValue ? 0.f : mx_lo;
      const float sub_hi = mx_hi == nnop::kMaskValue ? 0.f : mx_hi;
      const float a_lo = __expf(m_lo - mx_lo), a_hi = __expf(m_hi - mx_hi);
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n * 4 + e] = __expf(s[n * 4 + e] - (e < 2 ? sub_lo : sub_hi));
          if (e < 2) sum_lo += s[n * 4 + e]; else sum_hi += s[n * 4 + e];
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
        sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
      }
      l_lo = l_lo * a_lo + sum_lo;
      l_hi = l_hi * a_hi + sum_hi;
      m_lo = mx_lo;
      m_hi = mx_hi;
      // the output moves to the new max only where some row's max moved (a
      // factor of exactly 1 changes no bit, so a warp may skip the pass)
      if (__any_sync(0xffffffffu, a_lo != 1.f || a_hi != 1.f)) {
#pragma unroll
        for (int n = 0; n < E / 8; ++n) {
          o[n * 4] *= a_lo, o[n * 4 + 1] *= a_lo;
          o[n * 4 + 2] *= a_hi, o[n * 4 + 3] *= a_hi;
        }
      }

      // O += P V: two adjacent 8-key accumulator groups are the A fragment
      // of one 16-key step (P rounded to bf16)
      uint32_t pa[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        pa[kk][0] = nnop::pack_bf16x2(s[kk * 8], s[kk * 8 + 1]);
        pa[kk][1] = nnop::pack_bf16x2(s[kk * 8 + 2], s[kk * 8 + 3]);
        pa[kk][2] = nnop::pack_bf16x2(s[kk * 8 + 4], s[kk * 8 + 5]);
        pa[kk][3] = nnop::pack_bf16x2(s[kk * 8 + 6], s[kk * 8 + 7]);
      }
      nnop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        nnop::wgmma_rs<E>(o, pa[kk], nnop::sw128_desc(v_s + kk * 16 * 64, kBN * 128));
      nnop::wgmma_commit();
      nnop::wgmma_wait_all();
      nnop::fence_regs<kO>(o);
    }
    __syncwarp();
    if (lane == 0) nnop::mbar_arrive(&empty[stage]);
    if (++stage == C::kStages) stage = 0, phase ^= 1;
  }

  // o / l and lse of this warpgroup's rows (none past QL or the block's end)
  const float inv_lo = l_lo == 0.f ? 0.f : 1.f / l_lo, inv_hi = l_hi == 0.f ? 0.f : 1.f / l_hi;
  __nv_bfloat16* ob = p.o + (size_t)bh * p.QL * E;
#pragma unroll
  for (int n = 0; n < E / 8; ++n) {
    const int col = n * 8 + 2 * tq;
    if (r_lo <= wr_last)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r_lo * E + col) =
          nnop::pack_bf16x2(o[n * 4] * inv_lo, o[n * 4 + 1] * inv_lo);
    if (r_hi <= wr_last)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r_hi * E + col) =
          nnop::pack_bf16x2(o[n * 4 + 2] * inv_hi, o[n * 4 + 3] * inv_hi);
  }
  if (tq == 0) {
    float* lb = p.lse + (size_t)bh * p.QL;
    if (r_lo <= wr_last) lb[r_lo] = m_lo + logf(l_lo == 0.f ? 1.f : l_lo);
    if (r_hi <= wr_last) lb[r_hi] = m_hi + logf(l_hi == 0.f ? 1.f : l_hi);
  }
}

template <int E, bool kSoftcap, bool kWindow, bool kExtra>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const __grid_constant__ Params p) {
  using C = Cfg<E, kExtra>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;
  int* slot_tile = reinterpret_cast<int*>(qbar + 1);

  const int iq = gridDim.y - 1 - blockIdx.y;  // the longest causal blocks first
  const int bh = blockIdx.x, b = bh / p.QH, kh = (bh % p.QH) / (p.QH / p.KH);
  const int row0 = iq * p.rows;
  // key tiles [j_lo, j_hi): up to the block's last causal position, from
  // its first row's window
  int j_hi = (p.KL + C::kBN - 1) / C::kBN, j_lo = 0;
  if (p.causal) {
    j_hi = min(j_hi, (min(row0 + p.rows, p.QL) - 1 + p.offset) / C::kBN + 1);
    if (kWindow) j_lo = max(0, row0 + p.offset + 1 - p.window) / C::kBN;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      nnop::mbar_init(&full[s], 1);
      nnop::mbar_init(&empty[s], 8);  // each consumer warp arrives
    }
    nnop::mbar_init(qbar, 1);
    nnop::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    nnop::regs_dealloc<kProducerRegs>();
    if (threadIdx.x < 32)
      produce<E, kExtra>(p, smem, full, empty, qbar, slot_tile, b, bh, kh, row0, j_lo, j_hi);
  } else {
    nnop::regs_alloc<kConsumerRegs>();
    consume<E, kSoftcap, kWindow, kExtra>(p, smem, full, empty, qbar, slot_tile, b, bh, row0);
  }
}

template <int E, bool kSoftcap, bool kWindow, bool kExtra>
cudaError_t launch_one(const Params& p, dim3 grid, cudaStream_t st) {
  constexpr int kSmem = Cfg<E, kExtra>::kSmem;
  auto* kernel = flash_fwd_kernel<E, kSoftcap, kWindow, kExtra>;
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (opt_in != cudaSuccess) return opt_in;
  kernel<<<grid, kThreads, kSmem, st>>>(p);
  return cudaGetLastError();
}

// The tensor maps for this call's tiles, then the instantiation for the
// features asked for.
template <int E, bool kExtra>
cudaError_t launch_tiles(const Args& a) {
  using C = Cfg<E, kExtra>;
  Params p{};
  const cuuint64_t B = a.B, QH = a.QH, KH = a.KH, QL = a.QL, KL = a.KL, El = E;
  bool ok = true;
  {
    const cuuint64_t dims[3] = {El, QL, B * QH}, strides[2] = {El * 2, QL * El * 2};
    const cuuint32_t box[3] = {64, kBM, 1};
    ok &= nnop_host::encode(&p.tq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.q, dims, strides, box,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  }
  const cuuint64_t pair_elt = a.pair_f32 ? 4 : 2;
  p.pair_tma = a.pair != nullptr && KL * pair_elt % 16 == 0;
  if (KL > 0) {  // with no key there is no tile to load
    const cuuint64_t dims[3] = {El, KL, B * KH}, strides[2] = {El * 2, KL * El * 2};
    const cuuint32_t box[3] = {64, C::kBN, 1};
    ok &= nnop_host::encode(&p.tk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.k, dims, strides, box,
                            CU_TENSOR_MAP_SWIZZLE_128B);
    ok &= nnop_host::encode(&p.tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.v, dims, strides, box,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (p.pair_tma) {
    const cuuint64_t dims[2] = {KL, B * QH * QL}, strides[1] = {KL * pair_elt};
    const cuuint32_t box[2] = {C::kBN, kBM};
    ok &= nnop_host::encode(&p.tpair, a.pair_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            2, a.pair, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!ok) return cudaErrorInvalidValue;
  p.kpad = static_cast<const uint8_t*>(a.kpad);
  p.pair = a.pair;
  p.qseg = static_cast<const int*>(a.qseg);
  p.kseg = static_cast<const int*>(a.kseg);
  p.o = static_cast<__nv_bfloat16*>(a.o);
  p.lse = static_cast<float*>(a.lse);
  p.pair_f32 = a.pair_f32;
  p.QH = a.QH, p.KH = a.KH, p.QL = a.QL, p.KL = a.KL;
  p.causal = a.causal, p.offset = a.offset, p.window = a.window;
  p.scale = a.scale, p.softcap = a.softcap;
  p.inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;
  // a call of few blocks (at most half the card's SMs) runs blocks of 64
  // rows, twice as many, each warpgroup on an SM of its own
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return cudaErrorInvalidDevice;
  p.rows = int64_t(a.B) * a.QH * ((a.QL + kBM - 1) / kBM) * 2 <= sms ? 64 : kBM;
  const dim3 grid(a.B * a.QH, (a.QL + p.rows - 1) / p.rows);
  const bool cap = a.softcap > 0.f, win = a.window > 0;
  if (cap)
    return win ? launch_one<E, true, true, kExtra>(p, grid, a.stream)
               : launch_one<E, true, false, kExtra>(p, grid, a.stream);
  return win ? launch_one<E, false, true, kExtra>(p, grid, a.stream)
             : launch_one<E, false, false, kExtra>(p, grid, a.stream);
}

// extra: a pair bias or segment ids
template <int E>
cudaError_t launch(const Args& a) {
  return a.pair != nullptr || a.qseg != nullptr ? launch_tiles<E, true>(a)
                                                : launch_tiles<E, false>(a);
}

}  // namespace nnop_fwd
