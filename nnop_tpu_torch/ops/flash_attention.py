"""Flash attention forward: the public API over one CUDA kernel for Hopper.

`flash_fwd` wraps csrc/flash_fwd.cu, which replaces
nnop_tpu/ops/flash_attention.py:_fwd_impl and the TPU dispatch zoo under
it (the rect, causal-strip, rect-static, window and chunked kernels): one
FA-2 kernel serves causal bucketed prefill and chunked prefill (causal
from a row offset with a key-padding mask), with the sliding window, the
score softcap, and the pair bias and segment ids (packed documents). See
the kernel source for what bounds it and how. The launches with a window
and with a softcap are counted apart (`flash_fwd.window_launches`,
`.softcap_launches`) beside `launches`, `flash_fwd.mode_launches` counts
them by (head dim, window, softcap), and `.pair_launches` and
`.segment_launches` count the launches with a pair and with segment ids.

Layouts are the JAX package's: q (B, QH, QL, E), k/v (B, KH, KL, E),
kpad_mask (B, KL) with True = valid, pair (B, QH, QL, KL) (bf16 or f32
on the card), segment_ids ((B, QL), (B, KL)) ints. GQA: query head h
reads KV head h // (QH // KH). The kernel takes bf16 and head dim 64, 128
or 256; `flash_attention` and `flash_attention_chunked` zero-pad any
other head dim up to the next of them on the card (the JAX op's padding,
nnop_tpu/ops/flash_attention.py:1471-1483), and round f32 q, k and v to
bf16 at the op boundary (in the backward, the f32 output gradient too):
the kernels run on the bf16 operands, as the TPU's f32 dots at default
precision run as bf16 passes, and o and the gradients come back in f32.
That is the kernels' own path, not a fallback: no plain version runs on
a CUDA tensor. The softcap takes no pair (as in JAX).

`flash_attention` is differentiable through a `torch.autograd.Function`
(the JAX custom VJP, nnop_tpu/ops/flash_attention.py:1350-1379): its
forward is kernel C, which saves q, k, v, o, lse, the pair, kpad_mask and
the segment ids (and keeps the window and the softcap), and its backward
the dQ and dK/dV kernels (ops/flash_attention_bwd.py) in the same modes,
which return dpair as the pair's gradient. `flash_attention_chunked`
stays forward-only, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nnop_tpu_torch.ops.naive import naive_attention
from nnop_tpu_torch.utils.build import check_launch, load_library
from nnop_tpu_torch.utils.platform import check_cuda_operand

_PAIR_DTYPES = (torch.bfloat16, torch.float32)


def _validate(q, k, v, pair, kpad_mask):
    """Shape-contract errors (nnop_tpu/ops/flash_attention.py:_validate)."""
    if q.shape[-1] != k.shape[-1]:
        raise ValueError(f"q head dim {q.shape[-1]} != k head dim {k.shape[-1]}")
    if k.shape != v.shape:
        raise ValueError(f"k shape {tuple(k.shape)} != v shape {tuple(v.shape)}")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")
    if q.shape[0] != k.shape[0]:
        raise ValueError(f"batch mismatch {q.shape[0]} vs {k.shape[0]}")
    if pair is not None:
        expect = (q.shape[0], q.shape[1], q.shape[2], k.shape[2])
        if tuple(pair.shape) != expect:
            raise ValueError(f"pair shape {tuple(pair.shape)}, expected {expect}")
    if kpad_mask is not None:
        expect = (k.shape[0], k.shape[2])
        if tuple(kpad_mask.shape) != expect:
            raise ValueError(f"kpad_mask shape {tuple(kpad_mask.shape)}, expected {expect}")


def kernel_head_dim(E: int) -> int:
    """The head dim the kernels (forward and backward) run E at on the
    card: the next of 64, 128 and 256. Raises ValueError past 256."""
    for d in (64, 128, 256):
        if E <= d:
            return d
    raise ValueError(f"head dim {E} > 256, the largest the kernels take")


def pad_head_dim(fn, q, k, v, Ep: int):
    """fn(q, k, v) on q, k, v zero-padded to head dim Ep, the output sliced
    back to the true head dim: the zero lanes add 0 to every score and
    give zero output lanes (nnop_tpu/ops/flash_attention.py:1471-1483).
    The caller's scale must come from the true head dim; gradients flow
    through the pad and the slice."""
    E = q.shape[-1]
    q, k, v = (F.pad(t, (0, Ep - E)) for t in (q, k, v))
    return fn(q, k, v)[..., :E]


def _has_f32(*ts):
    return any(t.dtype == torch.float32 for t in ts)


def round_to_bf16(fn, q, k, v):
    """fn(q, k, v) on q, k, v rounded to bf16 (the kernels' operand type),
    the output cast back to q's dtype; through autograd the casts round
    the output gradient to bf16 and return the gradients in f32."""
    return fn(*(t.to(torch.bfloat16) for t in (q, k, v))).to(q.dtype)


def _segments(segment_ids, q, k):
    """Segment ids as the kernels take them: int32, contiguous, on q's
    device, of shapes (B, QL) and (B, KL)."""
    q_seg, kv_seg = (t.to(device=q.device, dtype=torch.int32).contiguous()
                     for t in segment_ids)
    for name, t, n in (("q", q_seg, q.shape[2]), ("kv", kv_seg, k.shape[2])):
        if tuple(t.shape) != (q.shape[0], n):
            raise ValueError(f"{name} segment ids shape {tuple(t.shape)}, expected "
                             f"{(q.shape[0], n)}")
    return q_seg, kv_seg


def count_launch(fn, E, pair, segment_ids, window, softcap):
    """One launch of an attention kernel (C, dQ or dK/dV) on fn's counters."""
    fn.launches += 1
    fn.pair_launches += pair is not None
    fn.segment_launches += segment_ids is not None
    fn.window_launches += window is not None
    fn.softcap_launches += softcap is not None
    mode = (E, window is not None, softcap is not None)
    fn.mode_launches[mode] = fn.mode_launches.get(mode, 0) + 1


def init_counters(fn):
    for name in ("launches", "pair_launches", "segment_launches", "window_launches",
                 "softcap_launches"):
        setattr(fn, name, 0)
    fn.mode_launches = {}


@torch.no_grad()
def flash_fwd(q, k, v, *, causal: bool, scale: float, causal_offset: int = 0,
              kpad_mask=None, pair=None, segment_ids=None,
              window: int | None = None, softcap: float | None = None):
    """Attention forward -> (o (B, QH, QL, E) in q.dtype, lse (B, QH, QL)
    f32 in nats). Query row i sits at global position causal_offset + i.
    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    if q.device.type == "cpu":
        return naive_attention(
            q, k, v, pair, causal=causal, causal_offset=causal_offset,
            kpad_mask=kpad_mask, segment_ids=segment_ids, scale=scale,
            window=window, softcap=softcap, return_lse=True,
        )
    B, QH, QL, E = q.shape
    KH, KL = k.shape[1], k.shape[2]
    if E not in (64, 128, 256):
        raise ValueError(f"head dim {E} not supported by the kernel (64, 128 or 256)")
    if causal_offset < 0:
        raise ValueError(f"causal_offset must be >= 0, got {causal_offset}")
    if window is not None and (not causal or window < 1):
        raise ValueError(f"window {window} needs causal=True and window >= 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if softcap is not None and pair is not None:
        raise ValueError("softcap is incompatible with pair bias")
    check_cuda_operand("q", q, (torch.bfloat16,))
    check_cuda_operand("k", k, (torch.bfloat16,), device=q.device)
    check_cuda_operand("v", v, (torch.bfloat16,), device=q.device)
    if kpad_mask is not None:
        check_cuda_operand("kpad_mask", kpad_mask, (torch.bool,), device=q.device)
    if pair is not None:
        check_cuda_operand("pair", pair, _PAIR_DTYPES, device=q.device)
        if tuple(pair.shape) != (B, QH, QL, KL):
            raise ValueError(f"pair shape {tuple(pair.shape)}, expected {(B, QH, QL, KL)}")
    q_seg, kv_seg = _segments(segment_ids, q, k) if segment_ids is not None else (None, None)
    o = torch.empty_like(q)
    lse = torch.empty((B, QH, QL), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = load_library().nnop_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(kpad_mask), ptr(pair), ptr(q_seg),
        ptr(kv_seg), o.data_ptr(), lse.data_ptr(), B, QH, KH, QL, KL, E,
        int(pair is not None and pair.dtype == torch.float32), float(scale), int(causal),
        int(causal_offset), int(window or 0), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch("flash_fwd", err)
    count_launch(flash_fwd, E, pair, segment_ids, window, softcap)
    return o, lse


init_counters(flash_fwd)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pair, kpad_mask, q_seg, kv_seg, causal, scale, window, softcap):
        segment_ids = (q_seg, kv_seg) if q_seg is not None else None
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale, kpad_mask=kpad_mask,
                           pair=pair, segment_ids=segment_ids, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse, pair, kpad_mask, q_seg, kv_seg)
        ctx.causal, ctx.scale, ctx.window, ctx.softcap = causal, scale, window, softcap
        return o

    @staticmethod
    def backward(ctx, do):
        from nnop_tpu_torch.ops.flash_attention_bwd import flash_attention_bwd

        q, k, v, o, lse, pair, kpad_mask, q_seg, kv_seg = ctx.saved_tensors
        want_dpair = pair is not None and ctx.needs_input_grad[3]
        grads = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal, scale=ctx.scale,
            kpad_mask=kpad_mask, pair=pair,
            segment_ids=(q_seg, kv_seg) if q_seg is not None else None, want_dpair=want_dpair,
            window=ctx.window, softcap=ctx.softcap)
        dpair = grads[3] if want_dpair else None
        return (*grads[:3], dpair) + (None,) * 7


def flash_attention(q, k, v, pair=None, *, causal: bool = False, kpad_mask=None,
                    segment_ids=None, scale: float | None = None,
                    window: int | None = None, softcap: float | None = None):
    """Multi-head attention with online softmax, differentiable in q, k, v
    and the pair.

    q: (B, QH, QL, E); k, v: (B, KH, KL, E) with QH % KH == 0 (GQA/MQA).
    pair: optional additive bias (B, QH, QL, KL). causal: mask by absolute
    position (q_pos >= k_pos). kpad_mask: optional (B, KL) bool, True =
    valid key. segment_ids: optional ((B, QL), (B, KL)) packing ids.
    scale: default 1/sqrt(E). window: sliding window (requires causal).
    softcap: s -> softcap * tanh(s / softcap) before masking.
    """
    _validate(q, k, v, pair, kpad_mask)
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        window = int(window)
        if window >= k.shape[2]:
            window = None  # never binds: plain causal
    if softcap is not None:
        if pair is not None:
            raise ValueError("softcap is incompatible with pair bias")
        if softcap <= 0:
            raise ValueError(f"softcap must be > 0, got {softcap}")
        softcap = float(softcap)
    E = q.shape[-1]
    scale = float(1.0 / (E ** 0.5) if scale is None else scale)
    if q.device.type == "cuda":
        def again(q, k, v):
            return flash_attention(q, k, v, pair, causal=causal, kpad_mask=kpad_mask,
                                   segment_ids=segment_ids, scale=scale, window=window,
                                   softcap=softcap)

        Ep = kernel_head_dim(E)
        if Ep != E:
            return pad_head_dim(again, q, k, v, Ep)
        if _has_f32(q, k, v):
            return round_to_bf16(again, q, k, v)
        if pair is not None:
            pair = pair.contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, pair)):
        q_seg, kv_seg = segment_ids if segment_ids is not None else (None, None)
        return _FlashAttention.apply(q, k, v, pair, kpad_mask, q_seg, kv_seg, causal, scale,
                                     window, softcap)
    o, _ = flash_fwd(q, k, v, causal=causal, scale=scale, kpad_mask=kpad_mask,
                     pair=pair, segment_ids=segment_ids, window=window, softcap=softcap)
    return o


def lse_merge(o1, lse1, o2, lse2):
    """Combine two normalised attention partials over disjoint KV ranges:
    the (o, lse) monoid of nnop_tpu/ops/flash_attention.py:lse_merge, with
    its arithmetic (f32 weights, o back in o1's dtype). lse broadcasts
    against o (give it a trailing 1). Two empty partials (lse -inf) give
    NaN, as in JAX; kernel D keeps (max, sum) and guards a zero sum
    itself."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    den = w1 + w2
    o = (o1.float() * w1 + o2.float() * w2) / den
    return o.to(o1.dtype), m + torch.log(den)


def flash_attention_chunked(q, k, v, *, causal_offset: int, kpad_mask=None,
                            scale: float | None = None, window: int | None = None,
                            softcap: float | None = None):
    """Causal attention for CHUNKED PREFILL: query rows are a chunk whose
    global positions start at `causal_offset` (the live cache length);
    keys span the whole buffer. Row i attends cols <= causal_offset + i,
    intersected with kpad_mask (and the sliding `window` / `softcap`)."""
    _validate(q, k, v, None, kpad_mask)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cuda":
        def again(q, k, v):
            return flash_attention_chunked(q, k, v, causal_offset=causal_offset,
                                           kpad_mask=kpad_mask, scale=scale, window=window,
                                           softcap=softcap)

        Ep = kernel_head_dim(q.shape[-1])
        if Ep != q.shape[-1]:
            return pad_head_dim(again, q, k, v, Ep)
        if _has_f32(q, k, v):
            return round_to_bf16(again, q, k, v)
    o, _ = flash_fwd(q, k, v, causal=True, scale=float(scale),
                     causal_offset=int(causal_offset), kpad_mask=kpad_mask,
                     window=window,
                     softcap=None if softcap is None else float(softcap))
    return o
