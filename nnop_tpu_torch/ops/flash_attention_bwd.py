"""Flash attention backward: the dQ and dK/dV CUDA kernels for Hopper.

Counterpart of nnop_tpu/ops/flash_attention_bwd.py:flash_attention_bwd
(:1053) and the ten `pallas_call` sites under it. `flash_bwd_dq` and
`flash_bwd_dkv` wrap the two entries of csrc/flash_bwd.cu (the kernels,
what bounds them and how: csrc/flash_bwd.cuh); `flash_attention_bwd` runs both,
dQ first because it also writes delta = rowsum(do * o), which the dK/dV
kernel reads (the JAX package computes delta outside Pallas, :1067-1071),
and dpair, the pair bias's gradient. Both kernels are deterministic: no
atomics, a fixed summation order.

Layouts are the JAX package's: q, o, do (B, QH, QL, E), k, v (B, KH, KL,
E), lse (B, QH, QL) f32 from the forward (ops/flash_attention.py:flash_fwd),
kpad_mask (B, KL) bool, True = valid, pair (B, QH, QL, KL) bf16 or f32,
segment_ids ((B, QL), (B, KL)) ints. The kernels cover what kernel C
covers on the training path: causal (from row 0) or not, GQA, kpad, the
pair bias and segment ids, the sliding window (causal only) and the
score softcap (not with a pair), any lengths, bf16 with head dim 64, 128
or 256. Each kernel counts its launches with a pair, with segment ids,
with a window and with a softcap apart (`pair_launches`,
`segment_launches`, `window_launches`, `softcap_launches`) beside
`launches`, and by (head dim, window, softcap) in `mode_launches`, as
kernel C does. A CPU tensor takes the plain version
(ops/naive.py:naive_attention_bwd); the two kernel launchers take CUDA
tensors only.
"""

from __future__ import annotations

import torch

from nnop_tpu_torch.ops.flash_attention import (_PAIR_DTYPES, _segments, count_launch,
                                                 init_counters)
from nnop_tpu_torch.ops.naive import naive_attention_bwd
from nnop_tpu_torch.utils.build import check_launch, load_library
from nnop_tpu_torch.utils.platform import check_cuda_operand

_BF16 = (torch.bfloat16,)


def _check(q, k, v, lse, do, kpad_mask, pair, segment_ids, causal, window, softcap, o=None):
    """Validate the operands -> (B, QH, KH, QL, KL, E, q_seg, kv_seg)."""
    B, QH, QL, E = q.shape
    KH, KL = k.shape[1], k.shape[2]
    if E not in (64, 128, 256):
        raise ValueError(f"head dim {E} not supported by the kernels (64, 128 or 256)")
    if window is not None and (not causal or window < 1):
        raise ValueError(f"window {window} needs causal=True and window >= 1")
    if softcap is not None and (softcap <= 0 or pair is not None):
        raise ValueError(f"softcap {softcap} must be > 0 and takes no pair bias")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != E or QH % KH:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if do.shape != q.shape or lse.shape != (B, QH, QL) or (o is not None and o.shape != q.shape):
        raise ValueError(f"do {tuple(do.shape)} / lse {tuple(lse.shape)} do not match "
                         f"q {tuple(q.shape)}")
    check_cuda_operand("q", q, _BF16)
    for name, t in (("k", k), ("v", v), ("do", do)) + ((("o", o),) if o is not None else ()):
        check_cuda_operand(name, t, _BF16, device=q.device)
    check_cuda_operand("lse", lse, (torch.float32,), device=q.device)
    if kpad_mask is not None:
        check_cuda_operand("kpad_mask", kpad_mask, (torch.bool,), device=q.device)
        if kpad_mask.shape != (B, KL):
            raise ValueError(f"kpad_mask shape {tuple(kpad_mask.shape)}, expected {(B, KL)}")
    if pair is not None:
        check_cuda_operand("pair", pair, _PAIR_DTYPES, device=q.device)
        if pair.shape != (B, QH, QL, KL):
            raise ValueError(f"pair shape {tuple(pair.shape)}, expected {(B, QH, QL, KL)}")
    segs = _segments(segment_ids, q, k) if segment_ids is not None else (None, None)
    return B, QH, KH, QL, KL, E, *segs


def _ptr(t):
    return t.data_ptr() if t is not None else None


def flash_bwd_dq(q, k, v, o, lse, do, *, causal: bool, scale: float, kpad_mask=None,
                 pair=None, segment_ids=None, want_dpair: bool = True,
                 window: int | None = None, softcap: float | None = None):
    """The dQ kernel (CUDA tensors) -> (dq (B, QH, QL, E) in q.dtype,
    delta (B, QH, QL) f32 = rowsum(do * o), for flash_bwd_dkv), and with a
    pair (unless want_dpair is False) dpair (B, QH, QL, KL) in its dtype,
    every element written by the kernel."""
    B, QH, KH, QL, KL, E, q_seg, kv_seg = _check(q, k, v, lse, do, kpad_mask, pair,
                                                 segment_ids, causal, window, softcap, o)
    dq = torch.empty_like(q)
    delta = torch.empty((B, QH, QL), dtype=torch.float32, device=q.device)
    dpair = torch.empty_like(pair) if pair is not None and want_dpair else None
    out = (dq, delta) + ((dpair,) if dpair is not None else ())
    if dq.numel() == 0:
        return out
    err = load_library().nnop_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        _ptr(kpad_mask), _ptr(pair), _ptr(q_seg), _ptr(kv_seg), dq.data_ptr(), _ptr(dpair),
        delta.data_ptr(), B, QH, KH, QL, KL, E,
        int(pair is not None and pair.dtype == torch.float32), float(scale), int(causal),
        int(window or 0), float(softcap or 0.0), torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch("flash_bwd_dq", err)
    count_launch(flash_bwd_dq, E, pair, segment_ids, window, softcap)
    return out


init_counters(flash_bwd_dq)


def flash_bwd_dkv(q, k, v, lse, delta, do, *, causal: bool, scale: float, kpad_mask=None,
                  pair=None, segment_ids=None, window: int | None = None,
                  softcap: float | None = None):
    """The dK/dV kernel (CUDA tensors) -> (dk, dv) (B, KH, KL, E) in k/v
    dtypes, summed over each KV head's group of query heads; delta from
    flash_bwd_dq."""
    B, QH, KH, QL, KL, E, q_seg, kv_seg = _check(q, k, v, lse, do, kpad_mask, pair,
                                                 segment_ids, causal, window, softcap)
    check_cuda_operand("delta", delta, (torch.float32,), device=q.device)
    if delta.shape != lse.shape:
        raise ValueError(f"delta shape {tuple(delta.shape)} != lse shape {tuple(lse.shape)}")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    if QL == 0:
        return dk.zero_(), dv.zero_()
    err = load_library().nnop_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _ptr(kpad_mask), _ptr(pair), _ptr(q_seg), _ptr(kv_seg),
        dk.data_ptr(), dv.data_ptr(), B, QH, KH, QL, KL, E,
        int(pair is not None and pair.dtype == torch.float32), float(scale), int(causal),
        int(window or 0), float(softcap or 0.0), torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch("flash_bwd_dkv", err)
    count_launch(flash_bwd_dkv, E, pair, segment_ids, window, softcap)
    return dk, dv


init_counters(flash_bwd_dkv)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool, scale: float, kpad_mask=None,
                        pair=None, segment_ids=None, want_dpair: bool = True,
                        window: int | None = None, softcap: float | None = None):
    """Gradients of flash_attention -> (dq, dk, dv), and dpair after them
    when a pair is given (unless want_dpair is False), from the forward's
    o and lse and the output gradient do: the plain version for a CPU
    tensor, the dQ then the dK/dV kernel for a CUDA tensor."""
    kw = dict(causal=causal, scale=scale, kpad_mask=kpad_mask, pair=pair,
              segment_ids=segment_ids, window=window, softcap=softcap)
    if q.device.type == "cpu":
        grads = naive_attention_bwd(q, k, v, o, lse, do, **kw)
        return grads if want_dpair else grads[:3]
    dq, delta, *dpair = flash_bwd_dq(q, k, v, o, lse, do, want_dpair=want_dpair, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, **kw)
    return (dq, dk, dv, *dpair)
