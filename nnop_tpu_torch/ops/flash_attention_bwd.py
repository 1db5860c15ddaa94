"""Flash attention backward: the dQ and dK/dV CUDA kernels for Hopper.

Counterpart of nnop_tpu/ops/flash_attention_bwd.py:flash_attention_bwd
(:1053) and the ten `pallas_call` sites under it. `flash_bwd_dq` and
`flash_bwd_dkv` wrap the two entries of csrc/flash_bwd.cu (see the
source for what bounds them and how); `flash_attention_bwd` runs both,
dQ first because it also writes delta = rowsum(do * o), which the dK/dV
kernel reads (the JAX package computes delta outside Pallas, :1067-1071).
Both kernels are deterministic: no atomics, a fixed summation order.

Layouts are the JAX package's: q, o, do (B, QH, QL, E), k, v (B, KH, KL,
E), lse (B, QH, QL) f32 from the forward (ops/flash_attention.py:flash_fwd),
kpad_mask (B, KL) bool, True = valid. The kernels cover what kernel C
covers on the training path: causal (from row 0) or not, GQA, kpad, any
lengths, bf16 with head dim 64 or 128. A CPU tensor takes the plain
version (ops/naive.py:naive_attention_bwd); the two kernel launchers take
CUDA tensors only.
"""

from __future__ import annotations

import torch

from nnop_tpu_torch.ops.naive import naive_attention_bwd
from nnop_tpu_torch.utils.build import check_launch, load_library
from nnop_tpu_torch.utils.platform import check_cuda_operand

_BF16 = (torch.bfloat16,)


def _check(q, k, v, lse, do, kpad_mask, o=None):
    B, QH, QL, E = q.shape
    KH, KL = k.shape[1], k.shape[2]
    if E not in (64, 128):
        raise ValueError(f"head dim {E} not supported by the kernels (64 or 128)")
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
    return B, QH, KH, QL, KL, E


def flash_bwd_dq(q, k, v, o, lse, do, *, causal: bool, scale: float, kpad_mask=None):
    """The dQ kernel (CUDA tensors) -> (dq (B, QH, QL, E) in q.dtype,
    delta (B, QH, QL) f32 = rowsum(do * o), for flash_bwd_dkv)."""
    B, QH, KH, QL, KL, E = _check(q, k, v, lse, do, kpad_mask, o)
    dq = torch.empty_like(q)
    delta = torch.empty((B, QH, QL), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, delta
    err = load_library().nnop_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        kpad_mask.data_ptr() if kpad_mask is not None else None, dq.data_ptr(),
        delta.data_ptr(), B, QH, KH, QL, KL, E, float(scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch("flash_bwd_dq", err)
    flash_bwd_dq.launches += 1
    return dq, delta


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, lse, delta, do, *, causal: bool, scale: float, kpad_mask=None):
    """The dK/dV kernel (CUDA tensors) -> (dk, dv) (B, KH, KL, E) in k/v
    dtypes, summed over each KV head's group of query heads; delta from
    flash_bwd_dq."""
    B, QH, KH, QL, KL, E = _check(q, k, v, lse, do, kpad_mask)
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
        delta.data_ptr(), kpad_mask.data_ptr() if kpad_mask is not None else None,
        dk.data_ptr(), dv.data_ptr(), B, QH, KH, QL, KL, E, float(scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch("flash_bwd_dkv", err)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool, scale: float, kpad_mask=None):
    """Gradients of flash_attention -> (dq, dk, dv), from the forward's o
    and lse and the output gradient do: the plain version for a CPU
    tensor, the dQ then the dK/dV kernel for a CUDA tensor."""
    if q.device.type == "cpu":
        return naive_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale,
                                   kpad_mask=kpad_mask)
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do, causal=causal, scale=scale,
                             kpad_mask=kpad_mask)
    dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, causal=causal, scale=scale,
                           kpad_mask=kpad_mask)
    return dq, dk, dv
