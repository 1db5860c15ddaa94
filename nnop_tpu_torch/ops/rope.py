"""Llama rotary embedding: the cos/sin tables and a Triton kernel for Hopper.

`llama_rope` replaces nnop_tpu/ops/rope.py:_rope_impl (`_rope_kernel`).
Split-half convention (x1 = x[i], x2 = x[i + half]):
  out[i]        = x1 * cos - x2 * sin
  out[i + half] = x2 * cos + x1 * sin
`sin_sign=-1` is the inverse rotation. `llama_rope` is differentiable
through a `torch.autograd.Function` (the JAX custom VJP, :126-142):
its backward is `llama_rope_bwd`, the same kernel with the sine negated
(the rotation's transpose is its inverse), counted apart.

Bound on the H100: device-memory bandwidth (a pure elementwise rotation:
each q/k element is read and written once, plus the f32 cos/sin rows).
The kernel runs one program per (b, head, position) row, so each program
reads its row and its cos/sin row once and writes the row once. q and k
go through the same kernel in two launches (their head counts differ);
the TPU kernel rotated both in one launch only to save grid steps.
"""

from __future__ import annotations

import functools
import math

import torch

from nnop_tpu_torch.ops.naive import naive_rope
from nnop_tpu_torch.utils.platform import check_cuda_operand


class RotaryEmbedding:
    """Precomputes rotary cos/sin tables from position ids."""

    def __init__(self, dim: int, base: float = 10000.0, scaling=None):
        """scaling: optional Llama-3.1 NTK-by-parts rope scaling, a tuple
        (factor, low_freq_factor, high_freq_factor, original_max_len):
        long-wavelength frequencies are divided by `factor`, short ones
        kept, with a smooth ramp between the two wavelength thresholds
        original_max_len/low_freq_factor and /high_freq_factor."""
        if dim % 2 != 0:
            raise ValueError(f"rotary dim must be even, got {dim}")
        self.dim = dim
        self.base = base
        inv_freq = base ** (-torch.arange(0, dim, 2, dtype=torch.float32) / dim)
        if scaling is not None:
            factor, low_f, high_f, orig_len = scaling
            wavelen = 2.0 * math.pi / inv_freq
            low_wavelen = orig_len / low_f
            high_wavelen = orig_len / high_f
            smooth = ((orig_len / wavelen - low_f) / (high_f - low_f)).clamp(0.0, 1.0)
            scaled = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
            inv_freq = torch.where(
                wavelen > low_wavelen, inv_freq / factor,
                torch.where(wavelen < high_wavelen, inv_freq, scaled),
            )
        self.inv_freq = inv_freq

    def __call__(self, position_ids):
        """position_ids: (B, L) int -> cos, sin: (B, L, dim) float32, on
        the device of position_ids."""
        if self.inv_freq.device != position_ids.device:
            self.inv_freq = self.inv_freq.to(position_ids.device)
        freqs = position_ids[..., None].float() * self.inv_freq
        emb = torch.cat([freqs, freqs], dim=-1)
        return torch.cos(emb), torch.sin(emb)


def _rotate(q, k, cos, sin, sin_sign: float):
    """Launch B on q and on k; returns (new q, new k, launches)."""
    if q.device.type == "cpu":
        return (*naive_rope(q, k, cos, sin, sin_sign), 0)
    B, _, L, E = q.shape
    if k.shape[0] != B or k.shape[2:] != (L, E) or cos.shape != (B, L, E):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"cos {tuple(cos.shape)}")
    if sin.shape != cos.shape:
        raise ValueError(f"sin shape {tuple(sin.shape)} != cos shape {tuple(cos.shape)}")
    if E & (E - 1):
        raise ValueError(f"head dim {E} must be a power of two")
    dt = (torch.bfloat16, torch.float16, torch.float32)
    check_cuda_operand("q", q, dt)
    check_cuda_operand("k", k, (q.dtype,), device=q.device)
    check_cuda_operand("cos", cos, (torch.float32,), device=q.device)
    check_cuda_operand("sin", sin, (torch.float32,), device=q.device)
    kernel = _kernel()
    outs, n = [], 0
    for x in (q, k):
        y = torch.empty_like(x)
        n_rows = x.numel() // E
        if n_rows:
            kernel[(n_rows,)](x, cos, sin, y, x.shape[1], L, float(sin_sign),
                              HALF=E // 2, num_warps=1)
            n += 1
        outs.append(y)
    return outs[0], outs[1], n


def llama_rope_bwd(dq, dk, cos, sin, sin_sign: float = 1.0):
    """The backward of llama_rope(..., sin_sign): kernel B with the sine
    negated, on the output gradients dq (B, QH, L, E), dk (B, KH, L, E)."""
    dq_in, dk_in, n = _rotate(dq.contiguous(), dk.contiguous(), cos, sin, -sin_sign)
    llama_rope_bwd.launches += n
    return dq_in, dk_in


llama_rope_bwd.launches = 0


class _LlamaRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, cos, sin, sin_sign):
        ctx.save_for_backward(cos, sin)
        ctx.sin_sign = sin_sign
        return llama_rope(q, k, cos, sin, sin_sign)

    @staticmethod
    def backward(ctx, dq, dk):
        cos, sin = ctx.saved_tensors
        return (*llama_rope_bwd(dq, dk, cos, sin, ctx.sin_sign), None, None, None)


def llama_rope(q, k, cos, sin, sin_sign: float = 1.0):
    """Rotate q (B, QH, L, E) and k (B, KH, L, E) by cos/sin (B, L, E)
    from `RotaryEmbedding`. Returns new (q, k) in their dtypes;
    differentiable in q and k."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        return _LlamaRope.apply(q, k, cos, sin, sin_sign)
    qo, ko, n = _rotate(q, k, cos, sin, sin_sign)
    llama_rope.launches += n
    return qo, ko


llama_rope.launches = 0


@functools.cache
def _kernel():
    """Define the Triton kernel. Triton is imported here, at first launch,
    so that the module imports where Triton is missing; the names are
    bound as module globals because Triton resolves them there."""
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def rope_fwd(x_ptr, cos_ptr, sin_ptr, y_ptr, n_heads, seq_len, sin_sign,
                 HALF: tl.constexpr):
        r = tl.program_id(0).to(tl.int64)  # row = (b, head, position)
        b = r // (n_heads * seq_len)
        pos = r % seq_len
        i = tl.arange(0, HALF)
        xr = x_ptr + r * (2 * HALF)
        cr = (b * seq_len + pos) * (2 * HALF)
        x1 = tl.load(xr + i).to(tl.float32)
        x2 = tl.load(xr + HALF + i).to(tl.float32)
        c1 = tl.load(cos_ptr + cr + i)
        c2 = tl.load(cos_ptr + cr + HALF + i)
        s1 = sin_sign * tl.load(sin_ptr + cr + i)
        s2 = sin_sign * tl.load(sin_ptr + cr + HALF + i)
        out_ty = y_ptr.dtype.element_ty
        tl.store(y_ptr + r * (2 * HALF) + i, (x1 * c1 - x2 * s1).to(out_ty))
        tl.store(y_ptr + r * (2 * HALF) + HALF + i, (x2 * c2 + x1 * s2).to(out_ty))

    return rope_fwd
