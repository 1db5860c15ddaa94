"""Online softmax forward and backward: Triton kernels for Hopper.

The forward replaces nnop_tpu/ops/softmax.py:_softmax_fwd_impl
(`_fwd_kernel`), the backward `_softmax_bwd_impl` (`_bwd_kernel`).
`online_softmax` is differentiable through a `torch.autograd.Function`
(the JAX custom VJP, :107-126): it saves y, and the backward reads y and
dy only. Under `torch.no_grad` only the forward kernel runs.

y  = exp(x - m) / sum(exp(x - m)),   m = max(x), and m = 0 where that is
     NaN or -inf (the TPU kernel's guard, :45-47: a row of -inf gives NaN)
dx = (dy - sum(dy * y)) * y

Bound on the H100: device-memory bandwidth (one read and one write per
element forward, two reads and one write backward, a few flops each).
A row of up to 16384 columns sits whole in registers, one program per
row, so each row is read once. A wider row (the JAX op takes any width;
Llama-3-8B's vocab is 128256) runs in column chunks: the forward's first
pass carries the online (max, denominator) pair over the chunks (the
reference's `MD` monoid, softmax.jl:1-16) and its second pass writes
exp(x - m) / d, so x is read twice unless the second read hits L2; the
backward's first pass sums dy * y and its second writes dx.
"""

from __future__ import annotations

import functools

import torch

from nnop_tpu_torch.ops.naive import naive_softmax, naive_softmax_bwd
from nnop_tpu_torch.utils.platform import check_cuda_operand

_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_MAX_BLOCK = 16384  # the widest row kept whole in registers
_CHUNK = 8192  # the column chunk of a wider row


def _block(n_cols):
    """(one block?, BLOCK, num_warps) for rows of n_cols."""
    import triton

    one = n_cols <= _MAX_BLOCK
    block = triton.next_power_of_2(n_cols) if one else _CHUNK
    return one, block, max(1, min(16, block // 256))


def softmax_fwd(x2):
    """The forward kernel: x2 (n, E) -> y (n, E) in x2.dtype."""
    if x2.device.type == "cpu":
        return naive_softmax(x2)
    check_cuda_operand("x", x2, _DTYPES)
    y = torch.empty_like(x2)
    rows, E = x2.shape
    if rows and E:
        one, block, warps = _block(E)
        _kernels()[0][(rows,)](x2, y, E, ONE_BLOCK=one, BLOCK=block, num_warps=warps)
        softmax_fwd.launches += 1
    return y


softmax_fwd.launches = 0


def softmax_bwd(y2, dy2):
    """The backward kernel: y2, dy2 (n, E) -> dx (n, E) in y2.dtype."""
    if y2.device.type == "cpu":
        return naive_softmax_bwd(y2, dy2)
    check_cuda_operand("y", y2, _DTYPES)
    check_cuda_operand("dy", dy2, _DTYPES, device=y2.device)
    if dy2.shape != y2.shape:
        raise ValueError(f"dy shape {tuple(dy2.shape)} != y shape {tuple(y2.shape)}")
    dx = torch.empty_like(y2)
    rows, E = y2.shape
    if rows and E:
        one, block, warps = _block(E)
        _kernels()[1][(rows,)](y2, dy2, dx, E, ONE_BLOCK=one, BLOCK=block, num_warps=warps)
        softmax_bwd.launches += 1
    return dx


softmax_bwd.launches = 0


class _OnlineSoftmax(torch.autograd.Function):
    """The JAX custom VJP: the forward kernel saving y, the backward
    kernel from y and dy."""

    @staticmethod
    def forward(ctx, x):
        y = softmax_fwd(x.reshape(-1, x.shape[-1]).contiguous())
        ctx.save_for_backward(y)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return softmax_bwd(y, dy.reshape(y.shape).contiguous()).view(dy.shape)


def online_softmax(x):
    """Numerically stable softmax over the last axis of x (any rank >= 1),
    f32 math, output in x.dtype. Differentiable in x."""
    if x.dim() == 0:
        raise ValueError("online_softmax needs rank >= 1")
    if torch.is_grad_enabled() and x.requires_grad:
        return _OnlineSoftmax.apply(x)
    return softmax_fwd(x.reshape(-1, x.shape[-1]).contiguous()).view(x.shape)


@functools.cache
def _kernels():
    """Define the Triton kernels (imported here, at first launch; the
    names are module globals because Triton resolves them there)."""
    global triton, tl, _guard
    import triton
    import triton.language as tl

    @triton.jit
    def _guard(m):
        # the TPU kernel's guard: a NaN or -inf row maximum becomes 0
        return tl.where((m != m) | (m == float("-inf")), 0.0, m)

    @triton.jit
    def softmax_fwd_kernel(x_ptr, y_ptr, n_cols, ONE_BLOCK: tl.constexpr,
                           BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        xr, yr = x_ptr + row * n_cols, y_ptr + row * n_cols
        cols = tl.arange(0, BLOCK)
        if ONE_BLOCK:
            live = cols < n_cols
            x = tl.load(xr + cols, mask=live, other=float("-inf")).to(tl.float32)
            e = tl.exp(x - _guard(tl.max(x, axis=0)))
            tl.store(yr + cols, (e / tl.sum(e, axis=0)).to(y_ptr.dtype.element_ty), mask=live)
        else:
            # pass 1: the online (max, denominator) pair over the chunks,
            # the denominator kept relative to the guarded running max
            m = tl.max(tl.full([BLOCK], float("-inf"), tl.float32), axis=0)
            d = tl.sum(tl.zeros([BLOCK], tl.float32), axis=0)
            for c0 in range(0, n_cols, BLOCK):
                live = c0 + cols < n_cols
                x = tl.load(xr + c0 + cols, mask=live, other=float("-inf")).to(tl.float32)
                m_new = tl.maximum(m, tl.max(x, axis=0))
                g_new = _guard(m_new)
                # (d is 0 until a chunk holds a value above -inf: no 0 * inf)
                d = (tl.where(d == 0.0, 0.0, d * tl.exp(_guard(m) - g_new))
                     + tl.sum(tl.exp(x - g_new), axis=0))
                m = m_new
            g = _guard(m)
            # pass 2: y = exp(x - m) / d
            for c0 in range(0, n_cols, BLOCK):
                live = c0 + cols < n_cols
                x = tl.load(xr + c0 + cols, mask=live, other=float("-inf")).to(tl.float32)
                tl.store(yr + c0 + cols, (tl.exp(x - g) / d).to(y_ptr.dtype.element_ty),
                         mask=live)

    @triton.jit
    def softmax_bwd_kernel(y_ptr, dy_ptr, dx_ptr, n_cols, ONE_BLOCK: tl.constexpr,
                           BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        yr, dyr, dxr = y_ptr + row * n_cols, dy_ptr + row * n_cols, dx_ptr + row * n_cols
        cols = tl.arange(0, BLOCK)
        if ONE_BLOCK:
            live = cols < n_cols
            y = tl.load(yr + cols, mask=live, other=0.0).to(tl.float32)
            dy = tl.load(dyr + cols, mask=live, other=0.0).to(tl.float32)
            t = tl.sum(dy * y, axis=0)
            tl.store(dxr + cols, ((dy - t) * y).to(dx_ptr.dtype.element_ty), mask=live)
        else:
            t = tl.sum(tl.zeros([BLOCK], tl.float32), axis=0)
            for c0 in range(0, n_cols, BLOCK):
                live = c0 + cols < n_cols
                y = tl.load(yr + c0 + cols, mask=live, other=0.0).to(tl.float32)
                dy = tl.load(dyr + c0 + cols, mask=live, other=0.0).to(tl.float32)
                t += tl.sum(dy * y, axis=0)
            for c0 in range(0, n_cols, BLOCK):
                live = c0 + cols < n_cols
                y = tl.load(yr + c0 + cols, mask=live, other=0.0).to(tl.float32)
                dy = tl.load(dyr + c0 + cols, mask=live, other=0.0).to(tl.float32)
                tl.store(dxr + c0 + cols, ((dy - t) * y).to(dx_ptr.dtype.element_ty),
                         mask=live)

    return softmax_fwd_kernel, softmax_bwd_kernel
