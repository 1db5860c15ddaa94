"""RMS norm forward and backward: Triton kernels for Hopper.

The forward (kernel A) replaces nnop_tpu/ops/rms_norm.py:_rms_fwd_impl
(`_fwd_kernel_noresid`, and `_fwd_kernel` with its stored rstd) and the
`streaming_rowop` route it takes for prefill row counts
(nnop_tpu/ops/streaming.py); they compute the same function, so one
kernel serves every row count. The backward (A-bwd) replaces
`_rms_bwd_impl` (`_bwd_kernel`). `rms_norm` is differentiable through a
`torch.autograd.Function` (the JAX custom VJP, :172-210): with grad
enabled and an input that requires it, the forward also stores rstd
(n, 1) f32 and the backward runs A-bwd; otherwise (serving, under
`torch.no_grad`) A runs without the rstd store.

y  = x * rstd * (offset + w),   rstd = rsqrt(mean(x^2) + eps)
dx = rstd * (g * dy - x_hat * mean(g * dy * x_hat)),   g = offset + w
dw = sum over rows of dy * x_hat                       (f32, then w.dtype)

Bound on the H100: device-memory bandwidth. The forward reads and writes
each row once (2 * 4096 * 2 bytes at Llama-3-8B width in bf16), the
backward reads x and dy and writes dx, against a few flops per element.
Both keep a whole row in registers (4096 columns in one block), so each
row's reduction and its elementwise pass are one pass over the bytes.
The forward runs one program per row. The backward runs one program per
block of rows and carries its partial dw in registers across them; it
writes one f32 partial row per program, and a sum over those few rows
finishes dw: deterministic, no atomics (the TPU kernel carried dw in
VMEM scratch across its sequential grid instead).
"""

from __future__ import annotations

import functools

import torch

from nnop_tpu_torch.ops.naive import naive_rms_norm_bwd, naive_rms_norm_fwd
from nnop_tpu_torch.utils.platform import cdiv, check_cuda_operand

_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_MAX_COLS = 16384
_BWD_PROGRAMS = 512  # partial dw rows: ~4 programs per SM of the H100


def _check(x2, w):
    E = x2.shape[-1]
    check_cuda_operand("x", x2, _DTYPES)
    check_cuda_operand("w", w, _DTYPES, device=x2.device)
    if w.shape != (E,):
        raise ValueError(f"w shape {tuple(w.shape)}, expected ({E},)")
    if E > _MAX_COLS:
        raise ValueError(f"row width {E} > {_MAX_COLS} (one row per block)")


def _fwd(x2, w, eps, offset, rstd):
    """Launch A on rows x2 (n, E); rstd (n, 1) f32 or None (no store)."""
    import triton

    _check(x2, w)
    y = torch.empty_like(x2)
    rows, E = x2.shape
    if rows:
        block = triton.next_power_of_2(E)
        _kernels()[0][(rows,)](
            x2, w, y, rstd if rstd is not None else y, E, float(eps), float(offset),
            STORE_RSTD=rstd is not None, BLOCK=block, num_warps=max(1, min(16, block // 256)),
        )
    return y


def rms_norm_fwd(x2, w, eps: float = 1e-6, offset: float = 0.0):
    """Kernel A with the rstd store: x2 (n, E) -> (y (n, E) in x2.dtype,
    rstd (n, 1) f32). The forward of the differentiable rms_norm."""
    if x2.device.type == "cpu":
        return naive_rms_norm_fwd(x2, w, eps=eps, offset=offset)
    rstd = torch.empty((x2.shape[0], 1), dtype=torch.float32, device=x2.device)
    y = _fwd(x2, w, eps, offset, rstd)
    if x2.shape[0]:
        rms_norm_fwd.launches += 1
    return y, rstd


rms_norm_fwd.launches = 0


def rms_norm_bwd(x2, w, rstd, dy2, offset: float = 0.0):
    """Kernel A-bwd: x2, dy2 (n, E), rstd (n, 1) f32 from rms_norm_fwd ->
    (dx (n, E) in x2.dtype, dw (E,) f32)."""
    if x2.device.type == "cpu":
        return naive_rms_norm_bwd(x2, w, rstd, dy2, offset)
    import triton

    _check(x2, w)
    check_cuda_operand("rstd", rstd, (torch.float32,), device=x2.device)
    check_cuda_operand("dy", dy2, (x2.dtype,), device=x2.device)
    rows, E = x2.shape
    if rstd.shape != (rows, 1) or dy2.shape != x2.shape:
        raise ValueError(f"rstd {tuple(rstd.shape)} / dy {tuple(dy2.shape)} do not match "
                         f"x {tuple(x2.shape)}")
    dx = torch.empty_like(x2)
    if rows == 0:
        return dx, torch.zeros(E, dtype=torch.float32, device=x2.device)
    per_prog = cdiv(rows, _BWD_PROGRAMS)
    n_prog = cdiv(rows, per_prog)
    partial = torch.empty((n_prog, E), dtype=torch.float32, device=x2.device)
    block = triton.next_power_of_2(E)
    _kernels()[1][(n_prog,)](
        x2, w, rstd, dy2, dx, partial, rows, E, per_prog, float(offset),
        BLOCK=block, num_warps=max(1, min(16, block // 256)),
    )
    rms_norm_bwd.launches += 1
    return dx, partial.sum(dim=0)


rms_norm_bwd.launches = 0


class _RMSNorm(torch.autograd.Function):
    """The JAX custom VJP (nnop_tpu/ops/rms_norm.py:172-210): A with rstd
    forward, A-bwd backward, dw returned in w.dtype."""

    @staticmethod
    def forward(ctx, x, w, eps, offset):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y, rstd = rms_norm_fwd(x2, w, eps, offset)
        ctx.save_for_backward(x2, w, rstd)
        ctx.offset = offset
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, w, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x2, w, rstd, dy.reshape(x2.shape).contiguous(), ctx.offset)
        return dx.view(dy.shape), dw.to(w.dtype), None, None


def rms_norm(x, w, eps: float = 1e-6, offset: float = 0.0):
    """RMS norm over the last axis (x (..., E), w (E,)), fp32 accumulation.
    `offset=1.0` gives Gemma-style (1 + w) scaling. Differentiable in x
    and w; without grad it launches A without the rstd store."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps, offset)
    if x.device.type == "cpu":
        return naive_rms_norm_fwd(x, w, eps=eps, offset=offset)[0]
    E = x.shape[-1]
    y = _fwd(x.reshape(-1, E), w, eps, offset, None)
    if y.numel():
        rms_norm.launches += 1
    return y.view(x.shape)


rms_norm.launches = 0


@functools.cache
def _kernels():
    """Define the Triton kernels. Triton is imported here, at first launch,
    so that the module imports where Triton is missing; the names are
    bound as module globals because Triton resolves them there."""
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def rms_norm_fwd_kernel(x_ptr, w_ptr, y_ptr, rstd_ptr, n_cols, eps, offset,
                            STORE_RSTD: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        live = cols < n_cols
        x = tl.load(x_ptr + row * n_cols + cols, mask=live, other=0.0)
        x = x.to(tl.float32)
        w = tl.load(w_ptr + cols, mask=live, other=0.0).to(tl.float32)
        ms = tl.sum(x * x, axis=0) / n_cols
        y = x / tl.sqrt(ms + eps) * (offset + w)
        tl.store(y_ptr + row * n_cols + cols,
                 y.to(y_ptr.dtype.element_ty), mask=live)
        if STORE_RSTD:
            tl.store(rstd_ptr + row, 1.0 / tl.sqrt(ms + eps))

    @triton.jit
    def rms_norm_bwd_kernel(x_ptr, w_ptr, rstd_ptr, dy_ptr, dx_ptr, dwp_ptr, n_rows,
                            n_cols, rows_per_prog, offset, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        live = cols < n_cols
        g = offset + tl.load(w_ptr + cols, mask=live, other=0.0).to(tl.float32)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        row0 = pid.to(tl.int64) * rows_per_prog
        for i in range(0, rows_per_prog):
            row = row0 + i
            ok = row < n_rows  # the last program's block may be short
            m = live & ok
            x = tl.load(x_ptr + row * n_cols + cols, mask=m, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + row * n_cols + cols, mask=m, other=0.0).to(tl.float32)
            rstd = tl.load(rstd_ptr + row, mask=ok, other=0.0)
            xhat = x * rstd
            gdy = g * dy
            c = tl.sum(gdy * xhat, axis=0) / n_cols
            tl.store(dx_ptr + row * n_cols + cols,
                     (rstd * (gdy - xhat * c)).to(dx_ptr.dtype.element_ty), mask=m)
            acc += dy * xhat
        tl.store(dwp_ptr + pid.to(tl.int64) * n_cols + cols, acc, mask=live)

    return rms_norm_fwd_kernel, rms_norm_bwd_kernel
