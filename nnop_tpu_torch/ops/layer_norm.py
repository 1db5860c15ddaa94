"""Layer norm forward and backward: Triton kernels for Hopper.

The forward replaces nnop_tpu/ops/layer_norm.py:_ln_fwd_impl
(`_fwd_kernel`), the backward `_ln_bwd_impl` (`_bwd_kernel`).
`layer_norm` is differentiable through a `torch.autograd.Function` (the
JAX custom VJP, :171-191) that saves x, w, mu and sigma; dw and db come
back in w.dtype. With grad enabled and an input that requires it, the
forward also stores mu and sigma (n, 1) f32; otherwise it launches
without that store, as kernel A does for rstd (ops/rms_norm.py).

y  = (x - mu) * sigma * w + b,   sigma = rsqrt(mean((x - mu)^2) + eps)
dx = sigma * (w dy - mean(w dy) - x_hat * mean(w dy x_hat)),
     x_hat = (x - mu) * sigma
dw = sum over rows of dy * x_hat,   db = sum over rows of dy

Bound on the H100: device-memory bandwidth, as kernel A (one read and one
write per element forward; x and dy read, dx written backward). The
forward keeps a row of up to 16384 columns whole in registers, one
program per row; a wider row runs in column chunks (the sum, then the
centred sum of squares, as the TPU kernel computes the variance, then
the output: three reads of x). The backward runs one program per block
of rows, as A-bwd: up to 8192 columns it carries partial dw and db rows
in registers across its rows; past that it runs each row in two chunked
passes (the row's two means, then dx) and keeps its partial rows in its
own rows of the f32 partial buffers in device memory. Either way each
program writes one f32 partial row of dw and of db, and a sum over those
rows finishes them: deterministic, no atomics (the TPU kernel carried
them in VMEM scratch across its sequential grid).
"""

from __future__ import annotations

import functools

import torch

from nnop_tpu_torch.ops.naive import naive_layer_norm_bwd, naive_layer_norm_fwd
from nnop_tpu_torch.utils.platform import cdiv, check_cuda_operand

_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_MAX_BLOCK = 16384  # the widest row the forward keeps whole in registers
_MAX_BLOCK_BWD = 8192  # the same for the backward (x, dy, w and two partial rows)
_CHUNK = 8192  # the column chunk of a wider row
_BWD_PROGRAMS = 512  # partial dw/db rows: ~4 programs per SM of the H100


def _check(x2, w, b=None):
    E = x2.shape[-1]
    check_cuda_operand("x", x2, _DTYPES)
    for name, t in (("w", w), ("b", b)):
        if t is None:
            continue
        check_cuda_operand(name, t, _DTYPES, device=x2.device)
        if t.shape != (E,):
            raise ValueError(f"{name} shape {tuple(t.shape)}, expected ({E},)")


def _block(n_cols, max_block):
    """(one block?, BLOCK, num_warps) for rows of n_cols."""
    import triton

    one = n_cols <= max_block
    block = triton.next_power_of_2(n_cols) if one else _CHUNK
    return one, block, max(1, min(16, block // 256))


def layer_norm_fwd(x2, w, b, eps: float = 1e-6, stats: bool = True):
    """The forward kernel: x2 (n, E) -> (y (n, E) in x2.dtype, mu, sigma
    (n, 1) f32), or y alone with stats=False (launched without the mu and
    sigma store)."""
    if x2.device.type == "cpu":
        y, mu, sigma = naive_layer_norm_fwd(x2, w, b, eps=eps)
        return (y, mu, sigma) if stats else y
    _check(x2, w, b)
    rows, E = x2.shape
    y = torch.empty_like(x2)
    mu = sigma = None
    if stats:
        mu, sigma = (torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
                     for _ in range(2))
    if rows and E:
        one, block, warps = _block(E, _MAX_BLOCK)
        _kernels()[0][(rows,)](
            x2, w, b, y, mu if stats else y, sigma if stats else y, E, float(eps),
            STORE_STATS=stats, ONE_BLOCK=one, BLOCK=block, num_warps=warps)
        layer_norm_fwd.launches += 1
        layer_norm_fwd.stats_launches += stats
    return (y, mu, sigma) if stats else y


layer_norm_fwd.launches = 0
layer_norm_fwd.stats_launches = 0


def layer_norm_bwd(x2, w, mu, sigma, dy2):
    """The backward kernel: x2, dy2 (n, E), mu and sigma (n, 1) f32 from
    layer_norm_fwd -> (dx (n, E) in x2.dtype, dw (E,) f32, db (E,) f32)."""
    if x2.device.type == "cpu":
        return naive_layer_norm_bwd(x2, w, mu, sigma, dy2)
    _check(x2, w)
    for name, t in (("mu", mu), ("sigma", sigma)):
        check_cuda_operand(name, t, (torch.float32,), device=x2.device)
    check_cuda_operand("dy", dy2, (x2.dtype,), device=x2.device)
    rows, E = x2.shape
    if mu.shape != (rows, 1) or sigma.shape != (rows, 1) or dy2.shape != x2.shape:
        raise ValueError(f"mu {tuple(mu.shape)} / sigma {tuple(sigma.shape)} / dy "
                         f"{tuple(dy2.shape)} do not match x {tuple(x2.shape)}")
    dx = torch.empty_like(x2)
    if rows == 0 or E == 0:
        zeros = torch.zeros(E, dtype=torch.float32, device=x2.device)
        return dx, zeros, zeros.clone()
    per_prog = cdiv(rows, _BWD_PROGRAMS)
    n_prog = cdiv(rows, per_prog)
    dwp, dbp = (torch.empty((n_prog, E), dtype=torch.float32, device=x2.device)
                for _ in range(2))
    one, block, warps = _block(E, _MAX_BLOCK_BWD)
    _kernels()[1][(n_prog,)](x2, w, mu, sigma, dy2, dx, dwp, dbp, rows, E, per_prog,
                             ONE_BLOCK=one, BLOCK=block, num_warps=warps)
    layer_norm_bwd.launches += 1
    return dx, dwp.sum(dim=0), dbp.sum(dim=0)


layer_norm_bwd.launches = 0


class _LayerNorm(torch.autograd.Function):
    """The JAX custom VJP (nnop_tpu/ops/layer_norm.py:171-191): the
    forward kernel with the mu/sigma store, the backward kernel; dw and db
    returned in w.dtype."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y, mu, sigma = layer_norm_fwd(x2, w, b, eps)
        ctx.save_for_backward(x2, w, mu, sigma)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, w, mu, sigma = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x2, w, mu, sigma, dy.reshape(x2.shape).contiguous())
        return dx.view(dy.shape), dw.to(w.dtype), db.to(w.dtype), None


def layer_norm(x, w, b, eps: float = 1e-6):
    """Layer norm over the last axis (x (..., E), w and b (E,)), f32
    accumulation, output in x.dtype. Differentiable in x, w and b;
    without grad the forward launches without the mu/sigma store."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return _LayerNorm.apply(x, w, b, eps)
    return layer_norm_fwd(x.reshape(-1, x.shape[-1]).contiguous(), w, b, eps,
                          stats=False).view(x.shape)


@functools.cache
def _kernels():
    """Define the Triton kernels (imported here, at first launch; the
    names are module globals because Triton resolves them there)."""
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def layer_norm_fwd_kernel(x_ptr, w_ptr, b_ptr, y_ptr, mu_ptr, sigma_ptr, n_cols, eps,
                              STORE_STATS: tl.constexpr, ONE_BLOCK: tl.constexpr,
                              BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        xr, yr = x_ptr + row * n_cols, y_ptr + row * n_cols
        cols = tl.arange(0, BLOCK)
        if ONE_BLOCK:
            live = cols < n_cols
            x = tl.load(xr + cols, mask=live, other=0.0).to(tl.float32)
            mu = tl.sum(x, axis=0) / n_cols
            xc = tl.where(live, x - mu, 0.0)
            sigma = 1.0 / tl.sqrt(tl.sum(xc * xc, axis=0) / n_cols + eps)
            w = tl.load(w_ptr + cols, mask=live, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + cols, mask=live, other=0.0).to(tl.float32)
            tl.store(yr + cols, (xc * sigma * w + b).to(y_ptr.dtype.element_ty), mask=live)
        else:
            acc = tl.zeros([BLOCK], tl.float32)
            for c0 in range(0, n_cols, BLOCK):
                acc += tl.load(xr + c0 + cols, mask=c0 + cols < n_cols, other=0.0).to(tl.float32)
            mu = tl.sum(acc, axis=0) / n_cols
            acc = tl.zeros([BLOCK], tl.float32)
            for c0 in range(0, n_cols, BLOCK):
                live = c0 + cols < n_cols
                x = tl.load(xr + c0 + cols, mask=live, other=0.0).to(tl.float32)
                xc = tl.where(live, x - mu, 0.0)
                acc += xc * xc
            sigma = 1.0 / tl.sqrt(tl.sum(acc, axis=0) / n_cols + eps)
            for c0 in range(0, n_cols, BLOCK):
                live = c0 + cols < n_cols
                x = tl.load(xr + c0 + cols, mask=live, other=0.0).to(tl.float32)
                w = tl.load(w_ptr + c0 + cols, mask=live, other=0.0).to(tl.float32)
                b = tl.load(b_ptr + c0 + cols, mask=live, other=0.0).to(tl.float32)
                tl.store(yr + c0 + cols, ((x - mu) * sigma * w + b).to(y_ptr.dtype.element_ty),
                         mask=live)
        if STORE_STATS:
            tl.store(mu_ptr + row, mu)
            tl.store(sigma_ptr + row, sigma)

    @triton.jit
    def layer_norm_bwd_kernel(x_ptr, w_ptr, mu_ptr, sigma_ptr, dy_ptr, dx_ptr, dwp_ptr,
                              dbp_ptr, n_rows, n_cols, rows_per_prog,
                              ONE_BLOCK: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        row0 = pid.to(tl.int64) * rows_per_prog
        dwr, dbr = dwp_ptr + pid.to(tl.int64) * n_cols, dbp_ptr + pid.to(tl.int64) * n_cols
        if ONE_BLOCK:
            live = cols < n_cols
            w = tl.load(w_ptr + cols, mask=live, other=0.0).to(tl.float32)
            acc_w = tl.zeros([BLOCK], tl.float32)
            acc_b = tl.zeros([BLOCK], tl.float32)
            for i in range(0, rows_per_prog):
                row = row0 + i
                ok = row < n_rows  # the last program's block may be short
                m = live & ok
                x = tl.load(x_ptr + row * n_cols + cols, mask=m, other=0.0).to(tl.float32)
                dy = tl.load(dy_ptr + row * n_cols + cols, mask=m, other=0.0).to(tl.float32)
                mu = tl.load(mu_ptr + row, mask=ok, other=0.0)
                sigma = tl.load(sigma_ptr + row, mask=ok, other=0.0)
                xhat = tl.where(m, (x - mu) * sigma, 0.0)
                wdy = w * dy
                c1 = tl.sum(wdy * xhat, axis=0) / n_cols
                c2 = tl.sum(wdy, axis=0) / n_cols
                tl.store(dx_ptr + row * n_cols + cols,
                         (sigma * (wdy - c2 - xhat * c1)).to(dx_ptr.dtype.element_ty), mask=m)
                acc_w += dy * xhat
                acc_b += dy
            tl.store(dwr + cols, acc_w, mask=live)
            tl.store(dbr + cols, acc_b, mask=live)
        else:
            for c0 in range(0, n_cols, BLOCK):
                live = c0 + cols < n_cols
                tl.store(dwr + c0 + cols, tl.zeros([BLOCK], tl.float32), mask=live)
                tl.store(dbr + c0 + cols, tl.zeros([BLOCK], tl.float32), mask=live)
            for i in range(0, rows_per_prog):
                row = row0 + i
                if row < n_rows:
                    xr, dyr = x_ptr + row * n_cols, dy_ptr + row * n_cols
                    mu = tl.load(mu_ptr + row)
                    sigma = tl.load(sigma_ptr + row)
                    s1 = tl.zeros([BLOCK], tl.float32)
                    s2 = tl.zeros([BLOCK], tl.float32)
                    for c0 in range(0, n_cols, BLOCK):
                        live = c0 + cols < n_cols
                        x = tl.load(xr + c0 + cols, mask=live, other=0.0).to(tl.float32)
                        dy = tl.load(dyr + c0 + cols, mask=live, other=0.0).to(tl.float32)
                        w = tl.load(w_ptr + c0 + cols, mask=live, other=0.0).to(tl.float32)
                        wdy = w * dy
                        s1 += wdy * tl.where(live, (x - mu) * sigma, 0.0)
                        s2 += wdy
                    c1 = tl.sum(s1, axis=0) / n_cols
                    c2 = tl.sum(s2, axis=0) / n_cols
                    for c0 in range(0, n_cols, BLOCK):
                        live = c0 + cols < n_cols
                        x = tl.load(xr + c0 + cols, mask=live, other=0.0).to(tl.float32)
                        dy = tl.load(dyr + c0 + cols, mask=live, other=0.0).to(tl.float32)
                        w = tl.load(w_ptr + c0 + cols, mask=live, other=0.0).to(tl.float32)
                        xhat = tl.where(live, (x - mu) * sigma, 0.0)
                        wdy = w * dy
                        tl.store(dx_ptr + row * n_cols + c0 + cols,
                                 (sigma * (wdy - c2 - xhat * c1)).to(dx_ptr.dtype.element_ty),
                                 mask=live)
                        pw = tl.load(dwr + c0 + cols, mask=live, other=0.0)
                        pb = tl.load(dbr + c0 + cols, mask=live, other=0.0)
                        tl.store(dwr + c0 + cols, pw + dy * xhat, mask=live)
                        tl.store(dbr + c0 + cols, pb + dy, mask=live)

    return layer_norm_fwd_kernel, layer_norm_bwd_kernel
