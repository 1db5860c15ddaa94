"""RMS norm forward: a Triton kernel for Hopper.

Replaces nnop_tpu/ops/rms_norm.py:_rms_fwd_impl (`_fwd_kernel_noresid`)
and the `streaming_rowop` route it takes for prefill row counts
(nnop_tpu/ops/streaming.py); both compute the same function, so one
kernel serves every row count.

y = x * rsqrt(mean(x^2) + eps) * (offset + w), accumulated in fp32.

Bound on the H100: device-memory bandwidth. Each row is read once and
written once (2 * 4096 * 2 bytes at Llama-3-8B width in bf16) against
~3 flops per element. The design keeps the row in registers: one program
per row with the whole row in one block (4096 columns), so the reduction
and the scale are one pass over the bytes and nothing intermediate goes
back to memory. The backward (dx, dw) comes with training.
"""

from __future__ import annotations

import functools

import torch

from nnop_tpu_torch.ops.naive import naive_rms_norm
from nnop_tpu_torch.utils.platform import check_cuda_operand

_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_MAX_COLS = 16384


@torch.no_grad()
def rms_norm(x, w, eps: float = 1e-6, offset: float = 0.0):
    """RMS norm over the last axis (x (..., E), w (E,)), fp32 accumulation.
    `offset=1.0` gives Gemma-style (1 + w) scaling."""
    if x.device.type == "cpu":
        return naive_rms_norm(x, w, eps=eps, offset=offset)
    E = x.shape[-1]
    check_cuda_operand("x", x, _DTYPES)
    check_cuda_operand("w", w, _DTYPES, device=x.device)
    if w.shape != (E,):
        raise ValueError(f"w shape {tuple(w.shape)}, expected ({E},)")
    if E > _MAX_COLS:
        raise ValueError(f"row width {E} > {_MAX_COLS} (one row per block)")
    import triton

    kernel = _kernel()
    y = torch.empty_like(x)
    rows = x.numel() // E
    if rows:
        block = triton.next_power_of_2(E)
        kernel[(rows,)](
            x, w, y, E, float(eps), float(offset),
            BLOCK=block, num_warps=max(1, min(16, block // 256)),
        )
        rms_norm.launches += 1
    return y


rms_norm.launches = 0


@functools.cache
def _kernel():
    """Define the Triton kernel. Triton is imported here, at first launch,
    so that the module imports where Triton is missing; the names are
    bound as module globals because Triton resolves them there."""
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def rms_norm_fwd(x_ptr, w_ptr, y_ptr, n_cols, eps, offset,
                     BLOCK: tl.constexpr):
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

    return rms_norm_fwd
