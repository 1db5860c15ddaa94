"""Grouped (mixture-of-experts) matrix products: kernel I for Hopper.

Counterpart of nnop_tpu/ops/grouped_matmul.py, with its functions and
signatures. Rows come sorted by expert in blocks of `block_m`
(models/moe.py:sort_tokens_by_expert) and block b multiplies by expert
`block_groups[b]`: out[b*block_m:(b+1)*block_m] = x[those rows] @ w[e].
Each wrapper runs csrc/gmm.cu (kernel I, one kernel in four modes, built
on csrc/qmm.cuh):

* `grouped_matmul` — bf16 experts (E, K, N); replaces `_gmm_fwd_impl`.
  Differentiable in x and w (a torch.autograd.Function, as the JAX
  `custom_vjp`): dx is kernel I on dy with the experts transposed
  (materialized once per backward, as `_gmm_bwd` does), dw is
  `grouped_matmul_dw`.
* `grouped_matmul_dw` — the weight gradient, csrc/gmm_dw.cu; replaces
  `_gmm_dw` (`_gmm_dw_kernel`).
* `grouped_matmul_quantized` — int8 experts with (E, N) scales;
  replaces `grouped_matmul_quantized`. Forward only.
* `grouped_matmul_w8a8` — int8 rows (quantized per row here by the plain
  `quantize_act`, as ops/quantized_matmul.py does) x int8 experts, exact
  int32 sums; replaces `grouped_matmul_w8a8`. Forward only.
* `_grouped_matmul_q4` — packed int4 experts (`quantize4_experts`) with
  group scales; replaces `_grouped_matmul_q4`. Forward only.

On a CPU tensor each wrapper runs its plain version (ops/naive.py); on a
CUDA tensor it launches its kernel or raises. On CUDA the activations are
bf16 (int8 for W8A8) and the output bf16 (W8A8: bf16 or f32); f32
activations raise, as for F and H. The forward-only products raise for
activations that require a gradient (quantized experts are not trained).
`block_rows` (the port's addition, optional): the real rows of each
block, which come first in it; kernel I writes zeros for a tile of rows
past them without streaming its expert's weights, so the caller promises
those rows of x are zero (the sort glue makes them so, and the backward's
dy is zero there: the layer gathers y[dest]), and the dw kernel skips
them. The block_m / block_n / block_k arguments of the TPU kernels'
tiling are accepted and only block_m is used.
"""

from __future__ import annotations

import torch

from nnop_tpu_torch.ops.naive import (
    naive_grouped_matmul,
    naive_grouped_matmul_dw,
    naive_grouped_matmul4,
    naive_grouped_matmul_quantized,
    naive_grouped_matmul_w8a8,
    quantize_act,
)
from nnop_tpu_torch.ops.quantization import QTensor, QTensor4, quantize4
from nnop_tpu_torch.utils.build import check_launch, load_library
from nnop_tpu_torch.utils.platform import check_cuda_operand

__all__ = ["grouped_matmul", "grouped_matmul_dw", "grouped_matmul_quantized",
           "grouped_matmul_w8a8", "quantize4_experts"]

_MODE_INT8, _MODE_INT4, _MODE_W8A8, _MODE_BF16 = 0, 2, 3, 4  # csrc/qmm.cuh:Mode


def _check_rows(Tp: int, K: int, Kw: int, block_m: int, block_groups):
    if Kw != K:
        raise ValueError(f"K mismatch: x {K} vs w {Kw}")
    if Tp % block_m != 0:
        raise ValueError(f"rows {Tp} not a multiple of block_m {block_m}")
    if tuple(block_groups.shape) != (Tp // block_m,):
        raise ValueError(f"block_groups {tuple(block_groups.shape)} != ({Tp // block_m},)")


def _cuda_groups(x, block_groups, block_rows):
    """block_groups and block_rows (or None) as contiguous int32 on x's card."""
    bg = block_groups.to(torch.int32).contiguous()
    check_cuda_operand("block_groups", bg, (torch.int32,), device=x.device)
    rows = None
    if block_rows is not None:
        rows = block_rows.to(torch.int32).contiguous()
        check_cuda_operand("block_rows", rows, (torch.int32,), device=x.device)
        if rows.shape != bg.shape:
            raise ValueError(f"block_rows {tuple(rows.shape)} != {tuple(bg.shape)}")
    return bg, rows


def _launch(name, mode, x, xs, w, scale, block_groups, block_rows, block_m, N, out_dtype,
            group=0, pack_block=0):
    """Kernel I on contiguous CUDA operands: x (Tp, K) -> (Tp, N)."""
    Tp, K = x.shape
    if block_m % 16:
        raise ValueError(f"{name}: the kernel needs block_m % 16 == 0, got {block_m}")
    bg, rows = _cuda_groups(x, block_groups, block_rows)
    out = torch.empty((Tp, N), dtype=out_dtype, device=x.device)
    if Tp == 0:
        return out
    err = load_library().nnop_gmm(
        x.data_ptr(), xs.data_ptr() if xs is not None else None, w.data_ptr(),
        scale.data_ptr() if scale is not None else None, out.data_ptr(), bg.data_ptr(),
        rows.data_ptr() if rows is not None else None, Tp, N, K, block_m, mode, group,
        pack_block, int(out_dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(name, err)
    return out


def _bf16_x(name, x, out_dtype):
    if x.dtype != torch.bfloat16 or (out_dtype or x.dtype) != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bf16 activations and gives bf16; got "
                        f"{x.dtype} -> {out_dtype or x.dtype}")
    x = x.contiguous()
    check_cuda_operand("x", x, (torch.bfloat16,))
    return x


def _refuse_grad(name, x):
    if torch.is_grad_enabled() and isinstance(x, torch.Tensor) and x.requires_grad:
        raise RuntimeError(f"{name} is forward-only: it has no backward (quantized experts "
                           "are not trained)")


def _gmm_bf16(x, w, block_groups, block_m, block_rows, plain, dx=False):
    """Kernel I's bf16 mode (or the plain product): (Tp, K) @ w per block.
    dx: the backward's launch, also counted as `grouped_matmul.dx_launches`."""
    if plain or x.device.type == "cpu":
        return naive_grouped_matmul(x, w, block_groups, block_m)
    x = _bf16_x("grouped_matmul", x, None)
    check_cuda_operand("w", w, (torch.bfloat16,), device=x.device)
    out = _launch("grouped_matmul", _MODE_BF16, x, None, w, None, block_groups, block_rows,
                  block_m, w.shape[2], torch.bfloat16)
    grouped_matmul.launches += 1
    if dx:
        grouped_matmul.dx_launches += 1
    return out


class _GroupedMatmul(torch.autograd.Function):
    """nnop_tpu/ops/grouped_matmul.py:_grouped_matmul (custom_vjp): dx =
    dy @ w[e]^T per block (kernel I on the transposed experts), dw =
    grouped_matmul_dw. plain: the plain versions of all three."""

    @staticmethod
    def forward(ctx, x, w, block_groups, block_rows, block_m, plain):
        ctx.save_for_backward(x, w, block_groups, block_rows)
        ctx.block_m, ctx.plain = block_m, plain
        return _gmm_bf16(x, w, block_groups, block_m, block_rows, plain)

    @staticmethod
    def backward(ctx, dy):
        x, w, block_groups, block_rows = ctx.saved_tensors
        bm, plain = ctx.block_m, ctx.plain
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _gmm_bf16(dy, w.transpose(1, 2).contiguous(), block_groups, bm, block_rows,
                           plain, dx=True)
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul_dw(x, dy, block_groups, block_m=bm, n_experts=w.shape[0],
                                   block_rows=block_rows, plain=plain).to(w.dtype)
        return dx, dw, None, None, None, None


def grouped_matmul(x, w, block_groups, *, block_m: int = 128, block_n: int = 512,
                   block_k: int = 512, block_rows=None, plain: bool = False):
    """out[block i] = x[block i] @ w[block_groups[i]].

    x: (Tp, K) expert-sorted, block_m-aligned rows; w: (E, K, N) stacked
    experts; block_groups: (Tp/block_m,) int expert per block, in [0, E)
    (non-decreasing, as the sort glue makes it). Both operands in bf16
    (f32 for f32 activations, on the CPU), fp32 accumulation. Returns
    (Tp, N) in x.dtype. Differentiable in x and w: the backward runs
    kernel I for dx and grouped_matmul_dw for dw. plain: the plain
    versions, forward and backward, on any device (the oracle)."""
    del block_n, block_k
    Tp, K = x.shape
    E, Kw, N = w.shape
    _check_rows(Tp, K, Kw, block_m, block_groups)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedMatmul.apply(x, w, block_groups, block_rows, block_m, plain)
    return _gmm_bf16(x, w, block_groups, block_m, block_rows, plain)


def grouped_matmul_dw(x, dy, block_groups, *, block_m: int, n_experts: int, block_rows=None,
                      plain: bool = False):
    """dw[e] = sum over expert e's blocks b of x_b^T @ dy_b: the grouped
    product's weight gradient (nnop_tpu/ops/grouped_matmul.py:_gmm_dw).

    x: (Tp, K), dy: (Tp, N) in the sorted layout; block_groups as in
    grouped_matmul; block_rows: the real rows of each block (rows past
    them count as zero). fp32 sums; returns (n_experts, K, N) in x.dtype,
    exact zeros for an expert with no row. On CUDA x and dy are bf16
    (csrc/gmm_dw.cu); plain: the plain version on any device."""
    Tp, K = x.shape
    if dy.dim() != 2 or dy.shape[0] != Tp:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x {tuple(x.shape)}")
    N = dy.shape[1]
    _check_rows(Tp, K, K, block_m, block_groups)
    if plain or x.device.type == "cpu":
        return naive_grouped_matmul_dw(x, dy, block_groups, block_m, n_experts, block_rows)
    x = _bf16_x("grouped_matmul_dw", x, None)
    dy = dy.contiguous()
    check_cuda_operand("dy", dy, (torch.bfloat16,), device=x.device)
    bg, rows = _cuda_groups(x, block_groups, block_rows)
    # every element is written by the kernel (zeros for an expert with no row)
    dw = torch.empty((n_experts, K, N), dtype=torch.bfloat16, device=x.device)
    err = load_library().nnop_gmm_dw(
        x.data_ptr(), dy.data_ptr(), dw.data_ptr(), bg.data_ptr(),
        rows.data_ptr() if rows is not None else None, Tp, K, N, n_experts, block_m,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("grouped_matmul_dw", err)
    grouped_matmul_dw.launches += 1
    return dw


def grouped_matmul_quantized(x, wq: QTensor, block_groups, *, block_m: int = 128,
                             block_n: int = 2048, block_k: int = 1024, out_dtype=None,
                             block_rows=None):
    """Grouped product with int8 stacked experts: wq values (E, K, N) int8,
    scale (E, N) f32, axis 1. Both operands in the compute dtype, fp32
    accumulation, the (expert, column) scale applied once to the sum.
    Forward only (serving): raises for activations that require a
    gradient."""
    del block_n, block_k
    _refuse_grad("grouped_matmul_quantized", x)
    if not isinstance(wq, QTensor) or wq.axis != 1:
        raise ValueError("expected QTensor with scale over axis 1 (per-E,N)")
    Tp, K = x.shape
    E, Kw, N = wq.values.shape
    _check_rows(Tp, K, Kw, block_m, block_groups)
    if x.device.type == "cpu":
        return naive_grouped_matmul_quantized(x, wq, block_groups, block_m, out_dtype)
    x = _bf16_x("grouped_matmul_quantized", x, out_dtype)
    check_cuda_operand("wq.values", wq.values, (torch.int8,), device=x.device)
    check_cuda_operand("wq.scale", wq.scale, (torch.float32,), device=x.device)
    if wq.scale.shape != (E, N):
        raise ValueError(f"scale shape {tuple(wq.scale.shape)}, expected ({E}, {N})")
    out = _launch("grouped_matmul_quantized", _MODE_INT8, x, None, wq.values, wq.scale,
                  block_groups, block_rows, block_m, N, torch.bfloat16)
    grouped_matmul_quantized.launches += 1
    return out


def grouped_matmul_w8a8(x, wq: QTensor, block_groups, *, block_m: int = 128,
                        block_n: int = 2048, block_k: int = 1024, out_dtype=None,
                        block_rows=None):
    """Grouped W8A8: int8 rows x int8 stacked experts, exact int32 sums,
    then (acc * xs) * ws in f32.

    x: (Tp, K) float (quantized per row here; out_dtype defaults to
    x.dtype) or a (values int8, scale (Tp, 1) f32) pair (out_dtype
    defaults to bf16); wq as in grouped_matmul_quantized. Forward only:
    raises under autograd."""
    del block_n, block_k
    _refuse_grad("grouped_matmul_w8a8", x)
    if not isinstance(wq, QTensor) or wq.axis != 1:
        raise ValueError("expected QTensor with scale over axis 1 (per-E,N)")
    if wq.values.dtype != torch.int8:
        raise ValueError("grouped_matmul_w8a8 requires int8 weights")
    if isinstance(x, tuple):
        xv, xs = x
        out_dtype = out_dtype or torch.bfloat16
    else:
        xv, xs = quantize_act(x)
        out_dtype = out_dtype or x.dtype
    Tp, K = xv.shape
    E, Kw, N = wq.values.shape
    _check_rows(Tp, K, Kw, block_m, block_groups)
    if xv.device.type == "cpu":
        return naive_grouped_matmul_w8a8(xv, xs, wq, block_groups, block_m, out_dtype)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"grouped_matmul_w8a8: out_dtype {out_dtype}, expected bf16 or f32")
    xv, xs = xv.contiguous(), xs.reshape(-1).float().contiguous()
    check_cuda_operand("xv", xv, (torch.int8,))
    check_cuda_operand("xs", xs, (torch.float32,), device=xv.device)
    check_cuda_operand("wq.values", wq.values, (torch.int8,), device=xv.device)
    check_cuda_operand("wq.scale", wq.scale, (torch.float32,), device=xv.device)
    if xs.shape != (Tp,) or wq.scale.shape != (E, N):
        raise ValueError(f"scales {tuple(xs.shape)}, {tuple(wq.scale.shape)}; expected "
                         f"({Tp},), ({E}, {N})")
    out = _launch("grouped_matmul_w8a8", _MODE_W8A8, xv, xs, wq.values, wq.scale, block_groups,
                  block_rows, block_m, N, out_dtype)
    grouped_matmul_w8a8.launches += 1
    return out


def quantize4_experts(w, *, group: int = 128, pack_block: int = 1024) -> QTensor4:
    """Stacked (E, K, N) -> QTensor4 with (E, Kp/2, N) packed planes and
    (E, Kp/group, N) scales, each expert quantized by quantize4."""
    qs = [quantize4(we, group=group, pack_block=pack_block) for we in w]
    return QTensor4(torch.stack([q.packed for q in qs]), torch.stack([q.scale for q in qs]),
                    qs[0].group, qs[0].pack_block)


def _grouped_matmul_q4(x, wq: QTensor4, block_groups, *, block_m: int, block_n: int = 2048,
                       out_dtype=None, block_rows=None):
    """Grouped product with packed int4 stacked experts (quantize4_experts):
    each group scale folded into its nibbles in f32 and the result rounded
    to the compute dtype, then an fp32-accumulated product. If quantize4
    padded K, x is zero-padded to match. Forward only."""
    del block_n
    _refuse_grad("_grouped_matmul_q4", x)
    Tp, K = x.shape
    E, _, N = wq.packed.shape
    P, kp = wq.pack_block, wq.k_dim
    if not (K == kp or (K < kp and kp - K < P)):
        raise ValueError(f"K mismatch: x {K} vs packed {kp} (pack {P})")
    _check_rows(Tp, K, K, block_m, block_groups)
    if x.device.type == "cpu":
        return naive_grouped_matmul4(x, wq, block_groups, block_m, out_dtype)
    if P % 128 or wq.group % 32 or (P // 2) % wq.group:
        raise ValueError(f"_grouped_matmul_q4: the kernel needs pack_block % 128 == 0 and "
                         f"group % 32 == 0 dividing pack_block/2; got {P}, {wq.group}")
    x = _bf16_x("_grouped_matmul_q4", x, out_dtype)
    if kp != K:
        x = torch.nn.functional.pad(x, (0, kp - K))
    check_cuda_operand("wq.packed", wq.packed, (torch.int8,), device=x.device)
    check_cuda_operand("wq.scale", wq.scale, (torch.float32,), device=x.device)
    if wq.scale.shape != (E, kp // wq.group, N):
        raise ValueError(f"scale shape {tuple(wq.scale.shape)}, expected "
                         f"({E}, {kp // wq.group}, {N})")
    out = _launch("_grouped_matmul_q4", _MODE_INT4, x, None, wq.packed, wq.scale, block_groups,
                  block_rows, block_m, N, torch.bfloat16, wq.group, P)
    _grouped_matmul_q4.launches += 1
    return out


grouped_matmul.launches = 0  # forward and dx
grouped_matmul.dx_launches = 0
grouped_matmul_dw.launches = 0
grouped_matmul_quantized.launches = 0
grouped_matmul_w8a8.launches = 0
_grouped_matmul_q4.launches = 0
