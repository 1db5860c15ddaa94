"""Quantized matrix products: CUDA kernels for Hopper.

Counterpart of nnop_tpu/ops/quantized_matmul.py. The three wrappers run
csrc/qmm.cu, whose source says what bounds each kernel and how:

* `quantized_matmul` (kernel F) — x @ int8/fp8 weights with per-column
  scales; replaces `_qmm_kernel`.
* `quantized_matmul_w8a8` (kernel G) — int8 activations x int8 weights,
  exact int32 sums, then the row and column scales; replaces
  `_w8a8_kernel`. `quantize_act`, which feeds it, is a plain torch op (it
  is plain XLA in the JAX package too).
* `quantized_matmul4` (kernel H) — x @ packed int4 weights with group
  scales; replaces `_qmm4_kernel`.

On a CPU tensor each wrapper runs its plain version (ops/naive.py); on a
CUDA tensor it launches its kernel or raises. On CUDA, F and H take bf16
activations and give bf16 (the serving path's types); G gives bf16 or f32.
"""

from __future__ import annotations

import functools

import torch

from nnop_tpu_torch.ops.naive import (
    naive_quantized_matmul,
    naive_quantized_matmul4,
    naive_quantized_matmul_w8a8,
    quantize_act,
)
from nnop_tpu_torch.ops.quantization import QTensor, QTensor4
from nnop_tpu_torch.utils.build import check_launch, load_library
from nnop_tpu_torch.utils.platform import cdiv, check_cuda_operand

__all__ = ["quantized_matmul", "quantized_matmul_w8a8", "quantized_matmul4", "quantize_act"]

_BK = 64  # K values per kernel stage (csrc/qmm.cu)
_MODES = {torch.int8: 0, torch.float8_e4m3fn: 1}
_MODE_INT4 = 2


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(device, M: int, N: int, K: int) -> int:
    """K splits for F and H: enough blocks for two per SM when the output
    tiles alone are fewer (decode at N = 4096), each split at least four
    K stages long."""
    tiles = cdiv(N, 128) * cdiv(M, 16 if M <= 32 else 64)
    want = 2 * _sm_count(device.index or 0)
    steps = cdiv(K, _BK)
    if tiles >= want or steps < 8:
        return 1
    splits = min(cdiv(want, tiles), steps // 4)
    return cdiv(steps, cdiv(steps, splits))


def _launch_qmm(name, x2, w, scale, mode, N, K, group=0, pack_block=0):
    """The F/H launch: x2 (M, K) bf16 contiguous on CUDA -> (M, N) bf16."""
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x2.device)
    splits = _splits(x2.device, M, N, K)
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x2.device)
               if splits > 1 else None)
    err = load_library().nnop_qmm(
        x2.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None, M, N, K, mode, group,
        pack_block, splits, torch.cuda.current_stream(x2.device).cuda_stream,
    )
    check_launch(name, err)
    return out


def _bf16_rows(name, x, K, out_dtype):
    """x (..., K) -> a contiguous (M, K) bf16 view on CUDA, or raise."""
    if x.dtype != torch.bfloat16 or (out_dtype or x.dtype) != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bf16 activations and gives bf16; got "
                        f"{x.dtype} -> {out_dtype or x.dtype}")
    x2 = x.reshape(-1, K).contiguous()
    check_cuda_operand("x", x2, (torch.bfloat16,))
    return x2


@torch.no_grad()
def quantized_matmul(x, w: QTensor, *, out_dtype=None):
    """x (..., K) @ w (values (K, N) int8 or fp8-e4m3, scale (N,) f32).

    Both operands in bf16 (f32 for f32 activations, on the CPU), fp32
    accumulation, the scale applied once to the fp32 sum. Returns
    (..., N) in out_dtype (default x.dtype)."""
    if w.axis != 0:
        raise ValueError("quantized_matmul expects scale over axis 0 (per-N)")
    K, N = w.values.shape
    if x.shape[-1] != K:
        raise ValueError(f"K mismatch: x {x.shape[-1]} vs w {K}")
    if x.device.type == "cpu":
        return naive_quantized_matmul(x, w, out_dtype)
    if w.values.dtype not in _MODES:
        raise TypeError(f"quantized_matmul: weights of {w.values.dtype}, expected int8 or fp8")
    x2 = _bf16_rows("quantized_matmul", x, K, out_dtype)
    check_cuda_operand("w.values", w.values, (w.values.dtype,), device=x2.device)
    check_cuda_operand("w.scale", w.scale, (torch.float32,), device=x2.device)
    if w.scale.shape != (N,):
        raise ValueError(f"scale shape {tuple(w.scale.shape)}, expected ({N},)")
    if x2.shape[0] == 0:
        return x.new_empty((*x.shape[:-1], N))
    out = _launch_qmm("quantized_matmul", x2, w.values, w.scale, _MODES[w.values.dtype], N, K)
    quantized_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


@torch.no_grad()
def quantized_matmul4(x, w: QTensor4, *, out_dtype=None):
    """x (..., K) @ packed int4 w (QTensor4). Each group scale is folded
    into its weights in f32 and the result rounded to bf16 (f32 for f32
    activations, on the CPU) before an fp32-accumulated product. If
    quantize4 padded K, x is zero-padded to match."""
    K, N = x.shape[-1], w.packed.shape[1]
    P, kp = w.pack_block, w.k_dim
    if not (K == kp or (K < kp and kp - K < P)):
        raise ValueError(f"K mismatch: x {K} vs packed {kp} (pack_block {P})")
    if x.device.type == "cpu":
        return naive_quantized_matmul4(x, w, out_dtype)
    if P % 128 or w.group % 32 or (P // 2) % w.group:
        raise ValueError(f"quantized_matmul4: the kernel needs pack_block % 128 == 0 and "
                         f"group % 32 == 0 dividing pack_block/2; got {P}, {w.group}")
    x2 = _bf16_rows("quantized_matmul4", x, K, out_dtype)
    if kp != K:
        x2 = torch.nn.functional.pad(x2, (0, kp - K))
    check_cuda_operand("w.packed", w.packed, (torch.int8,), device=x2.device)
    check_cuda_operand("w.scale", w.scale, (torch.float32,), device=x2.device)
    if w.scale.shape != (kp // w.group, N):
        raise ValueError(f"scale shape {tuple(w.scale.shape)}, expected ({kp // w.group}, {N})")
    if x2.shape[0] == 0:
        return x.new_empty((*x.shape[:-1], N))
    out = _launch_qmm("quantized_matmul4", x2, w.packed, w.scale, _MODE_INT4, N, kp,
                      w.group, P)
    quantized_matmul4.launches += 1
    return out.reshape(*x.shape[:-1], N)


@torch.no_grad()
def quantized_matmul_w8a8(x, w: QTensor, *, out_dtype=None):
    """W8A8: int8 activations x int8 weights, exact int32 sums, then
    (acc * xs) * ws in f32.

    `x` is a float tensor (quantized per row here; out_dtype defaults to
    x.dtype) or a `(values, scale)` pair from quantize_act (out_dtype
    defaults to bf16)."""
    if w.axis != 0:
        raise ValueError("quantized_matmul_w8a8 expects scale over axis 0")
    if w.values.dtype != torch.int8:
        raise ValueError("quantized_matmul_w8a8 requires int8 weights")
    if isinstance(x, tuple):
        xv, xs = x
        out_dtype = out_dtype or torch.bfloat16
    else:
        xv, xs = quantize_act(x)
        out_dtype = out_dtype or x.dtype
    K, N = w.values.shape
    if xv.shape[-1] != K:
        raise ValueError(f"K mismatch: x {xv.shape[-1]} vs w {K}")
    lead = xv.shape[:-1]
    if xv.device.type == "cpu":
        return naive_quantized_matmul_w8a8(xv, xs, w, out_dtype)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantized_matmul_w8a8: out_dtype {out_dtype}, expected bf16 or f32")
    xv2 = xv.reshape(-1, K).contiguous()
    xs2 = xs.reshape(-1).float().contiguous()
    check_cuda_operand("xv", xv2, (torch.int8,))
    check_cuda_operand("xs", xs2, (torch.float32,), device=xv2.device)
    check_cuda_operand("w.values", w.values, (torch.int8,), device=xv2.device)
    check_cuda_operand("w.scale", w.scale, (torch.float32,), device=xv2.device)
    M = xv2.shape[0]
    if xs2.shape != (M,) or w.scale.shape != (N,):
        raise ValueError(f"scales {tuple(xs2.shape)}, {tuple(w.scale.shape)}; expected "
                         f"({M},), ({N},)")
    out = torch.empty((M, N), dtype=out_dtype, device=xv2.device)
    if M == 0:
        return out.reshape(*lead, N)
    err = load_library().nnop_qmm_w8a8(
        xv2.data_ptr(), xs2.data_ptr(), w.values.data_ptr(), w.scale.data_ptr(),
        out.data_ptr(), M, N, K, int(out_dtype == torch.float32),
        torch.cuda.current_stream(xv2.device).cuda_stream,
    )
    check_launch("quantized_matmul_w8a8", err)
    quantized_matmul_w8a8.launches += 1
    return out.reshape(*lead, N)


quantized_matmul.launches = 0
quantized_matmul4.launches = 0
quantized_matmul_w8a8.launches = 0
