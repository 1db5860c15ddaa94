"""Quantized Llama weights: the quantized parameter tree and the product
dispatch.

Counterpart of nnop_tpu/models/quantized.py. Projection weights become
QTensors (int8/fp8, per-output-channel scales) or QTensor4s (packed int4,
group scales); norms and the embedding table stay floating point. A MoE
layer's stacked experts become int8 with per-(expert, column) scales or
per-expert packed int4 (ops/grouped_matmul.py:quantize4_experts), served
by kernel I; its router stays floating point. `qmatmul` is the `matmul=` hook of
models.llama.forward and the engine's product dispatch.
"""

from __future__ import annotations

import functools

import torch

from nnop_tpu_torch.ops import naive
from nnop_tpu_torch.ops.grouped_matmul import quantize4_experts
from nnop_tpu_torch.ops.quantization import QTensor, QTensor4, quantize, quantize4
from nnop_tpu_torch.ops.quantized_matmul import (
    quantized_matmul,
    quantized_matmul4,
    quantized_matmul_w8a8,
    quantize_act,
)

# the projections, and the engine's fused ones (quantizing a fused weight
# gives the bytes of fusing the quantized parts: the scales are per column)
_QUANT_KEYS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head", "wqkv", "w_gateup"}
_EXPERT_KEYS = ("w_gate", "w_up", "w_down", "w_gateup")  # stacked in a MoE layer
W8A8_MIN_ROWS = 256  # products with at least this many rows run W8A8


def quantize_params(params, dtype=torch.int8, *, wbits: int = 8, group: int = 128):
    """Quantize the projection weights: int8/fp8 with per-out-channel
    scales (wbits=8) or packed int4 with per-(K-group, channel) scales
    (wbits=4). Stacked MoE experts (E, K, N): int8 with per-(E, N)
    scales (axis 1, int8 whatever `dtype` is, as in the JAX package) or
    per-expert packed int4; the router stays floating point."""

    def q(w):
        if wbits == 4:
            return quantize4(w, group=group)
        return quantize(w, axis=0, dtype=dtype)

    def q_experts(w):
        if wbits == 4:
            return quantize4_experts(w, group=group)
        return quantize(w, axis=1)

    def q_layer(layer):
        experts = _EXPERT_KEYS if "w_router" in layer else ()
        return {k: q_experts(v) if k in experts else q(v) if k in _QUANT_KEYS else v
                for k, v in layer.items()}

    out = dict(params)
    if "lm_head" in params:
        out["lm_head"] = q(params["lm_head"])
    out["layers"] = [q_layer(layer) for layer in params["layers"]]
    return out


def qmatmul(x, w, *, w8a8: bool = False, plain: bool = False):
    """x (..., K) @ w for a QTensor, a QTensor4 or a plain tensor.

    w8a8: an int8 QTensor product with at least W8A8_MIN_ROWS rows runs
    W8A8 (per-row activation quantization; the JAX engine's prefill
    routing); smaller products, fp8 and int4 stay weight-only. plain: the
    plain versions instead of the kernels (one product dequantized at a
    time), the reference the kernels are held to on the card."""
    if isinstance(w, QTensor):
        if w8a8 and w.values.dtype == torch.int8 and x.numel() // x.shape[-1] >= W8A8_MIN_ROWS:
            if plain:
                xv, xs = quantize_act(x)
                return naive.naive_quantized_matmul_w8a8(xv, xs, w, x.dtype)
            return quantized_matmul_w8a8(x, w)
        return naive.naive_quantized_matmul(x, w) if plain else quantized_matmul(x, w)
    if isinstance(w, QTensor4):
        return naive.naive_quantized_matmul4(x, w) if plain else quantized_matmul4(x, w)
    return x @ w


qmatmul_w8a8 = functools.partial(qmatmul, w8a8=True)
