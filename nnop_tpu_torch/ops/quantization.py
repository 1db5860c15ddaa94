"""Quantization primitives: symmetric int8 / fp8 with per-channel scales,
and packed int4 with group scales.

Counterpart of nnop_tpu/ops/quantization.py. The byte layouts are the
JAX package's bit for bit, so quantized trees cross between the packages
(models/weights.py:params_from_numpy). Plain PyTorch: quantization runs
once (weights) or per flush (the KV cache); the dequantization is what
the kernels fuse (ops/quantized_matmul.py, ops/attention_decode.py).

Rounding is `torch.round` (half to even, like `jnp.round`), and values
are divided by the scale, never multiplied by its reciprocal: `div_exact`
divides by a constant on every device (PyTorch's CUDA division by a
Python scalar multiplies by the reciprocal, which differs from the
division in the last bit).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

INT8_MAX = 127.0
FP8_MAX = 448.0  # float8_e4m3fn
INT4_MAX = 7.0


@functools.cache
def _constant(value: float, dtype, device):
    return torch.tensor(value, dtype=dtype, device=device)


def div_exact(x, c: float):
    """x / c, correctly rounded on the CPU and on CUDA alike."""
    return x / _constant(c, x.dtype, x.device)


@dataclasses.dataclass
class QTensor:
    """values: int8 / float8_e4m3fn tensor; scale: f32, the shape of
    `values` with `axis` removed."""

    values: torch.Tensor
    scale: torch.Tensor
    axis: int


@dataclasses.dataclass
class QTensor4:
    """packed: int8 (K/2, N) nibble pairs; scale: f32 (K/group, N). Stacked
    experts (ops/grouped_matmul.py:quantize4_experts) add a leading E axis
    to both.

    Inside each `pack_block` P of K, packed row r holds original row r in
    its low nibble and row r + P/2 in its high nibble."""

    packed: torch.Tensor
    scale: torch.Tensor
    group: int
    pack_block: int

    @property
    def k_dim(self) -> int:
        return 2 * self.packed.shape[-2]


def quantize(x: torch.Tensor, *, axis: int = -1, dtype=torch.int8) -> QTensor:
    """Symmetric per-channel quantization; the scale is taken over `axis`."""
    axis = axis % x.ndim
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    qmax = INT8_MAX if dtype == torch.int8 else FP8_MAX
    scale = div_exact(torch.clamp(amax, min=1e-8), qmax)
    scaled = xf / scale
    if dtype == torch.int8:
        values = torch.clamp(torch.round(scaled), -INT8_MAX, INT8_MAX).to(torch.int8)
    else:
        values = scaled.to(dtype)
    return QTensor(values, scale.squeeze(axis), axis)


def dequantize(q: QTensor) -> torch.Tensor:
    return q.values.float() * q.scale.unsqueeze(q.axis)


def _pick_pack_block(k: int, requested: int) -> int:
    for p in (requested, 1024, 512, 256):
        if p <= requested and k % p == 0:
            return p
    return 256  # the caller pads K to a multiple of this


def quantize4(w: torch.Tensor, *, group: int = 128, pack_block: int = 1024) -> QTensor4:
    """Symmetric int4 quantization of a (K, N) weight with scales per
    (group of K rows, N). K is zero-padded to a multiple of the pack
    block (padded groups get the 1e-8 floor scale and zero values)."""
    if w.ndim != 2:
        raise ValueError(f"quantize4 expects (K, N) weights, got {tuple(w.shape)}")
    K, N = w.shape
    p = _pick_pack_block(K, pack_block)
    wf = w.float()
    if K % p:
        wf = torch.nn.functional.pad(wf, (0, 0, 0, -K % p))
        K = wf.shape[0]
    if group > p // 2 or (p // 2) % group != 0:
        raise ValueError(f"group {group} must divide pack_block/2 {p // 2}")
    amax = wf.reshape(K // group, group, N).abs().amax(dim=1)
    scale = div_exact(torch.clamp(amax, min=1e-8), INT4_MAX)
    q = torch.clamp(torch.round(wf / scale.repeat_interleave(group, dim=0)),
                    -INT4_MAX, INT4_MAX).to(torch.int32)
    blocks = q.reshape(K // p, p, N)
    lo, hi = blocks[:, : p // 2], blocks[:, p // 2 :]
    byte = (lo & 0xF) | ((hi & 0xF) << 4)  # [0, 255]
    packed = torch.where(byte >= 128, byte - 256, byte).to(torch.int8).reshape(K // 2, N)
    return QTensor4(packed, scale, group, p)


def unpack4(q: QTensor4) -> torch.Tensor:
    """The packed nibbles as int32 values in [-8, 7], (K, N)."""
    p, (kh, n) = q.pack_block, q.packed.shape
    b = q.packed.to(torch.int32).reshape(kh // (p // 2), p // 2, n)
    lo = (b << 28) >> 28
    hi = b >> 4
    return torch.cat([lo, hi], dim=1).reshape(2 * kh, n)


def dequantize4(q: QTensor4) -> torch.Tensor:
    """Reference unpack: (K, N) float32 (K padded to the pack block)."""
    return unpack4(q).float() * q.scale.repeat_interleave(q.group, dim=0)
