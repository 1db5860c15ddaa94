"""nnop_tpu_torch — the PyTorch and CUDA port of nnop_tpu, for one NVIDIA H100.

The JAX package `nnop_tpu` is the reference; this package mirrors its
layout (`ops/`, `models/`, `runtime/`, `utils/`) and public names. Every
Pallas kernel on the ported path is a kernel written by hand for Hopper
(CUDA C++ under `csrc/`, or Triton), built at first use. On a CPU tensor
each op runs its plain PyTorch version (`ops/naive.py`); on a CUDA tensor
it launches the kernel or raises.

Importing this package imports neither JAX nor Triton, and builds nothing.
"""

from nnop_tpu_torch.ops.attention_decode import decode_attention
from nnop_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_chunked,
)
from nnop_tpu_torch.ops.grouped_matmul import grouped_matmul
from nnop_tpu_torch.ops.kv_write import flush_staging
from nnop_tpu_torch.ops.layer_norm import layer_norm
from nnop_tpu_torch.ops.quantization import (
    QTensor,
    QTensor4,
    dequantize,
    dequantize4,
    quantize,
    quantize4,
)
from nnop_tpu_torch.ops.quantized_matmul import quantized_matmul, quantized_matmul4
from nnop_tpu_torch.ops.rms_norm import rms_norm
from nnop_tpu_torch.ops.rope import RotaryEmbedding, llama_rope
from nnop_tpu_torch.ops.softmax import online_softmax

__all__ = [
    "online_softmax",
    "rms_norm",
    "layer_norm",
    "RotaryEmbedding",
    "llama_rope",
    "flash_attention",
    "flash_attention_chunked",
    "decode_attention",
    "flush_staging",
    "QTensor",
    "quantize",
    "dequantize",
    "quantized_matmul",
    "grouped_matmul",
    "quantized_matmul4",
    "QTensor4",
    "quantize4",
    "dequantize4",
]
