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
from nnop_tpu_torch.ops.kv_write import flush_staging
from nnop_tpu_torch.ops.rms_norm import rms_norm
from nnop_tpu_torch.ops.rope import RotaryEmbedding, llama_rope

__all__ = [
    "rms_norm",
    "RotaryEmbedding",
    "llama_rope",
    "flash_attention",
    "flash_attention_chunked",
    "decode_attention",
    "flush_staging",
]
