"""Staging flush into the stacked floating-point KV caches: a CUDA kernel.

`flush_staging` wraps csrc/kv_flush.cu, which replaces
nnop_tpu/ops/kv_write.py:flush_staging (`_flush_kernel`) for
floating-point and int8 caches; an int8 cache is quantized while it is
flushed, one scale per token. The caches and scales are updated in place
(the TPU version aliased the caches through the pallas call and
scattered the scales after it). See the kernel source for what bounds it
and how. The int8 mode has its own launch count,
`flush_staging.int8_launches`, beside `launches`.
"""

from __future__ import annotations

import torch

from nnop_tpu_torch.ops.naive import naive_flush_staging
from nnop_tpu_torch.utils.build import check_launch, load_library
from nnop_tpu_torch.utils.platform import check_cuda_operand


@torch.no_grad()
def flush_staging(k_cache, v_cache, k_scale, v_scale, k_stage, v_stage, base_lens):
    """Flush staged tokens into the stacked per-layer caches, in place.

    k_cache/v_cache: (nl, B, KH, S, E) floating point, or int8 with
      k_scale/v_scale (nl, B, KH, S) f32.
    k_stage/v_stage: (B, nl, KH, W, E) bf16 — W staged tokens per slot at
      global positions [base_lens[b], base_lens[b] + W). All W rows are
      written even when fewer are live (the tail lies above the slot's
      length and is overwritten by later flushes or never read).
    base_lens: (B,) int32. The caller keeps base + W within S.
    Returns (k_cache, v_cache, k_scale, v_scale), updated in place.
    """
    quantized = k_cache.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come with an int8 cache, and only with one")
    nl, B, KH, S, E = k_cache.shape
    W = k_stage.shape[3]
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"v_cache shape {tuple(v_cache.shape)} != k_cache shape")
    if k_stage.shape != (B, nl, KH, W, E) or v_stage.shape != k_stage.shape:
        raise ValueError(f"staging shape {tuple(k_stage.shape)} does not match the cache "
                         f"{tuple(k_cache.shape)}")
    if quantized and (k_scale.shape != k_cache.shape[:4] or v_scale.shape != k_scale.shape):
        raise ValueError(f"scale shape {tuple(k_scale.shape)}, expected {tuple(k_cache.shape[:4])}")
    if k_cache.device.type == "cpu":
        naive_flush_staging(k_cache, v_cache, k_stage, v_stage, base_lens, k_scale, v_scale)
        return k_cache, v_cache, k_scale, v_scale
    check_cuda_operand("k_cache", k_cache, (torch.bfloat16, torch.float32, torch.int8))
    check_cuda_operand("v_cache", v_cache, (k_cache.dtype,), device=k_cache.device)
    check_cuda_operand("k_stage", k_stage, (torch.bfloat16,), device=k_cache.device)
    check_cuda_operand("v_stage", v_stage, (torch.bfloat16,), device=k_cache.device)
    check_cuda_operand("base_lens", base_lens, (torch.int32,), device=k_cache.device)
    if quantized:
        check_cuda_operand("k_scale", k_scale, (torch.float32,), device=k_cache.device)
        check_cuda_operand("v_scale", v_scale, (torch.float32,), device=k_cache.device)
    if base_lens.shape != (B,):
        raise ValueError(f"base_lens shape {tuple(base_lens.shape)}, expected ({B},)")
    cache_kind = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}[k_cache.dtype]
    err = load_library().nnop_flush_staging(
        k_stage.data_ptr(), v_stage.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
        base_lens.data_ptr(), B, nl, KH, S, W, E, cache_kind,
        torch.cuda.current_stream(k_cache.device).cuda_stream,
    )
    check_launch("flush_staging", err)
    flush_staging.launches += 1
    if quantized:
        flush_staging.int8_launches += 1
    return k_cache, v_cache, k_scale, v_scale


flush_staging.launches = 0
flush_staging.int8_launches = 0
