"""KV-cache writes: the staging flush (linear and paged) and the one-token
write, CUDA kernels.

`flush_staging`, `flush_staging_paged` and `write_kv_token` wrap
csrc/kv_flush.cu, which replaces nnop_tpu/ops/kv_write.py's
`flush_staging` (`_flush_kernel`), `flush_staging_paged`
(`_paged_flush_kernel`) and `write_kv_token` (`_write_kernel`) for
floating-point and int8 caches; an int8 cache is quantized while it is
flushed, one scale per token. Caches, pools and scales are updated in
place (the TPU versions aliased them through the pallas call and
scattered the scales after it). See the kernel source for what bounds it
and how. The flushes' int8 modes have their own launch counts,
`int8_launches`, beside `launches`; `flush_staging.mode_launches` counts
its launches by (head dim, int8).
"""

from __future__ import annotations

import torch

from nnop_tpu_torch.ops.naive import (
    naive_flush_staging,
    naive_flush_staging_paged,
    naive_write_kv_token,
)
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
    if _flush("flush_staging", k_cache, v_cache, k_scale, v_scale, k_stage, v_stage, base_lens,
              None):
        flush_staging.launches += 1
        if k_scale is not None:
            flush_staging.int8_launches += 1
        mode = (k_stage.shape[-1], k_scale is not None)
        flush_staging.mode_launches[mode] = flush_staging.mode_launches.get(mode, 0) + 1
    return k_cache, v_cache, k_scale, v_scale


flush_staging.launches = 0
flush_staging.int8_launches = 0
flush_staging.mode_launches = {}


@torch.no_grad()
def flush_staging_paged(pool_k, pool_v, pool_ks, pool_vs, k_stage, v_stage, base_lens,
                        page_table, page_size):
    """Flush staged tokens into the stacked page pools, in place.

    pool_k/pool_v: (nl, n_pages, KH, page_size, E) floating point, or int8
      with pool_ks/pool_vs (nl, n_pages, KH, page_size) f32.
    k_stage/v_stage: (B, nl, KH, W, E) bf16; row w of slot b goes to row
      g % page_size of page page_table[b, g // page_size], g = base_lens[b]
      + w, for all W rows; rows past the table's last page are dropped.
    base_lens: (B,) int32 pool token counts; page_table: (B, max_pages)
      int32. The caller keeps pages allocated for base + W.
    A slot with base_lens[b] == 0 holds no request and is skipped: its
    table row may be stale (the TPU flush writes it all the same).
    Returns (pool_k, pool_v, pool_ks, pool_vs), updated in place.
    """
    if pool_k.shape[3] != page_size:
        raise ValueError(f"pool page {pool_k.shape[3]} != page_size {page_size}")
    if _flush("flush_staging_paged", pool_k, pool_v, pool_ks, pool_vs, k_stage, v_stage,
              base_lens, page_table):
        flush_staging_paged.launches += 1
        if pool_ks is not None:
            flush_staging_paged.int8_launches += 1
    return pool_k, pool_v, pool_ks, pool_vs


flush_staging_paged.launches = 0
flush_staging_paged.int8_launches = 0


def _flush(name, k_cache, v_cache, k_scale, v_scale, k_stage, v_stage, base_lens, page_table):
    """Check a flush's operands and run it: the plain version for a CPU
    cache, kernel E for a CUDA one. Caches (nl, n_blocks, KH, S, E): one
    block per slot when page_table is None, else pages. Returns True when
    it launched the kernel."""
    quantized = k_cache.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: scales come with an int8 cache, and only with one")
    nl, n_blocks, KH, S, E = k_cache.shape
    B, W = k_stage.shape[0], k_stage.shape[3]
    paged = page_table is not None
    if v_cache.shape != k_cache.shape or (not paged and n_blocks != B):
        raise ValueError(f"{name}: cache shapes {tuple(k_cache.shape)}, {tuple(v_cache.shape)} "
                         f"for {B} slots")
    if k_stage.shape != (B, nl, KH, W, E) or v_stage.shape != k_stage.shape:
        raise ValueError(f"{name}: staging shape {tuple(k_stage.shape)} does not match the "
                         f"cache {tuple(k_cache.shape)}")
    if quantized and (k_scale.shape != k_cache.shape[:4] or v_scale.shape != k_scale.shape):
        raise ValueError(f"{name}: scale shape {tuple(k_scale.shape)}, expected "
                         f"{tuple(k_cache.shape[:4])}")
    if base_lens.shape != (B,) or (paged and (page_table.ndim != 2
                                              or page_table.shape[0] != B)):
        raise ValueError(f"{name}: base_lens {tuple(base_lens.shape)} / page_table "
                         f"{tuple(page_table.shape) if paged else None} for {B} slots")
    if k_cache.device.type == "cpu":
        if paged:
            naive_flush_staging_paged(k_cache, v_cache, k_stage, v_stage, base_lens, page_table,
                                      k_scale, v_scale)
        else:
            naive_flush_staging(k_cache, v_cache, k_stage, v_stage, base_lens, k_scale, v_scale)
        return False
    dev = k_cache.device
    check_cuda_operand("k_cache", k_cache, (torch.bfloat16, torch.float32, torch.int8))
    check_cuda_operand("v_cache", v_cache, (k_cache.dtype,), device=dev)
    check_cuda_operand("k_stage", k_stage, (torch.bfloat16,), device=dev)
    check_cuda_operand("v_stage", v_stage, (torch.bfloat16,), device=dev)
    check_cuda_operand("base_lens", base_lens, (torch.int32,), device=dev)
    if quantized:
        check_cuda_operand("k_scale", k_scale, (torch.float32,), device=dev)
        check_cuda_operand("v_scale", v_scale, (torch.float32,), device=dev)
    if paged:
        check_cuda_operand("page_table", page_table, (torch.int32,), device=dev)
    cache_kind = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}[k_cache.dtype]
    err = load_library().nnop_flush_staging(
        k_stage.data_ptr(), v_stage.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
        base_lens.data_ptr(), page_table.data_ptr() if paged else None, B, n_blocks,
        page_table.shape[1] if paged else 0, nl, KH, S, W, E, cache_kind,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(name, err)
    return True


@torch.no_grad()
def write_kv_token(cache, new, positions):
    """cache (B, KH, S, D) <- new (B, KH, 1, D) at positions (B,), in
    place; new is cast to the cache dtype. D is the head dim, or 1 for a
    scale cache. Unlike the TPU kernel, S need not be a multiple of 32. A
    position outside [0, S) writes nothing on the card (the plain version
    raises or wraps as indexing does). Returns the cache."""
    B, KH, S, D = cache.shape
    if new.shape != (B, KH, 1, D):
        raise ValueError(f"new shape {tuple(new.shape)}, expected {(B, KH, 1, D)}")
    if positions.shape != (B,):
        raise ValueError(f"positions shape {tuple(positions.shape)}, expected ({B},)")
    if cache.device.type == "cpu":
        naive_write_kv_token(cache, new, positions)
        return cache
    check_cuda_operand("cache", cache, (torch.bfloat16, torch.float32, torch.int8))
    new = new.to(cache.dtype).contiguous()
    check_cuda_operand("new", new, (cache.dtype,), device=cache.device)
    check_cuda_operand("positions", positions, (torch.int32,), device=cache.device)
    err = load_library().nnop_write_kv_token(
        cache.data_ptr(), new.data_ptr(), positions.data_ptr(), B, KH, S, D,
        cache.element_size(), torch.cuda.current_stream(cache.device).cuda_stream,
    )
    check_launch("write_kv_token", err)
    write_kv_token.launches += 1
    return cache


write_kv_token.launches = 0
