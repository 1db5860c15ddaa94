"""Decode attention over a floating-point KV cache: one CUDA kernel for Hopper.

`decode_attention` wraps csrc/decode_attn.cu, which replaces
nnop_tpu/ops/attention_decode.py:decode_attention (`_decode_kernel`) for
a floating-point or int8 cache, with the sliding window and the score
softcap, at head dim 128 or 256: one query token per sequence, or T > 1,
the speculative-verify mode (the T draft tokens are the last T staged
ones; the kernel's verify mode holds all T * G rows of a KV head in one
block). See the kernel source for what bounds it and how. The int8 mode,
the window, the softcap and the verify mode have their own launch counts
(`decode_attention.int8_launches`, `.window_launches`,
`.softcap_launches`, `.verify_launches`) beside `launches`, and
`.mode_launches` counts them by (head dim, int8, window, softcap,
verify). The same kernel body serves a paged pool
(ops/attention_decode_paged.py), single-token.
"""

from __future__ import annotations

import torch

from nnop_tpu_torch.ops.naive import check_draft_rows, naive_decode_attention
from nnop_tpu_torch.utils.build import check_launch, load_library
from nnop_tpu_torch.utils.platform import check_cuda_operand

MAX_STAGE_W = 32  # staging rows the kernel attends in one tile
MAX_GROUP = 8  # query heads per KV head the kernel holds
TILE = 32  # keys per kernel tile: a page must hold whole tiles


@torch.no_grad()
def decode_attention(q, k_cache, v_cache, lengths, k_scale=None, v_scale=None, *,
                     scale: float | None = None, k_stage=None, v_stage=None,
                     staged_n: int | None = None, layer: int | None = None,
                     window: int | None = None, softcap: float | None = None):
    """Decode attention of T query tokens per sequence over a floating-point
    or int8 KV cache.

    q: (B, QH, T, E). k_cache/v_cache: (B, KH, S, E), or STACKED
    (n_layers, B, KH, S, E) with the static `layer` index (the engine's
    layout; no per-layer copy is made). lengths: (B,) int32 — valid cache
    prefix per sequence (flushed tokens only). k_stage/v_stage: optional
    bf16 staging (B, KH, W, E), or (B, n_layers, KH, W, E) with `layer`,
    holding the `staged_n` newest tokens at positions [lengths[b],
    lengths[b] + staged_n); staged_n is uniform across the batch. A slot
    with lengths[b] == 0 sees nothing and gets zeros. An int8 cache comes
    with per-token f32 scales k_scale/v_scale of the cache's shape without
    E. Returns (B, QH, T, E) in q.dtype.

    T > 1 is the speculative verify: the T query tokens are the last T
    staged ones (positions lengths[b] + staged_n - T + t), so it needs the
    staging and T <= staged_n (else ValueError); query t sees the staged
    rows up to its own, and the window is cut at each query's own edge.
    """
    quantized = k_cache.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come with an int8 cache, and only with one")
    B, QH, T, E = q.shape
    staged_n = check_draft_rows(T, k_stage, staged_n)
    if scale is None:
        scale = 1.0 / (E**0.5)
    if q.device.type == "cpu":
        return naive_decode_attention(
            q, k_cache, v_cache, lengths, k_scale, v_scale, scale=scale, k_stage=k_stage,
            v_stage=v_stage, staged_n=staged_n, layer=layer, window=window,
            softcap=softcap,
        )
    o = launch_decode("decode_attention", q, k_cache, v_cache, lengths, k_scale, v_scale, None,
                      scale=scale, k_stage=k_stage, v_stage=v_stage, staged_n=staged_n,
                      layer=layer, window=window, softcap=softcap)
    count_launch(decode_attention, q.shape[-1], quantized, window, softcap, T > 1)
    return o


def count_launch(op, E, quantized, window, softcap, verify=False):
    """Add one launch of kernel D to `op`'s counts: all launches; those of
    the int8 mode, with a window, with a softcap and of the verify mode
    (T > 1); and those of its mode (E, int8, window, softcap, verify) in
    `op.mode_launches`."""
    op.launches += 1
    op.int8_launches += quantized
    op.window_launches += window is not None
    op.softcap_launches += softcap is not None
    op.verify_launches += verify
    mode = (E, quantized, window is not None, softcap is not None, verify)
    op.mode_launches[mode] = op.mode_launches.get(mode, 0) + 1


def launch_decode(name, q, k_cache, v_cache, lengths, k_scale, v_scale, page_table, *, scale,
                  k_stage, v_stage, staged_n, layer, window, softcap):
    """Check the operands of kernel D and launch it on CUDA tensors: over
    a linear cache (page_table None), or over page pools (n_pages, KH,
    page, E) through page_table (B, max_pages) int32, single-token. `name`
    is the calling op's, for its errors. Returns o (B, QH, T, E)."""
    quantized = k_scale is not None
    B, QH, T, E = q.shape
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"{name}: softcap must be > 0, got {softcap}")
    if layer is None:  # view a plain cache as a one-layer stack
        k_cache, v_cache, layer = k_cache[None], v_cache[None], 0
        if quantized:
            k_scale, v_scale = k_scale[None], v_scale[None]
        if k_stage is not None:
            k_stage, v_stage = k_stage[:, None], v_stage[:, None]
    n_layers, n_blocks, KH, S, _ = k_cache.shape
    paged = page_table is not None
    if ((not paged and n_blocks != B) or k_cache.shape[4] != E
            or v_cache.shape != k_cache.shape):
        raise ValueError(f"{name}: cache shape {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} out of range for {n_layers} layers")
    if E not in (128, 256) or QH % KH or QH // KH > MAX_GROUP or (paged and S % TILE):
        raise ValueError(f"kernel needs head dim 128 or 256, QH/KH <= {MAX_GROUP} and pages of "
                         f"whole {TILE}-key tiles; got E={E}, QH={QH}, KH={KH}, page={S}")
    check_cuda_operand("q", q, (torch.bfloat16, torch.float32))
    cache_dtype = torch.int8 if quantized else q.dtype
    check_cuda_operand("k_cache", k_cache, (cache_dtype,), device=q.device)
    check_cuda_operand("v_cache", v_cache, (cache_dtype,), device=q.device)
    if quantized:
        for what, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            check_cuda_operand(what, t, (torch.float32,), device=q.device)
            if t.shape != k_cache.shape[:4]:
                raise ValueError(f"{what} shape {tuple(t.shape)}, expected "
                                 f"{tuple(k_cache.shape[:4])}")
    check_cuda_operand("lengths", lengths, (torch.int32,), device=q.device)
    if lengths.shape != (B,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)}, expected ({B},)")
    if paged:
        check_cuda_operand("page_table", page_table, (torch.int32,), device=q.device)
        if page_table.ndim != 2 or page_table.shape[0] != B:
            raise ValueError(f"page_table shape {tuple(page_table.shape)}, expected ({B}, *)")
    W = 0
    if k_stage is not None:
        W = k_stage.shape[3]
        if k_stage.shape != (B, n_layers, KH, W, E) or v_stage.shape != k_stage.shape:
            raise ValueError(f"staging shape {tuple(k_stage.shape)} does not match the cache")
        if W > MAX_STAGE_W or not 0 <= staged_n <= W:
            raise ValueError(f"need staged_n <= W <= {MAX_STAGE_W}; got {staged_n}, {W}")
        check_cuda_operand("k_stage", k_stage, (torch.bfloat16,), device=q.device)
        check_cuda_operand("v_stage", v_stage, (torch.bfloat16,), device=q.device)
    o = torch.empty_like(q)
    err = load_library().nnop_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
        k_stage.data_ptr() if k_stage is not None else None,
        v_stage.data_ptr() if v_stage is not None else None,
        lengths.data_ptr(), page_table.data_ptr() if paged else None, o.data_ptr(), B, QH, KH,
        S, E, T, n_blocks, page_table.shape[1] if paged else 0, n_layers, int(layer), W, staged_n,
        float(scale), int(window or 0), float(softcap or 0.0), int(q.dtype == torch.float32),
        int(quantized),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(name, err)
    return o


decode_attention.launches = 0
decode_attention.int8_launches = 0
decode_attention.window_launches = 0
decode_attention.softcap_launches = 0
decode_attention.verify_launches = 0
decode_attention.mode_launches = {}
