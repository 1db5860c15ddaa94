"""Decode attention over a floating-point KV cache: one CUDA kernel for Hopper.

`decode_attention` wraps csrc/decode_attn.cu (kernel D; its design:
csrc/decode_attn.cuh), which replaces
nnop_tpu/ops/attention_decode.py:decode_attention (`_decode_kernel`) for
a bf16, f32 or int8 cache, with the sliding window and the score
softcap, at any head dim E <= 256 with E % 16 == 0: one query token per
sequence, or T > 1, the speculative-verify mode (the T draft tokens are
the last T staged ones). The kernel splits each (slot, KV head)'s keys
over `split_count` blocks, each taking the tiles `split_tiles` gives it,
and merges the splits' partials inside the same launch; it runs q·Kᵀ and
P·V on bf16 tensor cores, so an f32 q and cache run as bf16 passes (the
TPU's f32 dots at default precision). The int8 mode, the window, the
softcap and the verify mode have their own launch counts
(`decode_attention.int8_launches`, `.window_launches`,
`.softcap_launches`, `.verify_launches`) beside `launches`, and
`.mode_launches` counts them by (head dim, int8, window, softcap,
verify). The same kernel body serves a paged pool
(ops/attention_decode_paged.py), single-token.
"""

from __future__ import annotations

import functools

import torch

from nnop_tpu_torch.ops.flash_attention import kernel_head_dim
from nnop_tpu_torch.ops.naive import check_draft_rows, naive_decode_attention
from nnop_tpu_torch.utils.build import check_launch, load_library
from nnop_tpu_torch.utils.platform import cdiv, check_cuda_operand

MAX_STAGE_W = 32  # staging rows the kernel attends
MAX_GROUP = 8  # query heads per KV head the kernel holds
PAGE_MULTIPLE = 32  # a page must hold whole 32-key tiles
SPLIT_TILE = 64  # keys of a split's tile: 4 warps x 16-key chunks (csrc/decode_attn.cuh)
MAX_SPLIT = 128  # splits of one (slot, KV head, z) (csrc/decode_attn.cuh kMaxSplit)


def block_rows(T: int, G: int, E: int, paged: bool):
    """Query rows (draft x head) one block of kernel D holds, and the
    z-blocks a (slot, KV head) takes: one 16-row tile, or two for a
    verify step past 16 rows at head dims up to 128 on a linear cache;
    past a block's rows whole drafts split over z. The CUDA source
    repeats this rule (rows_m) and refuses a workspace sized by a rule
    that gives fewer rows."""
    rows = 32 if not paged and T * G > 16 and kernel_head_dim(E) <= 128 else 16
    return rows, cdiv(T, rows // G)


def split_count(blocks: int, span: int, n_sm: int) -> int:
    """How many blocks share one (slot, KV head, z)'s keys: enough that the
    launch has two blocks per SM, at most one per SPLIT_TILE keys of
    `span` (the most cache rows a slot's walk can cover) and MAX_SPLIT.
    `blocks` is B * KH * Z; only host-known numbers, no read of lengths."""
    return max(1, min(cdiv(2 * n_sm, blocks), cdiv(span, SPLIT_TILE), MAX_SPLIT))


def split_tiles(length: int, first: int, n_split: int, s: int):
    """Split s's SPLIT_TILE-key tiles [lo, hi) of a slot's live cache rows
    [first, length) (first: the window edge of the block's first draft, 0
    without a window); empty where hi <= lo. The splits share the tiles
    evenly in order, so together they cover every live row once. The
    kernel finds its range on the device by the same formula."""
    if first >= length:
        return 0, 0
    t_first, t_end = first // SPLIT_TILE, cdiv(length, SPLIT_TILE)
    per = cdiv(t_end - t_first, n_split)
    lo = t_first + s * per
    return lo, min(t_end, lo + per)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_TICKETS: dict = {}


def _tickets(device: torch.device, n: int):
    """The per-device int32 counters of the splits' combine: zeros, which
    each launch leaves zero (its last block of a group resets its own)."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = _TICKETS[device] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return t


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
                  k_stage, v_stage, staged_n, layer, window, softcap, n_split=None):
    """Check the operands of kernel D and launch it on CUDA tensors: over
    a linear cache (page_table None), or over page pools (n_pages, KH,
    page, E) through page_table (B, max_pages) int32, single-token. `name`
    is the calling op's, for its errors. n_split (tests only) forces the
    number of splits, else `split_count` picks it. Returns o (B, QH, T,
    E)."""
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
    if E > 256 or E % 16:
        raise ValueError(f"{name}: the kernel takes head dims up to 256 that are multiples of 16, "
                         f"got E={E}")
    if QH % KH or QH // KH > MAX_GROUP or (paged and S % PAGE_MULTIPLE):
        raise ValueError(f"kernel needs QH/KH <= {MAX_GROUP} and pages of whole "
                         f"{PAGE_MULTIPLE}-key tiles; got QH={QH}, KH={KH}, page={S}")
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
    rows, Z = block_rows(T, QH // KH, E, paged)
    if n_split is None:
        span = S * page_table.shape[1] if paged else S
        if window is not None:
            span = min(span, window + SPLIT_TILE)
        n_split = split_count(B * KH * Z, span, _sm_count(q.device))
    ws = tickets = None
    if n_split > 1:
        ws = torch.empty(B * KH * Z * n_split * rows * (E + 2), dtype=torch.float32,
                         device=q.device)
        tickets = _tickets(q.device, B * KH * Z)
    o = torch.empty_like(q)
    err = load_library().nnop_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
        k_stage.data_ptr() if k_stage is not None else None,
        v_stage.data_ptr() if v_stage is not None else None,
        lengths.data_ptr(), page_table.data_ptr() if paged else None, o.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        tickets.data_ptr() if tickets is not None else None,
        ws.numel() if ws is not None else 0, tickets.numel() if tickets is not None else 0,
        B, QH, KH,
        S, E, T, n_blocks, page_table.shape[1] if paged else 0, n_layers, int(layer), W, staged_n,
        float(scale), int(window or 0), float(softcap or 0.0), int(q.dtype == torch.float32),
        int(quantized), int(n_split),
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
