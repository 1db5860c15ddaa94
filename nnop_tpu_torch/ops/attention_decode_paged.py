"""Decode attention over a paged KV pool: the paged mode of the CUDA kernel.

`paged_decode_attention` wraps csrc/decode_attn.cu's paged mode, which
replaces nnop_tpu/ops/attention_decode_paged.py:paged_decode_attention
(`_paged_kernel`) for a floating-point or int8 pool and one query token
per sequence. It is the decode kernel of ops/attention_decode.py with
each 32-key tile's rows found through the slot's page table, with the
sliding window (a slot's walk starts inside the page that holds its
first live row) and the score softcap; see the kernel source for what
bounds it. The int8 mode, the window and the softcap have their own
launch counts (`paged_decode_attention.int8_launches`, `.window_launches`,
`.softcap_launches`) beside `launches`, and `.mode_launches` counts them
by (head dim, int8, window, softcap, verify), verify always False: the
paged op is single-token, as the reference's is, and q with T > 1 raises
ValueError.
"""

from __future__ import annotations

import torch

from nnop_tpu_torch.ops.attention_decode import count_launch, launch_decode
from nnop_tpu_torch.ops.naive import naive_paged_decode_attention


@torch.no_grad()
def paged_decode_attention(q, pool_k, pool_v, page_table, lengths, pool_k_scale=None,
                           pool_v_scale=None, *, scale: float | None = None, k_stage=None,
                           v_stage=None, staged_n: int | None = None, layer: int | None = None,
                           window: int | None = None, softcap: float | None = None):
    """Single-token decode over a paged KV pool.

    q: (B, QH, 1, E). pool_k/pool_v: (n_pages, KH, page, E), or STACKED
    (n_layers, n_pages, KH, page, E) with the static `layer` index; fp, or
    int8 with per-token f32 scales pool_k_scale/pool_v_scale of the pool's
    shape without E. page_table: (B, max_pages) int32, each slot's page
    ids in order; entries at or past ceil(lengths[b] / page) are never
    read. lengths: (B,) int32 tokens in the POOL (staged ones counted
    apart). k_stage/v_stage/staged_n: the bf16 staging of the newest
    tokens, as in ops/attention_decode.py. A slot with lengths[b] == 0
    gets zeros. Returns (B, QH, 1, E) in q.dtype.
    """
    quantized = pool_k.dtype == torch.int8
    if quantized != (pool_k_scale is not None) or (pool_k_scale is None) != (pool_v_scale is None):
        raise ValueError("pool scales come with an int8 pool, and only with one")
    B, QH, T, E = q.shape
    if T != 1:
        # the reference's paged op reads one query token (its engine
        # refuses speculative decoding with paged pools)
        raise ValueError(f"paged_decode_attention is single-token: q has T = {T}, expected 1")
    if scale is None:
        scale = 1.0 / (E**0.5)
    staged_n = int(staged_n or 0) if k_stage is not None else 0
    if q.device.type == "cpu":
        return naive_paged_decode_attention(
            q, pool_k, pool_v, page_table, lengths, pool_k_scale, pool_v_scale, scale=scale,
            k_stage=k_stage, v_stage=v_stage, staged_n=staged_n, layer=layer, window=window,
            softcap=softcap,
        )
    o = launch_decode("paged_decode_attention", q, pool_k, pool_v, lengths, pool_k_scale,
                      pool_v_scale, page_table, scale=scale, k_stage=k_stage, v_stage=v_stage,
                      staged_n=staged_n, layer=layer, window=window, softcap=softcap)
    count_launch(paged_decode_attention, q.shape[-1], quantized, window, softcap)
    return o


paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0
paged_decode_attention.window_launches = 0
paged_decode_attention.softcap_launches = 0
paged_decode_attention.verify_launches = 0
paged_decode_attention.mode_launches = {}
