"""Paged KV cache: a host-side page allocator over device-side pools.

Counterpart of nnop_tpu/runtime/paged_cache.py; pairs with
ops/attention_decode_paged.py. The pool is a fixed arena of
(n_pages, KH, page_size, E) blocks shared by all sequences; a host free
list hands out page ids, so KV memory scales with the tokens held, not
with max_batch * max_seq. A token append writes its row in place at
(page id, :, offset); page ids are picked on the host. An int8 pool
quantizes each token per KV head with the package's quantizer
(ops/quantization.py:quantize, bit-exact with the JAX one).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from nnop_tpu_torch.ops.quantization import quantize


@dataclasses.dataclass
class PagedKVCache:
    pool_k: torch.Tensor  # (n_pages, KH, page, E) fp or int8
    pool_v: torch.Tensor
    pool_k_scale: Optional[torch.Tensor]  # (n_pages, KH, page) f32, int8 pools only
    pool_v_scale: Optional[torch.Tensor]
    page_size: int
    free: list[int]
    tables: dict[int, list[int]]  # seq id -> page ids
    lengths: dict[int, int]

    @staticmethod
    def create(n_pages, n_kv_heads, page_size, head_dim, dtype=torch.bfloat16,
               quantized=False, device="cpu"):
        shape = (n_pages, n_kv_heads, page_size, head_dim)
        pool_dtype = torch.int8 if quantized else dtype

        def scales():
            return torch.zeros(shape[:3], dtype=torch.float32, device=device) if quantized else None

        return PagedKVCache(
            pool_k=torch.zeros(shape, dtype=pool_dtype, device=device),
            pool_v=torch.zeros(shape, dtype=pool_dtype, device=device),
            pool_k_scale=scales(),
            pool_v_scale=scales(),
            page_size=page_size,
            free=list(range(n_pages)),
            tables={},
            lengths={},
        )

    @property
    def quantized(self) -> bool:
        return self.pool_k_scale is not None

    def alloc_seq(self, seq_id: int):
        self.tables[seq_id] = []
        self.lengths[seq_id] = 0

    def free_seq(self, seq_id: int):
        self.free.extend(self.tables.pop(seq_id, []))
        self.lengths.pop(seq_id, None)

    def _ensure_page(self, seq_id: int):
        length = self.lengths[seq_id]
        if length % self.page_size == 0 and length // self.page_size == len(self.tables[seq_id]):
            if not self.free:
                raise MemoryError("KV page pool exhausted")
            self.tables[seq_id].append(self.free.pop())

    @torch.no_grad()
    def append_token(self, seq_id: int, k_tok, v_tok):
        """k_tok/v_tok: (KH, E) for one token, written in place."""
        self._ensure_page(seq_id)
        length = self.lengths[seq_id]
        page = self.tables[seq_id][length // self.page_size]
        off = length % self.page_size
        dev = self.pool_k.device
        for pool, scales, tok in ((self.pool_k, self.pool_k_scale, k_tok),
                                  (self.pool_v, self.pool_v_scale, v_tok)):
            tok = tok.to(dev)
            if self.quantized:
                q = quantize(tok, axis=-1)
                pool[page, :, off], scales[page, :, off] = q.values, q.scale
            else:
                pool[page, :, off] = tok.to(pool.dtype)
        self.lengths[seq_id] = length + 1

    def batch_views(self, seq_ids: list[int], max_pages: int):
        """(page_table (B, max_pages) int32, lengths (B,) int32) on the
        pools' device, for the decode kernel."""
        table = torch.zeros((len(seq_ids), max_pages), dtype=torch.int32)
        lens = torch.zeros((len(seq_ids),), dtype=torch.int32)
        for i, sid in enumerate(seq_ids):
            pages = self.tables[sid]
            table[i, : len(pages)] = torch.tensor(pages, dtype=torch.int32)
            lens[i] = self.lengths[sid]
        dev = self.pool_k.device
        return table.to(dev), lens.to(dev)
