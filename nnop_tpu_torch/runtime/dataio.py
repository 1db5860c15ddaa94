"""Training data pipeline: token packing, shuffled batching, host-to-device
prefetch.

Counterpart of nnop_tpu/runtime/dataio.py. `pack_tokens`, `batches` and
`pack_tokens_segmented` are numpy, copied from the JAX package (which
cannot be imported here: it imports JAX), so the same seed gives the
same arrays. `prefetch_to_device` copies each batch to the device from
pinned host memory with `non_blocking`, one batch ahead of the consumer.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch


def pack_tokens(streams: Iterable[list[int]], seq_len: int, eos_id: int = 0) -> np.ndarray:
    """Concatenate token lists (EOS-separated) and cut into (N, seq_len+1)
    rows (the +1 column provides next-token targets)."""
    buf: list[int] = []
    rows = []
    width = seq_len + 1
    for toks in streams:
        buf.extend(toks)
        buf.append(eos_id)
        while len(buf) >= width:
            rows.append(buf[:width])
            # overlap one token so every position has a target
            buf = buf[seq_len:]
    if not rows:
        raise ValueError("not enough tokens for a single row")
    return np.asarray(rows, np.int32)


def batches(rows: np.ndarray, batch_size: int, *, shuffle: bool = True, seed: int = 0,
            drop_remainder: bool = True) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (tokens (B, L), targets (B, L)) epoch batches."""
    n = rows.shape[0]
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, stop, batch_size):
        chunk = rows[order[i : i + batch_size]]
        yield chunk[:, :-1], chunk[:, 1:]


def prefetch_to_device(it: Iterator, device, depth: int = 2):
    """Move batches (tuples of numpy arrays) to `device` ahead of
    consumption: a CUDA device gets a non_blocking copy from pinned
    memory, so the copy overlaps the step in flight."""
    device = torch.device(device)

    def put(batch):
        ts = (torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
        if device.type == "cuda":
            return tuple(t.pin_memory().to(device, non_blocking=True) for t in ts)
        return tuple(t.to(device) for t in ts)

    queue = collections.deque()
    for batch in it:
        queue.append(put(batch))
        if len(queue) >= depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def pack_tokens_segmented(streams: Iterable[list[int]], seq_len: int, eos_id: int = 0):
    """Document-aware LM packing: like pack_tokens, but also returns
    per-position SEGMENT ids (1-based document index within the row) and
    per-position POSITIONS (index within the document). Returns (rows,
    segments, positions), each (N, seq_len + 1) int32."""
    width = seq_len + 1
    buf: list[int] = []
    seg: list[int] = []
    pos: list[int] = []
    rows, segs, poss = [], [], []
    doc = 1
    for toks in streams:
        start = len(buf)
        buf.extend(toks)
        buf.append(eos_id)
        seg.extend([doc] * (len(buf) - start))
        pos.extend(range(len(buf) - start))
        doc += 1
        while len(buf) >= width:
            rows.append(buf[:width])
            # renumber the row's segments from 1 (ids are row-local)
            s0 = seg[0]
            segs.append([s - s0 + 1 for s in seg[:width]])
            poss.append(pos[:width])
            buf, seg, pos = buf[seq_len:], seg[seq_len:], pos[seq_len:]
            # the carried overlap token keeps its original doc/pos
    if not rows:
        raise ValueError("not enough tokens for a single row")
    return (np.asarray(rows, np.int32), np.asarray(segs, np.int32), np.asarray(poss, np.int32))
