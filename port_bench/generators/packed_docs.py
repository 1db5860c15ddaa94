"""Training rows packed from documents (a training job's feed).

Parameters (the traffic file): seq_len, batch, rows; doc_len: a
log-normal length in tokens {"median", "sigma", "min", "max"}; eos_id.
Document tokens are uniform over [1, vocab) with eos_id between
documents; rows are cut as the program's `runtime/dataio.py:pack_tokens`
cuts them (copied here): (rows, seq_len + 1), consecutive rows sharing
one token so every position has a target. No segment ids: attention runs
across the documents of a row, as `cli train` does."""

from __future__ import annotations

import numpy as np

from pbench.weights import derive


def pack_tokens(streams, seq_len: int, eos_id: int = 0) -> np.ndarray:
    buf: list[int] = []
    rows = []
    width = seq_len + 1
    for toks in streams:
        buf.extend(toks)
        buf.append(eos_id)
        while len(buf) >= width:
            rows.append(buf[:width])
            buf = buf[seq_len:]
    if not rows:
        raise ValueError("not enough tokens for a single row")
    return np.asarray(rows, np.int32)


def make_rows(traffic: dict, cfg: dict, seed: int) -> np.ndarray:
    """(traffic["rows"], seq_len + 1) int32 rows from the seed."""
    rng = np.random.default_rng(derive(seed, "packed_docs"))
    L, n = traffic["seq_len"], traffic["rows"]
    dl = traffic["doc_len"]
    need = n * L + L + 1
    docs, total = [], 0
    while total < need:
        m = int(np.clip(rng.lognormal(np.log(dl["median"]), dl["sigma"]), dl["min"], dl["max"]))
        docs.append(rng.integers(1, cfg["vocab_size"], m).tolist())
        total += m + 1
    return pack_tokens(docs, L, traffic.get("eos_id", 0))[:n]


def step_rows(rows: np.ndarray, batch: int, step: int) -> np.ndarray:
    """The rows the program's feed gives step `step` (1-based) of its first
    epoch: `batches(rows, batch, seed=0)` shuffles the row order with
    numpy's default_rng(0) (runtime/dataio.py:batches, copied here)."""
    order = np.arange(rows.shape[0])
    np.random.default_rng(0).shuffle(order)
    if step * batch > rows.shape[0]:
        raise ValueError("the checked steps must lie in the first epoch")
    return rows[order[(step - 1) * batch: step * batch]]
