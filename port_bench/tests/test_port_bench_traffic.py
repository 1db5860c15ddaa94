"""The traffic generators: the same requests for the same seed, and every
seed the same set of sizes."""

from __future__ import annotations

import numpy as np
import pytest

import tiny
from generators import closed_loop, packed_docs
from pbench import spec

SEED = 2**31 + 12345


def test_rows_repeat_for_a_seed():
    c = tiny.cell("mistral-7b.train-l8192")
    a = packed_docs.make_rows(c.traffic, c.config, SEED)
    b = packed_docs.make_rows(c.traffic, c.config, SEED)
    other = packed_docs.make_rows(c.traffic, c.config, SEED + 1)
    assert a.shape == (c.traffic["rows"], c.traffic["seq_len"] + 1)
    assert np.array_equal(a, b) and not np.array_equal(a, other)
    assert a.min() >= 0 and a.max() < c.config["vocab_size"]
    # consecutive rows share one token, as pack_tokens cuts them
    assert np.array_equal(a[:-1, -1], a[1:, 0])


def test_step_rows_follow_the_programs_feed():
    from nnop_tpu_torch.runtime.dataio import batches

    c = tiny.cell("mistral-7b.train-l8192")
    rows = packed_docs.make_rows(c.traffic, c.config, SEED)
    for step, (toks, tgts) in enumerate(batches(rows, 1, seed=0), 1):
        r = packed_docs.step_rows(rows, 1, step)
        assert np.array_equal(r[:, :-1], toks) and np.array_equal(r[:, 1:], tgts)


@pytest.mark.parametrize("cell", ["mistral-7b.prefill-longdoc"])
def test_requests_repeat_and_share_their_lengths(cell):
    c = spec.cell(cell)
    t, cfg = c.traffic, c.config
    g = t["grid"]
    assert closed_loop.length_grid(t)[[0, -1]].tolist() == [t["prompt_len"]["min"],
                                                            t["prompt_len"]["max"]]
    a = [closed_loop.request(t, cfg, SEED, i) for i in range(g)]
    b = [closed_loop.request(t, cfg, SEED, i) for i in range(g)]
    assert a == b
    lens = sorted(len(p) for p, _ in a)
    other = sorted(closed_loop.prompt_len(t, SEED + 7, i) for i in range(g))
    assert lens == other  # another order, the same sizes
    assert t["prompt_len"]["min"] <= lens[0] and lens[-1] <= t["prompt_len"]["max"]
    assert all(mt == 1 for _, mt in a)
    assert [closed_loop.prompt_len(t, SEED, i) for i in range(g)] != [
        closed_loop.prompt_len(t, SEED + 7, i) for i in range(g)]


def test_feed_closes():
    f = closed_loop.Feed(limit=3)
    assert [f.take() for _ in range(4)] == [0, 1, 2, None]
    f = closed_loop.Feed()
    f.take()
    f.close()
    assert f.take() is None and f.issued == 1
