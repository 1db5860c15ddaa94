"""The roofline and peak arithmetic and the window's statistics against
hand-worked cases."""

from __future__ import annotations

import pytest

import tiny
from pbench import roofline, stats


def test_visible_pairs_by_hand():
    assert roofline.visible_pairs(0, 4, None) == 1 + 2 + 3 + 4
    assert roofline.visible_pairs(0, 4, 2) == 1 + 2 + 2 + 2
    assert roofline.visible_pairs(5, 3, 4) == 4 * 3
    assert roofline.visible_pairs(0, 8192, 4096) == 4096 * 4097 // 2 + 4096 * 4096


def test_bounds_by_hand():
    # 989e12 bf16 operations take one second at the peak; 3.35e12 bytes too
    assert roofline.bound_s(989e12, 1.0, "bf16") == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 3.35e12, "int8") == pytest.approx(1.0)
    assert roofline.bound_s(1979e12, 3.35e12 / 2, "int8") == pytest.approx(1.0)
    # kernel C at one chunk: 512 rows at offset 0, no window, 1 head, E 4
    ops, nbytes = roofline.flash_fwd(1, 1, 1, 4, 0, 512, None)
    assert ops == 4 * 4 * (512 * 513 // 2)
    assert nbytes == 512 * 4 * 2 * 2 + 512 * 4 * 2 * 2 + 512 * 4
    # dQ three products, dK/dV four, of 2E a visible pair
    assert roofline.flash_bwd_dq(1, 2, 1, 8, 4, None)[0] == 3 * 2 * 8 * 2 * 10
    assert roofline.flash_bwd_dkv(1, 2, 1, 8, 4, 2)[0] == 4 * 2 * 8 * 2 * 7


CFG = dict(hidden_size=8, intermediate_size=16, num_attention_heads=2, num_key_value_heads=1,
           head_dim=4, num_hidden_layers=3, vocab_size=10, sliding_window=None)


def test_train_step_ops_by_hand():
    per_token = 2 * 8 * (2 + 2) * 4 + 2 * 8 * 8 + 3 * 2 * 8 * 16  # q,k,v; o; the MLP
    L = 5
    attn = 4 * 4 * 2 * (5 * 6 // 2)
    fwd = 3 * (per_token * L + attn) + 2 * 8 * 10 * L
    assert roofline.train_step_ops(CFG, 1, L) == 3 * fwd
    assert roofline.train_step_ops(CFG, 2, L) == 2 * 3 * fwd


def test_routed_layer_ops_by_hand():
    moe = dict(CFG, num_local_experts=4, num_experts_per_tok=2)
    # q,k,v; o; two experts' SwiGLUs; the router
    per_token = 2 * 8 * (2 + 2) * 4 + 2 * 8 * 8 + 2 * 3 * 2 * 8 * 16 + 2 * 8 * 4
    assert roofline.layer_linear_ops_per_token(moe) == per_token


def test_grouped_expert_bounds_by_hand():
    # 6 real rows (3 tokens, top 2) over 2 of the experts, K 8, N 16
    assert roofline.gmm_fwd(6, 8, 16, 2) == (2 * 6 * 8 * 16, 6 * 8 * 2 + 2 * 8 * 16 * 2
                                              + 6 * 16 * 2)
    assert roofline.gmm_fwd(6, 8, 16, 2, w_elt=1)[1] == 6 * 8 * 2 + 2 * 8 * 16 + 6 * 16 * 2
    assert roofline.gmm_dx(6, 8, 16, 2) == (2 * 6 * 8 * 16, 6 * 16 * 2 + 2 * 8 * 16 * 2
                                             + 6 * 8 * 2)
    assert roofline.gmm_dw(6, 8, 16, 2) == (2 * 6 * 8 * 16, 6 * 24 * 2 + 2 * 8 * 16 * 2)


@pytest.mark.parametrize("name,ops,at_2048,at_6144", [
    ("mistral-7b-8l", 102100767866880.0, 0.008060256338831142, 0.007817192393124369),
    ("mistral-7b", 389075718635520.0, 0.03224102535532457, 0.03126797439352882)])
def test_dense_configurations_count_as_before(name, ops, at_2048, at_6144):
    # the cells' step operations and prefill times at the peak as they were
    # counted before routed experts came, to the last digit
    import json
    import os

    with open(os.path.join(tiny.BENCH_DIR, "configs", name + ".json")) as f:
        cfg = json.load(f)
    assert roofline.train_step_ops(cfg, 1, 8192) == ops
    assert roofline.prefill_seconds_at_peak(cfg, 2048, 2048, False) == at_2048
    assert roofline.prefill_seconds_at_peak(cfg, 6144, 1920, True) == at_6144


def test_prefill_peak_time_by_hand():
    lin = 2 * 8 * 4 * 4 + 2 * 8 * 8 + 3 * 2 * 8 * 16
    attn = 4 * 4 * 2 * (3 + 4)  # rows at positions 2, 3
    t = roofline.prefill_seconds_at_peak(CFG, 2, 2, True)
    assert t == pytest.approx((3 * (lin * 2 + attn) + 2 * 8 * 10) / 989e12)
    assert roofline.prefill_seconds_at_peak(CFG, 2, 2, False) == pytest.approx(
        3 * (lin * 2 + attn) / 989e12)


class _Trace:
    """A trace whose kernel C launches took `c_s` seconds in all."""

    def __init__(self, c_s, count):
        self.c_s, self.count = c_s, count

    def select(self, pred):
        assert pred("void flash_fwd_kernel<128>(Params)") and not pred("nvjet_tst")
        return self.c_s, self.count


def test_flash_fwd_roofline_counts_a_padded_last_chunk_by_its_prompt_rows():
    from pbench import spec

    reader = spec.metric_reader("roofline.flash_fwd.serve")
    # one prompt of 612 rows in chunks of 512: rows [0, 512), then [512, 612)
    # launched padded to 512 rows; two layers, 2 heads over 1 KV head, E 4
    cfg = dict(CFG, num_hidden_layers=2, sliding_window=None)
    chunks = [(0.0, 1.0, 0, 512, 512, False), (1.0, 2.0, 512, 512, 100, True)]
    # by hand, a chunk's (ops, bytes): 4E ops a visible pair and head; q and
    # o of its prompt rows and the K/V rows it sees at 2 bytes an element,
    # lse at 4 bytes a row and head
    first = (4 * 4 * 2 * (512 * 513 // 2), 2 * 512 * 4 * 2 * 2 + 512 * 4 * 2 * 2 + 2 * 512 * 4)
    last = (4 * 4 * 2 * (612 * 613 // 2 - 512 * 513 // 2),
            2 * 100 * 4 * 2 * 2 + 612 * 4 * 2 * 2 + 2 * 100 * 4)
    bound = 2 * sum(max(o / 989e12, b / 3.35e12) for o, b in (first, last))
    got = reader.read({"trace": _Trace(bound / 0.4, 4), "traced_chunks": chunks, "config": cfg})
    assert got == pytest.approx(40.0)
    # counted by its 512 launched rows, the last chunk would read higher
    padded = [c[:4] + (c[3],) + c[5:] for c in chunks]
    assert reader.read({"trace": _Trace(bound / 0.4, 4), "traced_chunks": padded,
                        "config": cfg}) > 41.0


def test_serve_mfu_and_enqueue_time_over_the_untraced_part():
    from pbench import spec

    cfg = dict(CFG, num_hidden_layers=3)
    chunks = [(0.0, 0.002, 0, 512, 512, False), (0.5, 0.503, 512, 512, 100, True)]
    want = (roofline.prefill_seconds_at_peak(cfg, 0, 512, False)
            + roofline.prefill_seconds_at_peak(cfg, 512, 100, True))
    mfu = spec.metric_reader("mfu.serve").read({"chunks": chunks, "untraced_s": 2.0,
                                                "config": cfg})
    assert mfu == pytest.approx(100.0 * want / 2.0)
    ms = spec.metric_reader("chunk_enqueue_ms.serve").read({"chunks": chunks})
    assert ms == pytest.approx(2.5)


def test_rate_over_the_whole_window():
    assert stats.rate(300.0, 1.5) == 200.0
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)
