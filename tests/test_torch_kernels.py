"""The Hopper kernels against their plain versions, on the card.

Every test carries the `gpu` marker and skips where CUDA is unavailable
(the kernels cannot run on a CPU). This file imports no JAX, so it runs
on the card's machine:

    NNOP_TEST_TPU=1 python -m pytest tests/test_torch_kernels.py -q

(NNOP_TEST_TPU=1 keeps the root conftest from importing JAX.) Tolerance:
2e-2 absolute for bf16 outputs (one bf16 ulp below magnitude 4 is
<= 1.6e-2, and both sides accumulate in fp32 in another order), scaled
by max(1, max|plain|) for the quantized products (bf16 sums over K in
another order; kernel I's grouped products as these); the flushes (also
the int8 and paged ones), the one-token write and the W8A8 products with
f32 output (G and kernel I's W8A8 mode) must be bit-exact. The
training kernels (A with rstd, A-bwd, B backward, dQ and dK/dV, the
grouped product's dx through kernel I and its dw kernel) are held to the
plain forward and backward formulas of ops/naive.py, and the attention
backward and the grouped dw must give the same bits on two runs. The op
set's row kernels (softmax and layer norm, forward and backward, in one
block and in column chunks) are held per row to a relative error (1e-5
in f32, 1e-2 in bf16; dw and db 1e-4), and attention with the pair bias
and segment ids (C, dQ with dpair, dK/dV), and at head dims the kernels
reach by padding (32, 96), to 1e-2 relative per 64-row tile; so are
dQ and dK/dV with the window, the softcap (where it binds), head dim 256
and segment ids with the softcap, and decode attention's speculative
verify mode (T > 1, and past 32 rows a block its split over z-blocks),
against which a wrong intra-draft mask or a dropped z-block must fail.
Decode attention also runs at head dims 32 and 64 (padded inside the
kernel) in bf16, int8 and f32, linear, paged and verify, under forced
split counts (the same result within the tolerance, and the same bits
on a rerun); flash attention takes f32 operands (rounded to bf16 at the
op boundary, within 1e-2 per tile of the plain f32 version); and the
CLI's default model, f32 `tiny` at head dim 32, serves on the card with
the CPU engine's greedy streams (parted only at a near tie of the plain
forward's logits, within 1e-2 x max|logit|).
"""

import pytest
import torch

from nnop_tpu_torch.ops import naive
from nnop_tpu_torch.models.llama import LlamaConfig, forward, init_params
from nnop_tpu_torch.ops.attention_decode import MAX_SPLIT, decode_attention, launch_decode
from nnop_tpu_torch.ops.attention_decode_paged import paged_decode_attention
from nnop_tpu_torch.ops.flash_attention import flash_attention, flash_fwd
from nnop_tpu_torch.ops.flash_attention_bwd import (
    flash_attention_bwd,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from nnop_tpu_torch.ops.grouped_matmul import (
    _grouped_matmul_q4,
    grouped_matmul,
    grouped_matmul_dw,
    grouped_matmul_quantized,
    grouped_matmul_w8a8,
    quantize4_experts,
)
from nnop_tpu_torch.ops.kv_write import flush_staging, flush_staging_paged, write_kv_token
from nnop_tpu_torch.ops.layer_norm import layer_norm, layer_norm_bwd, layer_norm_fwd
from nnop_tpu_torch.ops.quantization import quantize, quantize4
from nnop_tpu_torch.ops.quantized_matmul import (
    quantize_act,
    quantized_matmul,
    quantized_matmul4,
    quantized_matmul_w8a8,
)
from nnop_tpu_torch.ops.rms_norm import rms_norm, rms_norm_bwd, rms_norm_fwd
from nnop_tpu_torch.ops.rope import RotaryEmbedding, llama_rope, llama_rope_bwd
from nnop_tpu_torch.ops.softmax import online_softmax, softmax_bwd, softmax_fwd

pytestmark = pytest.mark.gpu
TOL = dict(atol=2e-2, rtol=0)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100): the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _bf(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(torch.bfloat16)


def test_rms_norm_kernel(gen):
    x, w = _bf(gen, 64, 4096), _bf(gen, 4096, scale=0.1) + 0.5
    before = rms_norm.launches
    got = rms_norm(x, w, 1e-5, offset=1.0)
    assert rms_norm.launches == before + 1
    torch.testing.assert_close(got, naive.naive_rms_norm(x, w, eps=1e-5, offset=1.0), **TOL)


def test_rope_kernel(gen):
    q, k = _bf(gen, 2, 32, 9, 128, scale=0.5), _bf(gen, 2, 8, 9, 128, scale=0.5)
    cos, sin = RotaryEmbedding(128, 500000.0)(torch.arange(18, device="cuda").view(2, 9))
    for got, want in zip(llama_rope(q, k, cos, sin), naive.naive_rope(q, k, cos, sin)):
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("causal,offset", [(True, 0), (True, 70), (False, 0)])
def test_flash_kernel(gen, causal, offset):
    q, k, v = _bf(gen, 1, 32, 100, 128), _bf(gen, 1, 8, 200, 128), _bf(gen, 1, 8, 200, 128)
    kpad = (torch.arange(200, device="cuda") < 170)[None]
    kw = dict(causal=causal, scale=128 ** -0.5, causal_offset=offset, kpad_mask=kpad)
    for got, want in zip(flash_fwd(q, k, v, **kw),
                         naive.naive_attention(q, k, v, return_lse=True, **kw)):
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_decode_kernel(gen, dtype):
    """The cache (and q) in bf16, as served, or f32; staging is bf16."""
    kc, vc = _bf(gen, 2, 4, 8, 256, 128).to(dtype), _bf(gen, 2, 4, 8, 256, 128).to(dtype)
    ks, vs = _bf(gen, 4, 2, 8, 32, 128), _bf(gen, 4, 2, 8, 32, 128)
    lengths = torch.tensor([0, 1, 65, 200], dtype=torch.int32, device="cuda")
    q = _bf(gen, 4, 32, 1, 128).to(dtype)
    kw = dict(k_stage=ks, v_stage=vs, staged_n=7, layer=1)
    got = decode_attention(q, kc, vc, lengths, **kw)
    assert got.dtype == dtype and (got[0] == 0).all()  # the empty slot
    torch.testing.assert_close(got, naive.naive_decode_attention(q, kc, vc, lengths, **kw), **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flush_kernel(gen, dtype):
    kc, vc = _bf(gen, 2, 4, 8, 256, 128).to(dtype), _bf(gen, 2, 4, 8, 256, 128).to(dtype)
    ks, vs = _bf(gen, 4, 2, 8, 32, 128), _bf(gen, 4, 2, 8, 32, 128)
    lengths = torch.tensor([0, 1, 65, 200], dtype=torch.int32, device="cuda")
    kc2, vc2 = kc.clone(), vc.clone()
    flush_staging(kc2, vc2, None, None, ks, vs, lengths)
    naive.naive_flush_staging(kc, vc, ks, vs, lengths)
    torch.cuda.synchronize()
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)


# the sliding window, the softcap and head dim 256 (Mistral, Gemma, Gemma-2)
FLASH_FEATURE_CASES = {
    # name: (E, QH, KH, QL, KL, offset, n_valid, window, softcap)
    "window17": (128, 32, 8, 300, 300, 0, None, 17, None),
    "window33_chunked": (128, 32, 8, 128, 512, 200, 328, 33, None),
    "window_past_tiles": (128, 8, 8, 64, 1024, 900, 964, 64, None),
    "E64_window5": (64, 4, 2, 70, 70, 0, None, 5, None),
    "E256_causal": (256, 8, 4, 300, 300, 0, None, None, None),
    "E256_softcap50": (256, 8, 4, 200, 200, 0, None, None, 50.0),
    "E256_window33_softcap": (256, 8, 4, 128, 512, 200, 328, 33, 50.0),
    "E256_mqa_chunked": (256, 8, 1, 100, 384, 250, 350, None, None),
}


@pytest.mark.parametrize("case", list(FLASH_FEATURE_CASES))
def test_flash_kernel_window_softcap(gen, case):
    E, QH, KH, QL, KL, offset, n_valid, window, softcap = FLASH_FEATURE_CASES[case]
    q, k, v = _bf(gen, 1, QH, QL, E), _bf(gen, 1, KH, KL, E), _bf(gen, 1, KH, KL, E)
    kw = dict(causal=True, scale=E ** -0.5, causal_offset=offset, window=window,
              softcap=softcap)
    if n_valid is not None:
        kw["kpad_mask"] = (torch.arange(KL, device="cuda") < n_valid)[None]
    before = flash_fwd.window_launches, flash_fwd.softcap_launches
    got = flash_fwd(q, k, v, **kw)
    assert (flash_fwd.window_launches, flash_fwd.softcap_launches) == (
        before[0] + (window is not None), before[1] + (softcap is not None))
    for g, w in zip(got, naive.naive_attention(q, k, v, return_lse=True, **kw)):
        torch.testing.assert_close(g, w, **TOL)
    if window is not None:  # an off-by-one in the window must not pass
        wrong = naive.naive_attention(q, k, v, **dict(kw, window=window + 1))
        assert (got[0].float() - wrong.float()).abs().max().item() > TOL["atol"]


# The softcap where it binds: q scaled so that the scores reach several
# times the cap (with scores of std 1, a cap of 50 moves the output by
# ~1e-5, and a kernel without the tanh would pass)
SOFTCAP_BINDS = {"E128_cap5": (128, 32, 8, 5.0, 4.0), "E256_cap50": (256, 8, 4, 50.0, 40.0)}


@pytest.mark.parametrize("window", [None, 33], ids=["no_window", "window33"])
@pytest.mark.parametrize("case", list(SOFTCAP_BINDS))
def test_flash_kernel_softcap_binds(gen, case, window):
    E, QH, KH, softcap, q_scale = SOFTCAP_BINDS[case]
    q = _bf(gen, 1, QH, 128, E, scale=q_scale)
    k, v = _bf(gen, 1, KH, 512, E), _bf(gen, 1, KH, 512, E)
    kw = dict(causal=True, scale=E ** -0.5, causal_offset=200, window=window, softcap=softcap,
              kpad_mask=(torch.arange(512, device="cuda") < 328)[None])
    mode = (E, window is not None, True)
    before = flash_fwd.mode_launches.get(mode, 0)
    got = flash_fwd(q, k, v, **kw)
    assert flash_fwd.mode_launches[mode] == before + 1
    for g, w in zip(got, naive.naive_attention(q, k, v, return_lse=True, **kw)):
        torch.testing.assert_close(g, w, **TOL)
    uncapped = naive.naive_attention(q, k, v, **dict(kw, softcap=None))
    assert (got[0].float() - uncapped.float()).abs().max().item() > TOL["atol"]


# Kernel C's edges: lengths just under, at and over its 128-row blocks (64
# where a call has few) and its key tiles (64 keys; 32 at head dim 256
# with a pair or segment ids), a block whose second warpgroup holds no row
# (QL 60) or one (65), an offset that is no tile multiple, kpad ending
# mid-tile, GQA groups 1, 4 and 8 and MQA, windows below a tile
FLASH_EDGE_CASES = {
    # name: (E, QH, KH, QL, KL, causal, offset, n_valid, window)
    **{f"causal_L{n}": (128, 8, 2, n, n, True, 0, None, None) for n in (1, 63, 64, 65, 127,
                                                                        129, 300)},
    **{f"noncausal_q{m}_k{n}": (128, 8, 2, m, n, False, 0, None, None)
       for m, n in ((1, 300), (60, 129), (65, 127), (129, 63))},
    "offset77_kpad301": (128, 8, 2, 200, 500, True, 77, 301, None),
    "offset77_kpad301_noncausal": (128, 8, 2, 200, 500, False, 77, 301, None),
    "gqa1": (128, 4, 4, 129, 129, True, 0, None, None),
    "gqa8": (128, 16, 2, 129, 129, True, 0, None, None),
    "mqa": (128, 8, 1, 300, 300, True, 0, None, None),
    "E64_L129_offset77": (64, 8, 2, 129, 300, True, 77, 250, None),
    "E64_mqa_L65": (64, 8, 1, 65, 65, True, 0, None, None),
    "E256_L129_offset77": (256, 8, 2, 129, 300, True, 77, 250, None),
    "E256_L63": (256, 8, 4, 63, 63, True, 0, None, None),
    "E256_noncausal_q65_k129": (256, 8, 1, 65, 129, False, 0, None, None),
    "window1": (128, 8, 2, 300, 300, True, 0, None, 1),
    "window17_offset77": (128, 8, 2, 200, 500, True, 77, 301, 17),
    "E256_window17": (256, 8, 4, 129, 300, True, 100, None, 17),
}


@pytest.mark.parametrize("case", list(FLASH_EDGE_CASES))
def test_flash_kernel_edges(gen, case):
    """C against the plain version: o and lse within 2e-2, o within 1e-2
    per 64-row tile; rows that see no key give zeros."""
    E, QH, KH, QL, KL, causal, offset, n_valid, window = FLASH_EDGE_CASES[case]
    q, k, v = _bf(gen, 2, QH, QL, E), _bf(gen, 2, KH, KL, E), _bf(gen, 2, KH, KL, E)
    kw = dict(causal=causal, scale=E ** -0.5, causal_offset=offset, window=window)
    if n_valid is not None:
        kw["kpad_mask"] = (torch.arange(KL, device="cuda") < n_valid)[None].repeat(2, 1)
    o, lse = flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = naive.naive_attention(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(o, o_ref, **TOL)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    assert _tile_rel_err(o, o_ref) <= 1e-2


@pytest.mark.parametrize("E", [32, 64, 96, 128, 256])
def test_flash_attention_head_dims(gen, E):
    """flash_attention at every head dim class (32 and 96 zero-padded to
    the kernel's 64 and 128) at 129 rows over 129 keys, causal."""
    q, k, v = _bf(gen, 2, 8, 129, E), _bf(gen, 2, 2, 129, E), _bf(gen, 2, 2, 129, E)
    with torch.no_grad():
        o = flash_attention(q, k, v, causal=True)
    o_ref = naive.naive_attention(q, k, v, causal=True, scale=E ** -0.5)
    assert o.shape == q.shape and _tile_rel_err(o, o_ref) <= 1e-2


# Segment ids the kernel's key-tile skip must treat exactly: shuffled
# (unsorted) ids, and documents whose edges fall inside key tiles and row
# blocks; with the pair and with the softcap, which share the skip
SEGMENT_EDGE_CASES = {
    # name: (E, causal, layout, pair dtype or None, softcap)
    "shuffled_noncausal": (128, False, "shuffled", None, None),
    "shuffled_causal": (128, True, "shuffled", None, None),
    "cross_tiles_causal": (128, True, "cross", None, None),
    "cross_tiles_E64": (64, True, "cross", None, None),
    "cross_tiles_E256_softcap": (256, True, "cross", None, 5.0),
    "shuffled_E256_softcap": (256, False, "shuffled", None, 5.0),
    "cross_tiles_pair_f32": (128, True, "cross", torch.float32, None),
    "shuffled_pair_bf16": (64, False, "shuffled", torch.bfloat16, None),
}


@pytest.mark.parametrize("case", list(SEGMENT_EDGE_CASES))
def test_flash_kernel_segment_skip(gen, case):
    """C with segment ids against the plain version per 64-row tile (a
    key tile skipped wrongly drops whole documents' keys and fails);
    without the ids the output differs (the ids bind)."""
    E, causal, layout, pdt, softcap = SEGMENT_EDGE_CASES[case]
    QL = KL = 300
    if layout == "cross":  # documents of 61, 2, 97 and 140 rows: edges inside tiles
        seg = _seg_ids(300, [61, 63, 160]).expand(2, 300).contiguous()
    else:
        base = torch.arange(4, device="cuda", dtype=torch.int32).repeat_interleave(75)
        perm = torch.randperm(300, generator=gen, device="cuda")
        seg = torch.stack([base[perm], base.flip(0)]).contiguous()
    q, k, v = _bf(gen, 2, 8, QL, E, scale=4.0 if softcap else 1.0), _bf(gen, 2, 2, KL, E), \
        _bf(gen, 2, 2, KL, E)
    pair = torch.randn(2, 8, QL, KL, generator=gen, device="cuda").to(pdt) if pdt else None
    kw = dict(causal=causal, scale=E ** -0.5, pair=pair, segment_ids=(seg, seg), softcap=softcap)
    before = flash_fwd.segment_launches
    o, lse = flash_fwd(q, k, v, **kw)
    assert flash_fwd.segment_launches == before + 1
    o_ref, lse_ref = naive.naive_attention(q, k, v, return_lse=True, **kw)
    assert _tile_rel_err(o, o_ref) <= 1e-2
    torch.testing.assert_close(lse, lse_ref, **TOL)
    without = naive.naive_attention(q, k, v, **dict(kw, segment_ids=None))
    assert _tile_rel_err(o, without) > 1e-2


def _decode_features_inputs(gen, mode, E, KH, QH, quantized):
    """Stacked caches or pools (2 layers) and staging at head dim E, with
    lengths [0, 1, 65, 200] (and a shuffled table for the paged mode)."""
    page = 64
    if mode == "paged":
        shape = (2, 16, KH, page, E)
        perm = torch.randperm(16, generator=gen, device="cuda").to(torch.int32)
        table = torch.full((4, 4), 10_000, dtype=torch.int32, device="cuda")
        table[1, :1], table[2, :2], table[3, :4] = perm[:1], perm[1:3], perm[3:7]
    else:
        shape, table = (2, 4, KH, 256, E), None
    if quantized:
        kq, vq = _q8_cache(gen, *shape), _q8_cache(gen, *shape)
        caches, scales = (kq.values, vq.values), (kq.scale, vq.scale)
    else:
        caches, scales = (_bf(gen, *shape), _bf(gen, *shape)), ()
    lengths = torch.tensor([0, 1, 65, 200], dtype=torch.int32, device="cuda")
    stage = (_bf(gen, 4, 2, KH, 32, E), _bf(gen, 4, 2, KH, 32, E))
    return _bf(gen, 4, QH, 1, E), caches, scales, lengths, table, stage


@pytest.mark.parametrize("window,softcap", [(40, None), (5, None), (None, 50.0), (17, 50.0)],
                         ids=["window40", "window5_in_staging", "softcap50", "window17_softcap"])
@pytest.mark.parametrize("E,QH,KH", [(128, 32, 8), (256, 8, 4), (256, 8, 1)],
                         ids=["E128", "E256", "E256_mqa"])
@pytest.mark.parametrize("mode", ["linear", "paged"])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_decode_kernel_window_softcap(gen, quantized, mode, E, QH, KH, window, softcap):
    q, caches, scales, lengths, table, (ks, vs) = _decode_features_inputs(
        gen, mode, E, KH, QH, quantized)
    kw = dict(k_stage=ks, v_stage=vs, staged_n=7, layer=1, window=window, softcap=softcap)
    if mode == "paged":
        op, plain, args = (paged_decode_attention, naive.naive_paged_decode_attention,
                           (q, *caches, table, lengths, *scales))
    else:
        op, plain, args = (decode_attention, naive.naive_decode_attention,
                           (q, *caches, lengths, *scales))
    before = op.window_launches, op.softcap_launches
    got = op(*args, **kw)
    assert (op.window_launches, op.softcap_launches) == (
        before[0] + (window is not None), before[1] + (softcap is not None))
    assert (got[0] == 0).all()  # the empty slot
    torch.testing.assert_close(got, plain(*args, **kw), **TOL)
    if window is not None:  # an off-by-one in the window must not pass
        wrong = plain(*args, **dict(kw, window=window + 1))
        assert (got.float() - wrong.float()).abs().max().item() > TOL["atol"]


# the verify mode (T > 1): (E, QH, KH, window, softcap, q scale); the
# softcap binds where q is scaled up
VERIFY_MODES = {"E128": (128, 32, 8, None, None, 1.0), "E128_window17": (128, 32, 8, 17, None, 1.0),
                "E256_softcap50_window40": (256, 8, 4, 40, 50.0, 40.0),
                "E256_mqa_window5": (256, 8, 1, 5, None, 1.0)}


@pytest.mark.parametrize("T", [2, 5, 9])
@pytest.mark.parametrize("case", list(VERIFY_MODES))
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_decode_verify_kernel(gen, quantized, case, T):
    """Kernel D's verify mode: T draft tokens, the last T of 11 staged
    rows, against the plain version (per-tile relative error, as every
    attention case of the card); T 9 at G 4 runs two z-blocks. A wrong
    intra-draft mask (one staged row too wide) must not pass."""
    E, QH, KH, window, softcap, q_scale = VERIFY_MODES[case]
    _, caches, scales, lengths, _, (ks, vs) = _decode_features_inputs(
        gen, "linear", E, KH, QH, quantized)
    q = _bf(gen, 4, QH, T, E, scale=q_scale)
    args = (q, *caches, lengths, *scales)
    kw = dict(k_stage=ks, v_stage=vs, staged_n=11, layer=1, window=window, softcap=softcap)
    mode = (E, quantized, window is not None, softcap is not None, True)
    before = decode_attention.verify_launches, decode_attention.mode_launches.get(mode, 0)
    got = decode_attention(*args, **kw)
    assert (decode_attention.verify_launches, decode_attention.mode_launches[mode]) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == q.shape and (got[0] == 0).all()  # the empty slot
    want = naive.naive_decode_attention(*args, **kw)
    assert _tile_rel_err(got, want) <= 1e-2
    wide = naive.naive_decode_attention(*args, **dict(kw, staged_n=12))
    assert _tile_rel_err(got, wide) > 1e-2


@pytest.mark.parametrize("T", [1, 4, 5, 9])
def test_decode_verify_kernel_z_split(gen, T):
    """G 8 (QH 32 over KH 4): a block holds 4 drafts, so T 5 and 9 split
    whole drafts over 2 and 3 z-blocks; every draft's rows are right (a
    dropped last z-block must not pass) and T 1 counts no verify launch."""
    _, caches, _, lengths, _, (ks, vs) = _decode_features_inputs(gen, "linear", 128, 4, 32, False)
    q = _bf(gen, 4, 32, T, 128)
    kw = dict(k_stage=ks, v_stage=vs, staged_n=9, layer=0, window=70)
    before = decode_attention.verify_launches
    got = decode_attention(q, *caches, lengths, **kw)
    assert decode_attention.verify_launches == before + (T > 1)
    want = naive.naive_decode_attention(q, *caches, lengths, **kw)
    assert _tile_rel_err(got, want) <= 1e-2
    if T > 4:
        dropped = want.clone()
        dropped[:, :, (T - 1) // 4 * 4:] = 0
        assert _tile_rel_err(got, dropped) > 1e-2


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_flush_kernel_e256(gen, quantized):
    """Kernel E at Gemma-2's head dim: bit-exact against the plain flush."""
    shape = (2, 4, 4, 256, 256)
    if quantized:
        kq, vq = _q8_cache(gen, *shape), _q8_cache(gen, *shape)
        caches = [kq.values, vq.values, kq.scale, vq.scale]
    else:
        caches = [_bf(gen, *shape), _bf(gen, *shape), None, None]
    ks, vs = _bf(gen, 4, 2, 4, 32, 256, scale=3.0), _bf(gen, 4, 2, 4, 32, 256, scale=3.0)
    lengths = torch.tensor([0, 1, 65, 224], dtype=torch.int32, device="cuda")
    got = [t.clone() if t is not None else None for t in caches]
    flush_staging(*got, ks, vs, lengths)
    naive.naive_flush_staging(caches[0], caches[1], ks, vs, lengths, caches[2], caches[3])
    torch.cuda.synchronize()
    for g, w in zip(got, caches):
        if g is not None:
            assert torch.equal(g, w)


def test_rms_norm_rope_gemma2_shapes(gen):
    """A at Gemma-2's width (2304, offset 1) and B at its head dim 256."""
    x, w = _bf(gen, 64, 2304), _bf(gen, 2304, scale=0.1)
    torch.testing.assert_close(rms_norm(x, w, 1e-6, offset=1.0),
                               naive.naive_rms_norm(x, w, eps=1e-6, offset=1.0), **TOL)
    q, k = _bf(gen, 2, 8, 9, 256, scale=0.5), _bf(gen, 2, 4, 9, 256, scale=0.5)
    cos, sin = RotaryEmbedding(256, 10000.0)(torch.arange(18, device="cuda").view(2, 9) * 300)
    for got, want in zip(llama_rope(q, k, cos, sin), naive.naive_rope(q, k, cos, sin)):
        torch.testing.assert_close(got, want, **TOL)


def _q8_cache(gen, *shape):
    """int8 cache values and per-token scales, as the flush makes them."""
    return quantize(_bf(gen, *shape).float(), axis=-1)


def test_int8_decode_kernel(gen):
    kq, vq = _q8_cache(gen, 2, 4, 8, 256, 128), _q8_cache(gen, 2, 4, 8, 256, 128)
    ks, vs = _bf(gen, 4, 2, 8, 32, 128), _bf(gen, 4, 2, 8, 32, 128)
    lengths = torch.tensor([0, 1, 65, 200], dtype=torch.int32, device="cuda")
    q = _bf(gen, 4, 32, 1, 128)
    args = (q, kq.values, vq.values, lengths, kq.scale, vq.scale)
    kw = dict(k_stage=ks, v_stage=vs, staged_n=7, layer=1)
    before = decode_attention.int8_launches
    got = decode_attention(*args, **kw)
    assert decode_attention.int8_launches == before + 1 and (got[0] == 0).all()
    torch.testing.assert_close(got, naive.naive_decode_attention(*args, **kw), **TOL)


def test_int8_flush_kernel(gen):
    kq, vq = _q8_cache(gen, 2, 4, 8, 256, 128), _q8_cache(gen, 2, 4, 8, 256, 128)
    ks, vs = _bf(gen, 4, 2, 8, 32, 128), _bf(gen, 4, 2, 8, 32, 128)
    lengths = torch.tensor([0, 1, 65, 224], dtype=torch.int32, device="cuda")
    got = [t.clone() for t in (kq.values, vq.values, kq.scale, vq.scale)]
    flush_staging(*got, ks, vs, lengths)
    naive.naive_flush_staging(kq.values, vq.values, ks, vs, lengths, kq.scale, vq.scale)
    torch.cuda.synchronize()
    for g, w in zip(got, (kq.values, vq.values, kq.scale, vq.scale)):
        assert torch.equal(g, w)


def _paged_pool(gen, quantized, n_pages=16, page=128):
    """Stacked pools (2 layers) of bf16 or int8 with per-token scales,
    and a shuffled table for lengths [0, 1, 129, 300]; unread entries
    hold an id past the pool."""
    shape = (2, n_pages, 8, page, 128)
    if quantized:
        kq, vq = _q8_cache(gen, *shape), _q8_cache(gen, *shape)
        pools = (kq.values, vq.values, kq.scale, vq.scale)
    else:
        pools = (_bf(gen, *shape), _bf(gen, *shape))
    lengths = torch.tensor([0, 1, 129, 300], dtype=torch.int32, device="cuda")
    perm = torch.randperm(n_pages, generator=gen, device="cuda").to(torch.int32)
    table = torch.full((4, 4), 10_000, dtype=torch.int32, device="cuda")
    table[1, :1], table[2, :2], table[3, :3] = perm[:1], perm[1:3], perm[3:6]
    return pools, lengths, table


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_paged_decode_kernel(gen, quantized):
    (kp, vp, *scales), lengths, table = _paged_pool(gen, quantized)
    ks, vs = _bf(gen, 4, 2, 8, 32, 128), _bf(gen, 4, 2, 8, 32, 128)
    q = _bf(gen, 4, 32, 1, 128)
    args = (q, kp, vp, table, lengths, *scales)
    kw = dict(k_stage=ks, v_stage=vs, staged_n=9, layer=1)
    before = paged_decode_attention.launches, paged_decode_attention.int8_launches
    got = paged_decode_attention(*args, **kw)
    assert (paged_decode_attention.launches, paged_decode_attention.int8_launches) == (
        before[0] + 1, before[1] + int(quantized))
    assert (got[0] == 0).all()  # the empty slot
    torch.testing.assert_close(got, naive.naive_paged_decode_attention(*args, **kw), **TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_paged_flush_kernel(gen, quantized):
    """Slot 0 is idle with a stale row naming slot 3's first page: that
    page must stay as it was; the rest bit-exact against the plain flush."""
    pools, lengths, table = _paged_pool(gen, quantized)
    table[0] = table[3]
    ks, vs = _bf(gen, 4, 2, 8, 32, 128), _bf(gen, 4, 2, 8, 32, 128)
    base = torch.tensor([0, 1, 100, 250], dtype=torch.int32, device="cuda")
    scales = pools[2:] if quantized else (None, None)
    got = [t.clone() for t in pools[:2]] + [t.clone() if t is not None else None for t in scales]
    flush_staging_paged(*got[:2], *got[2:], ks, vs, base, table, 128)
    want = [t.clone() if t is not None else None for t in (*pools[:2], *scales)]
    naive.naive_flush_staging_paged(*want[:2], ks, vs, base, table, *want[2:])
    torch.cuda.synchronize()
    stale = int(table[3, 0])
    for g, w, old in zip(got, want, (*pools[:2], *scales)):
        if g is not None:
            assert torch.equal(g, w) and torch.equal(g[:, stale], old[:, stale])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32],
                         ids=["bf16", "int8", "f32_scale"])
def test_write_kv_token_kernel(gen, dtype):
    D = 1 if dtype == torch.float32 else 128
    cache = (_bf(gen, 3, 8, 100, D) * 50).to(dtype)
    new = (_bf(gen, 3, 8, 1, D) * 50).to(dtype)
    pos = torch.tensor([0, 57, 99], dtype=torch.int32, device="cuda")
    want = cache.clone()
    naive.naive_write_kv_token(want, new, pos)
    before = write_kv_token.launches
    write_kv_token(cache, new, pos)
    torch.cuda.synchronize()
    assert write_kv_token.launches == before + 1 and torch.equal(cache, want)


def _close_scaled(got, want):
    tol = 2e-2 * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


def _tile_rel_err(got, want, tile=64):
    """The largest |got - want| / |want| (Frobenius norms) over the 64-row
    tiles of each (batch, head): each tile against its own scale, so the
    deep rows and keys, whose gradients are small, are held as tightly as
    the first. A tile whose reference is zero must be zero."""
    def tiles(t):
        t = torch.nn.functional.pad(t, (0, 0, 0, -t.shape[2] % tile))
        return t.reshape(*t.shape[:2], -1, tile * t.shape[3])

    dn = tiles(got.float() - want.float()).norm(dim=-1)
    rn = tiles(want.float()).norm(dim=-1)
    assert not (dn[rn == 0] > 0).any()
    return (dn[rn > 0] / rn[rn > 0]).max().item()


@pytest.mark.parametrize("M,K,N", [(8, 4096, 1024), (300, 1024, 640), (100, 300, 200)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn], ids=["int8", "fp8"])
def test_quantized_matmul_kernel(gen, M, K, N, dtype):
    x, w = _bf(gen, M, K), quantize(_bf(gen, K, N).float(), axis=0, dtype=dtype)
    before = quantized_matmul.launches
    got = quantized_matmul(x, w)
    assert quantized_matmul.launches == before + 1 and got.dtype == torch.bfloat16
    _close_scaled(got, naive.naive_quantized_matmul(x, w))


@pytest.mark.parametrize("M,K,N", [(8, 4096, 1024), (300, 1000, 640)])
def test_quantized_matmul4_kernel(gen, M, K, N):
    x, w = _bf(gen, M, K), quantize4(_bf(gen, K, N).float())
    before = quantized_matmul4.launches
    got = quantized_matmul4(x, w)
    assert quantized_matmul4.launches == before + 1
    _close_scaled(got, naive.naive_quantized_matmul4(x, w))


@pytest.mark.parametrize("M,K,N", [(256, 4096, 1024), (100, 300, 200)])
def test_quantized_matmul_w8a8_kernel(gen, M, K, N):
    xv, xs = quantize_act(_bf(gen, M, K))
    w = quantize(_bf(gen, K, N).float(), axis=0)
    got = quantized_matmul_w8a8((xv, xs), w, out_dtype=torch.float32)
    assert torch.equal(got, naive.naive_quantized_matmul_w8a8(xv, xs, w, torch.float32))
    got = quantized_matmul_w8a8((xv, xs), w)
    _close_scaled(got, naive.naive_quantized_matmul_w8a8(xv, xs, w))


# ---- kernel I: the grouped (MoE) products ----------------------------------

# (block_m, experts of the blocks, real rows of each block, K, N): decode
# blocks of 32 (experts 1, 2, 4-6 hold no row; the trailing blocks are
# clipped to expert 7, as the sort glue makes them, and hold no row), every
# block on one expert (prefill skew), and a ragged K/N (the guarded path)
GROUPED_CASES = {
    "decode_bm32_empty_experts": (32, [0, 3, 3, 7, 7, 7], [5, 32, 1, 2, 0, 0], 4096, 1024),
    "one_expert_bm128": (128, [5, 5, 5], [128, 128, 60], 1024, 640),
    "ragged_K300_N200": (64, [0, 2], [64, 10], 300, 200),
}


def _grouped_inputs(gen, case, E=8):
    bm, groups, rows, K, N = GROUPED_CASES[case]
    x = _bf(gen, bm * len(groups), K)
    real = (torch.arange(bm, device="cuda")[None] < torch.tensor(rows, device="cuda")[:, None])
    x = x * real.reshape(-1, 1).to(x.dtype)  # rows past block_rows are zero, as sorted
    bg = torch.tensor(groups, dtype=torch.int32, device="cuda")
    br = torch.tensor(rows, dtype=torch.int32, device="cuda")
    return x, _bf(gen, E, K, N, scale=K ** -0.5), bg, br, bm


@pytest.mark.parametrize("case", list(GROUPED_CASES))
@pytest.mark.parametrize("mode", ["bf16", "int8", "w8a8", "int4"])
def test_grouped_matmul_kernel(gen, case, mode):
    x, w, bg, br, bm = _grouped_inputs(gen, case)
    for rows in (None, br):  # every tile computed, or the empty ones skipped
        kw = dict(block_m=bm, block_rows=rows)
        if mode == "bf16":
            before = grouped_matmul.launches
            got, want = grouped_matmul(x, w, bg, **kw), naive.naive_grouped_matmul(x, w, bg, bm)
            assert grouped_matmul.launches == before + 1
            torch.testing.assert_close(got, want, **TOL)
        elif mode == "int8":
            wq = quantize(w.float(), axis=1)
            got = grouped_matmul_quantized(x, wq, bg, **kw)
            _close_scaled(got, naive.naive_grouped_matmul_quantized(x, wq, bg, bm))
        elif mode == "w8a8":
            wq = quantize(w.float(), axis=1)
            xv, xs = quantize_act(x)
            got = grouped_matmul_w8a8((xv, xs), wq, bg, out_dtype=torch.float32, **kw)
            assert torch.equal(got, naive.naive_grouped_matmul_w8a8(xv, xs, wq, bg, bm,
                                                                    torch.float32))
            got = grouped_matmul_w8a8((xv, xs), wq, bg, **kw)
            _close_scaled(got, naive.naive_grouped_matmul_w8a8(xv, xs, wq, bg, bm))
        else:
            wq = quantize4_experts(w.float())
            got = _grouped_matmul_q4(x, wq, bg, **kw)
            _close_scaled(got, naive.naive_grouped_matmul4(x, wq, bg, bm))
        if rows is not None:  # the skipped tiles hold exact zeros
            real = torch.arange(bm, device="cuda")[None] < br[:, None]
            assert (got[~real.reshape(-1)] == 0).all()


@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_grouped_backward_kernels(gen, case):
    """The grouped product's backward: dw (csrc/gmm_dw.cu) and dx (kernel I
    on the transposed experts) against their plain versions; an expert
    without a row gets dw exactly 0 (over memory filled with NaN first);
    two dw runs give the same bits; the autograd Function launches kernel
    I twice (forward, dx) and the dw kernel once."""
    x, w, bg, br, bm = _grouped_inputs(gen, case)
    E, K, N = w.shape
    real = torch.arange(bm, device="cuda")[None] < br[:, None]
    dy = _bf(gen, x.shape[0], N) * real.reshape(-1, 1).to(torch.bfloat16)
    junk = torch.full((E, K, N), float("nan"), dtype=torch.bfloat16, device="cuda")
    del junk  # the allocator hands its block to dw
    dw = grouped_matmul_dw(x, dy, bg, block_m=bm, n_experts=E, block_rows=br)
    hit = {int(g) for g, r in zip(bg.tolist(), br.tolist()) if r > 0}
    assert all((dw[e] == 0).all() for e in range(E) if e not in hit)
    _close_scaled(dw, naive.naive_grouped_matmul_dw(x, dy, bg, bm, E, br))
    assert torch.equal(dw, grouped_matmul_dw(x, dy, bg, block_m=bm, n_experts=E, block_rows=br))
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = (grouped_matmul.launches, grouped_matmul.dx_launches, grouped_matmul_dw.launches)
    grouped_matmul(xg, wg, bg, block_m=bm, block_rows=br).backward(dy)
    after = (grouped_matmul.launches, grouped_matmul.dx_launches, grouped_matmul_dw.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 1, 1)
    _close_scaled(xg.grad, naive.naive_grouped_matmul(dy, w.transpose(1, 2).contiguous(), bg, bm))
    assert torch.equal(wg.grad, dw)


# ---- training: A with rstd, A-bwd, B backward, dQ and dK/dV -------------


@pytest.mark.parametrize("rows,offset", [(257, 0.0), (1024, 1.0)])
def test_rms_norm_bwd_kernel(gen, rows, offset):
    """A with the rstd store and A-bwd against the plain forward and
    backward; rstd is f32 (1e-5 relative: the same f32 mean of squares
    summed in another order); dw is an f32 sum over the rows."""
    x, w = _bf(gen, rows, 4096), _bf(gen, 4096, scale=0.1) + 0.5
    dy = _bf(gen, rows, 4096)
    y, rstd = rms_norm_fwd(x, w, 1e-5, offset)
    y_ref, rstd_ref = naive.naive_rms_norm_fwd(x, w, eps=1e-5, offset=offset)
    torch.testing.assert_close(y, y_ref, **TOL)
    torch.testing.assert_close(rstd, rstd_ref, atol=0, rtol=1e-5)
    before = rms_norm_bwd.launches
    dx, dw = rms_norm_bwd(x, w, rstd, dy, offset)
    assert rms_norm_bwd.launches == before + 1 and dx.dtype == torch.bfloat16
    dx_ref, dw_ref = naive.naive_rms_norm_bwd(x, w, rstd, dy, offset)
    torch.testing.assert_close(dx, dx_ref, **TOL)
    # the same f32 products summed over up to 1024 rows in another order
    assert ((dw - dw_ref).norm() / dw_ref.norm()).item() <= 1e-5
    # autograd through the public rms_norm runs the same two kernels
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    fwd0, bwd0 = rms_norm_fwd.launches, rms_norm_bwd.launches
    gx, gw = torch.autograd.grad(rms_norm(xg, wg, 1e-5, offset=offset), (xg, wg), dy)
    assert (rms_norm_fwd.launches, rms_norm_bwd.launches) == (fwd0 + 1, bwd0 + 1)
    assert torch.equal(gx, dx) and gw.dtype == torch.bfloat16


def test_rope_bwd_kernel(gen):
    dq, dk = _bf(gen, 2, 32, 9, 128, scale=0.5), _bf(gen, 2, 8, 9, 128, scale=0.5)
    cos, sin = RotaryEmbedding(128, 500000.0)(torch.arange(18, device="cuda").view(2, 9))
    before = llama_rope_bwd.launches
    got = llama_rope_bwd(dq, dk, cos, sin)
    assert llama_rope_bwd.launches == before + 2
    for g, want in zip(got, naive.naive_rope(dq, dk, cos, sin, -1.0)):
        torch.testing.assert_close(g, want, **TOL)


# (causal, QH, KH, QL, KL, E, kpad): ragged lengths, GQA, E 64 and 128, a
# kpad that hides the first keys (under causal, rows with no visible key)
BWD_CASES = [
    (True, 32, 8, 256, 256, 128, False),
    (True, 8, 2, 200, 200, 64, True),
    (False, 8, 2, 100, 300, 128, True),
    (False, 4, 4, 65, 130, 64, False),
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_kernels(gen, case):
    """dQ and dK/dV against the plain backward, from kernel C's o and
    lse; each 64-row query or key tile of each head within 1e-2 relative
    error (bf16 rounding of the outputs, and of P and dS where the fp32
    sums before them differ in order: chip_smoke.py phase 3 reads at most
    1.1e-3 on an H100 80GB HBM3 at 700 W, and planted faults at least
    0.12); two runs are bit-identical (no atomics)."""
    causal, QH, KH, QL, KL, E, kpad = case
    q, k, v = _bf(gen, 2, QH, QL, E), _bf(gen, 2, KH, KL, E), _bf(gen, 2, KH, KL, E)
    do = _bf(gen, 2, QH, QL, E)
    mask = None
    if kpad:
        mask = torch.ones((2, KL), dtype=torch.bool, device="cuda")
        mask[1, :7] = False
    kw = dict(causal=causal, scale=E ** -0.5, kpad_mask=mask)
    o, lse = flash_fwd(q, k, v, **kw)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    for g, want in zip(got, naive.naive_attention_bwd(q, k, v, o, lse, do, **kw)):
        assert g.dtype == torch.bfloat16
        assert _tile_rel_err(g, want) <= 1e-2
    if kpad and causal:
        assert (got[0][1, :, :7] == 0).all()  # rows that see no key
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # autograd through flash_attention runs C, then dQ and dK/dV
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, kpad_mask=mask)
    assert torch.equal(out, o)
    assert all(torch.equal(a, b) for a, b in
               zip(torch.autograd.grad(out, leaves, do), got))


# (QH, KH, L, E, window, softcap, q scale, segments): the window (ragged
# lengths, a window shorter than a tile), the softcap where it binds (q
# scaled), both, head dim 256 (GQA and MQA) and segment ids with the
# softcap; every query row sees at least its own key
BWD_FEATURE_CASES = {
    "window40_E128": (8, 2, 300, 128, 40, None, 1.0, False),
    "window17_E64_ragged": (4, 2, 203, 64, 17, None, 1.0, False),
    "softcap5_E128": (8, 2, 256, 128, None, 5.0, 4.0, False),
    "window33_softcap5_E64": (4, 1, 200, 64, 33, 5.0, 4.0, False),
    "E256": (8, 4, 300, 256, None, None, 1.0, False),
    "E256_window100_softcap50": (8, 4, 300, 256, 100, 50.0, 40.0, False),
    "E256_mqa_softcap50": (8, 1, 257, 256, None, 50.0, 40.0, False),
    "segments_E256_window100_softcap50": (8, 4, 256, 256, 100, 50.0, 40.0, True),
    "segments_E128_softcap5": (8, 2, 256, 128, None, 5.0, 4.0, True),
}


@pytest.mark.parametrize("case", list(BWD_FEATURE_CASES))
def test_flash_bwd_window_softcap_kernels(gen, case):
    """dQ and dK/dV with the window, the softcap and head dim 256 (and
    segment ids with the softcap) against the plain backward, from kernel
    C's o and lse, per 64-row query or key tile within 1e-2; the features
    bind (C's o against the plain forward without them reads above 1e-2);
    launches
    counted by mode; two runs bit-identical; autograd through
    flash_attention runs C, dQ and dK/dV in the same mode."""
    QH, KH, L, E, window, softcap, q_scale, segments = BWD_FEATURE_CASES[case]
    q, do = _bf(gen, 2, QH, L, E, scale=q_scale), _bf(gen, 2, QH, L, E)
    k, v = _bf(gen, 2, KH, L, E), _bf(gen, 2, KH, L, E)
    seg = None
    if segments:
        seg = (torch.cat([_seg_ids(L, [70, 71, 150]), _seg_ids(L, [3])]),) * 2
    kw = dict(causal=True, scale=E ** -0.5, window=window, softcap=softcap, segment_ids=seg)
    o, lse = flash_fwd(q, k, v, **kw)
    assert _tile_rel_err(o, naive.naive_attention(q, k, v, **kw)) <= 1e-2
    if window is not None or softcap is not None:  # the features bind
        without = naive.naive_attention(q, k, v, **dict(kw, window=None, softcap=None))
        assert _tile_rel_err(o, without) > 1e-2
    mode = (E, window is not None, softcap is not None)
    before = [(f.mode_launches.get(mode, 0), f.window_launches, f.softcap_launches,
               f.segment_launches) for f in (flash_bwd_dq, flash_bwd_dkv)]
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert [(f.mode_launches[mode], f.window_launches, f.softcap_launches, f.segment_launches)
            for f in (flash_bwd_dq, flash_bwd_dkv)] == [
        (b[0] + 1, b[1] + (window is not None), b[2] + (softcap is not None), b[3] + segments)
        for b in before]
    want = naive.naive_attention_bwd(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and _tile_rel_err(g, w) <= 1e-2
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True, window=window, softcap=softcap, segment_ids=seg)
    assert torch.equal(out, o)
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(out, leaves, do), got))


@pytest.mark.parametrize("window", [None, 40], ids=["no_window", "window40"])
@pytest.mark.parametrize("case", list(SOFTCAP_BINDS))
@pytest.mark.parametrize("mode", ["linear", "paged"])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_decode_kernel_softcap_binds(gen, quantized, mode, case, window):
    E, QH, KH, softcap, q_scale = SOFTCAP_BINDS[case]
    q, caches, scales, lengths, table, (ks, vs) = _decode_features_inputs(
        gen, mode, E, KH, QH, quantized)
    q = (q.float() * q_scale).to(torch.bfloat16)
    kw = dict(k_stage=ks, v_stage=vs, staged_n=7, layer=1, window=window, softcap=softcap)
    if mode == "paged":
        op, plain, args = (paged_decode_attention, naive.naive_paged_decode_attention,
                           (q, *caches, table, lengths, *scales))
    else:
        op, plain, args = (decode_attention, naive.naive_decode_attention,
                           (q, *caches, lengths, *scales))
    mode = (E, quantized, window is not None, True, False)
    before = op.mode_launches.get(mode, 0)
    got = op(*args, **kw)
    assert op.mode_launches[mode] == before + 1
    assert (got[0] == 0).all()  # the empty slot
    torch.testing.assert_close(got, plain(*args, **kw), **TOL)
    uncapped = plain(*args, **dict(kw, softcap=None))
    assert (got.float() - uncapped.float()).abs().max().item() > TOL["atol"]


# ---- the op set: softmax, layer norm, pair bias and segment ids ----------


def _row_rel_err(got, want):
    """The largest |got - want| / |want| (norms over a row's last axis) over
    the rows: each row against its own scale (a softmax row of 4096
    values near 2.4e-4 would pass any absolute 2e-2)."""
    got, want = got.float().reshape(-1, got.shape[-1]), want.float().reshape(-1, want.shape[-1])
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def _rel_tol(dtype):
    return 1e-5 if dtype == torch.float32 else 1e-2


# (rows, E, dtype): one block (E <= 16384) and column chunks (E > 16384;
# the layer norm backward past 8192), ragged widths
ROW_CASES = [(64, 4096, torch.float32), (33, 1000, torch.bfloat16), (3, 128256, torch.float32),
             (5, 20000, torch.bfloat16), (7, 12000, torch.float32)]


@pytest.mark.parametrize("case", ROW_CASES, ids=lambda c: f"{c[0]}x{c[1]}-{str(c[2])[6:]}")
def test_softmax_kernels(gen, case):
    rows, E, dtype = case
    x = (torch.randn(rows, E, generator=gen, device="cuda") * 3).to(dtype)
    dy = torch.randn(rows, E, generator=gen, device="cuda").to(dtype)
    before = softmax_fwd.launches
    y = softmax_fwd(x)
    assert softmax_fwd.launches == before + 1 and y.dtype == dtype
    assert _row_rel_err(y, naive.naive_softmax(x)) <= _rel_tol(dtype)
    before = softmax_bwd.launches
    dx = softmax_bwd(y, dy)
    assert softmax_bwd.launches == before + 1
    assert _row_rel_err(dx, naive.naive_softmax_bwd(y, dy)) <= _rel_tol(dtype)
    # autograd through online_softmax runs the two kernels once each
    xg = x.clone().requires_grad_(True)
    fwd0, bwd0 = softmax_fwd.launches, softmax_bwd.launches
    (g,) = torch.autograd.grad(online_softmax(xg), xg, dy)
    assert (softmax_fwd.launches, softmax_bwd.launches) == (fwd0 + 1, bwd0 + 1)
    assert torch.equal(g, dx)
    # the guard: a row of -inf gives NaN (0 / 0), as the JAX kernel
    x[1] = float("-inf")
    y = softmax_fwd(x)
    assert torch.isnan(y[1]).all() and torch.isfinite(y[torch.arange(rows) != 1]).all()


@pytest.mark.parametrize("case", ROW_CASES, ids=lambda c: f"{c[0]}x{c[1]}-{str(c[2])[6:]}")
def test_layer_norm_kernels(gen, case):
    rows, E, dtype = case
    x = (torch.randn(rows, E, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(E, generator=gen, device="cuda")).to(dtype)
    b = (0.1 * torch.randn(E, generator=gen, device="cuda")).to(dtype)
    dy = torch.randn(rows, E, generator=gen, device="cuda").to(dtype)
    y, mu, sigma = layer_norm_fwd(x, w, b, 1e-5)
    y_ref, mu_ref, sigma_ref = naive.naive_layer_norm_fwd(x, w, b, eps=1e-5)
    assert _row_rel_err(y, y_ref) <= _rel_tol(dtype)
    torch.testing.assert_close(mu, mu_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(sigma, sigma_ref, atol=0, rtol=1e-5)
    before = layer_norm_bwd.launches
    dx, dw, db = layer_norm_bwd(x, w, mu, sigma, dy)
    assert layer_norm_bwd.launches == before + 1 and dx.dtype == dtype
    dx_ref, dw_ref, db_ref = naive.naive_layer_norm_bwd(x, w, mu, sigma, dy)
    assert _row_rel_err(dx, dx_ref) <= _rel_tol(dtype)
    for got, want in ((dw, dw_ref), (db, db_ref)):  # f32 sums over the rows
        assert ((got - want).norm() / want.norm()).item() <= 1e-4
    # autograd through layer_norm: the forward with the stats, then the
    # backward; without grad the forward without them
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    fwd0, st0, bwd0 = layer_norm_fwd.launches, layer_norm_fwd.stats_launches, \
        layer_norm_bwd.launches
    grads = torch.autograd.grad(layer_norm(*leaves, 1e-5), leaves, dy)
    assert (layer_norm_fwd.launches, layer_norm_fwd.stats_launches,
            layer_norm_bwd.launches) == (fwd0 + 1, st0 + 1, bwd0 + 1)
    assert torch.equal(grads[0], dx) and grads[1].dtype == dtype
    with torch.no_grad():  # (compiled apart: not always the same bits)
        assert _row_rel_err(layer_norm(x, w, b, 1e-5), y_ref) <= _rel_tol(dtype)
    assert layer_norm_fwd.stats_launches == st0 + 1


# (causal, QH, KH, QL, KL, E, pair dtype or None, kpad, segments)
PAIR_CASES = {
    "pair_bf16_causal_gqa": (True, 8, 2, 200, 200, 128, torch.bfloat16, False, False),
    "pair_f32_kpad": (False, 4, 4, 130, 190, 64, torch.float32, True, False),
    "segments_causal": (True, 8, 2, 256, 256, 128, None, False, True),
    "pair_segments_kpad_causal": (True, 4, 2, 150, 150, 64, torch.bfloat16, True, True),
}


def _seg_ids(L, cuts):
    """(1, L) int32 segment ids with a new document at each cut."""
    ids = torch.zeros(L, dtype=torch.int32, device="cuda")
    ids[[c for c in cuts if c < L]] = 1
    return (torch.cumsum(ids, 0) + 1).to(torch.int32)[None]


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_flash_pair_segment_kernels(gen, case):
    """C, dQ (with dpair) and dK/dV with the pair bias (N(0, 1), so that a
    kernel dropping it fails) and segment ids, against the plain forward
    and backward, per 64-row tile within 1e-2; dpair exactly 0 wherever
    the mask hides the score (the tiles past the causal diagonal too);
    launches counted by mode; two runs bit-identical."""
    causal, QH, KH, QL, KL, E, pdt, kpad, segments = PAIR_CASES[case]
    q, k, v = _bf(gen, 2, QH, QL, E), _bf(gen, 2, KH, KL, E), _bf(gen, 2, KH, KL, E)
    do = _bf(gen, 2, QH, QL, E)
    pair = torch.randn(2, QH, QL, KL, generator=gen, device="cuda").to(pdt) if pdt else None
    mask = None
    if kpad:
        mask = torch.ones((2, KL), dtype=torch.bool, device="cuda")
        mask[1, 40:47] = False
    seg = None
    if segments:
        seg = (torch.cat([_seg_ids(QL, [70, 71, 150]), _seg_ids(QL, [3])]),
               torch.cat([_seg_ids(KL, [70, 71, 150]), _seg_ids(KL, [3])]))
    kw = dict(causal=causal, scale=E ** -0.5, kpad_mask=mask, pair=pair, segment_ids=seg)
    counts = (flash_fwd.pair_launches, flash_fwd.segment_launches)
    o, lse = flash_fwd(q, k, v, **kw)
    assert (flash_fwd.pair_launches, flash_fwd.segment_launches) == (
        counts[0] + (pair is not None), counts[1] + segments)
    o_ref, lse_ref = naive.naive_attention(q, k, v, return_lse=True, **kw)
    assert _tile_rel_err(o, o_ref) <= 1e-2
    without = naive.naive_attention(q, k, v, **dict(kw, pair=None, segment_ids=None))
    assert _tile_rel_err(o, without) > 1e-2  # the features bind
    counts = [(f.pair_launches, f.segment_launches) for f in (flash_bwd_dq, flash_bwd_dkv)]
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert [(f.pair_launches, f.segment_launches) for f in (flash_bwd_dq, flash_bwd_dkv)] == [
        (c[0] + (pair is not None), c[1] + segments) for c in counts]
    want = naive.naive_attention_bwd(q, k, v, o, lse, do, **kw)
    assert len(got) == len(want) == 3 + (pair is not None)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _tile_rel_err(g, w) <= 1e-2
    if pair is not None:
        hidden = torch.ones((2, 1, QL, KL), dtype=torch.bool, device="cuda")
        if causal:
            hidden &= torch.ones(QL, KL, dtype=torch.bool, device="cuda").tril()
        if kpad:
            hidden &= mask[:, None, None, :]
        if segments:
            hidden &= seg[0][:, None, :, None] == seg[1][:, None, None, :]
        assert (got[3][~hidden.expand_as(got[3])] == 0).all()
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # autograd through flash_attention: C, then dQ and dK/dV, dpair as the
    # pair's gradient
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    if pair is not None:
        leaves.append(pair.clone().requires_grad_(True))
    out = flash_attention(*leaves[:3], leaves[3] if pair is not None else None, causal=causal,
                          kpad_mask=mask, segment_ids=seg)
    assert torch.equal(out, o)
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(out, leaves, do), got))


@pytest.mark.parametrize("E", [32, 96])
def test_flash_attention_padded_head_dims(gen, E):
    """Head dims the kernels reach by zero-padding (32 -> 64, 96 -> 128),
    forward and backward through flash_attention, against the plain
    versions at the true head dim."""
    q, k, v = _bf(gen, 2, 8, 150, E), _bf(gen, 2, 2, 150, E), _bf(gen, 2, 2, 150, E)
    do = _bf(gen, 2, 8, 150, E)
    kw = dict(causal=True, scale=E ** -0.5)
    with torch.no_grad():
        before = flash_fwd.mode_launches.get((64 if E == 32 else 128, False, False), 0)
        o = flash_attention(q, k, v, causal=True)
        assert flash_fwd.mode_launches[(64 if E == 32 else 128, False, False)] == before + 1
    o_ref, lse_ref = naive.naive_attention(q, k, v, return_lse=True, **kw)
    assert o.shape == q.shape and _tile_rel_err(o, o_ref) <= 1e-2
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(flash_attention(*leaves, causal=True), leaves, do)
    for g, w in zip(grads, naive.naive_attention_bwd(q, k, v, o_ref, lse_ref, do, **kw)):
        assert g.shape == w.shape and _tile_rel_err(g, w) <= 1e-2


def _small_e_inputs(gen, E, kind, mode):
    """Decode operands at head dim E: bf16, int8 (+ scales) or f32 caches
    (q f32 with the f32 cache), linear or paged, T 1, or T 5 (verify)."""
    q, caches, scales, lengths, table, stage = _decode_features_inputs(
        gen, "paged" if mode == "paged" else "linear", E, 2, 8, kind == "int8")
    if mode == "verify":
        q = _bf(gen, 4, 8, 5, E)
    if kind == "f32":
        q, caches = q.float(), tuple(c.float() for c in caches)
    if mode == "paged":
        return paged_decode_attention, naive.naive_paged_decode_attention, (
            q, *caches, table, lengths, *scales), stage
    return decode_attention, naive.naive_decode_attention, (q, *caches, lengths, *scales), stage


@pytest.mark.parametrize("mode", ["linear", "paged", "verify"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("E", [32, 64])
def test_decode_kernel_small_head_dims(gen, E, kind, mode):
    """Kernel D at head dims 32 (`tiny`) and 64 against the plain version,
    with the window: every cache type, linear and paged, T 1 and T 5."""
    op, plain, args, (ks, vs) = _small_e_inputs(gen, E, kind, mode)
    kw = dict(k_stage=ks, v_stage=vs, staged_n=7, layer=1, window=40)
    before = op.mode_launches.get((E, kind == "int8", True, False, mode == "verify"), 0)
    got = op(*args, **kw)
    assert op.mode_launches[(E, kind == "int8", True, False, mode == "verify")] == before + 1
    assert got.dtype == args[0].dtype and got.shape == args[0].shape and (got[0] == 0).all()
    assert _tile_rel_err(got, plain(*args, **kw)) <= 1e-2


def test_decode_kernel_head_dim_refused(gen):
    """Head dims the kernel cannot take raise ValueError naming E."""
    for E in (40, 272):
        q, cache = _bf(gen, 2, 4, 1, E), _bf(gen, 2, 2, 64, E)
        with pytest.raises(ValueError, match=f"E={E}"):
            decode_attention(q, cache, cache, torch.tensor([3, 9], dtype=torch.int32,
                                                          device="cuda"))


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, MAX_SPLIT])
@pytest.mark.parametrize("T,window", [(1, None), (5, 300)], ids=["T1", "verify_window300"])
def test_decode_kernel_forced_splits(gen, T, window, n_split):
    """The split-KV combine: any split count gives the plain version's
    result within the tolerance, and a rerun gives the same bits."""
    NL, B, KH, S, E = 2, 4, 4, 2112, 128
    caches = (_bf(gen, NL, B, KH, S, E), _bf(gen, NL, B, KH, S, E))
    stage = (_bf(gen, B, NL, KH, 32, E), _bf(gen, B, NL, KH, 32, E))
    lengths = torch.tensor([0, 100, 1000, 2100], dtype=torch.int32, device="cuda")
    q = _bf(gen, B, 16, T, E)
    kw = dict(k_stage=stage[0], v_stage=stage[1], staged_n=9, layer=1, window=window,
              softcap=None)
    got = launch_decode("decode_attention", q, *caches, lengths, None, None, None,
                        scale=E ** -0.5, n_split=n_split, **kw)
    again = launch_decode("decode_attention", q, *caches, lengths, None, None, None,
                          scale=E ** -0.5, n_split=n_split, **kw)
    assert torch.equal(got, again) and (got[0] == 0).all()
    kw.pop("softcap")
    assert _tile_rel_err(got, naive.naive_decode_attention(q, *caches, lengths, **kw)) <= 1e-2


def test_decode_kernel_refuses_a_short_workspace(gen, monkeypatch):
    """The kernel sizes its split workspace by its own row rule: a
    workspace sized by a rule that gives fewer rows (16-row blocks where
    a verify step of 40 rows takes two 32-row blocks: 48 rows, not 64) is
    refused at launch, not written past."""
    import nnop_tpu_torch.ops.attention_decode as ad

    NL, B, KH, S, E, T = 1, 2, 2, 256, 128, 5
    caches = (_bf(gen, NL, B, KH, S, E), _bf(gen, NL, B, KH, S, E))
    stage = (_bf(gen, B, NL, KH, 8, E), _bf(gen, B, NL, KH, 8, E))
    q, lengths = _bf(gen, B, 16, T, E), torch.tensor([50, 200], dtype=torch.int32, device="cuda")
    kw = dict(scale=E ** -0.5, k_stage=stage[0], v_stage=stage[1], staged_n=T, layer=0,
              window=None, softcap=None, n_split=2)
    assert ad.block_rows(T, 8, E, False) == (32, 2)
    launch_decode("decode_attention", q, *caches, lengths, None, None, None, **kw)
    monkeypatch.setattr(ad, "block_rows", lambda T, G, E, paged: (16, -(-T // (16 // G))))
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch_decode("decode_attention", q, *caches, lengths, None, None, None, **kw)


@pytest.mark.parametrize("E", [32, 128])
def test_flash_attention_f32_operands(gen, E):
    """f32 q, k, v through flash_attention on the card: rounded to bf16
    at the op boundary (the kernels run), o and the gradients in f32,
    within 1e-2 per tile of the plain f32 version."""
    q, k, v, do = (torch.randn(s, generator=gen, device="cuda")
                   for s in ((2, 8, 150, E), (2, 2, 150, E), (2, 2, 150, E), (2, 8, 150, E)))
    before = flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(o, leaves, do)
    assert (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches) == tuple(
        n + 1 for n in before)
    kw = dict(causal=True, scale=E ** -0.5)
    o_ref, lse_ref = naive.naive_attention(q, k, v, return_lse=True, **kw)
    assert o.dtype == torch.float32 and _tile_rel_err(o, o_ref) <= 1e-2
    for g, w in zip(grads, naive.naive_attention_bwd(q, k, v, o_ref, lse_ref, do, **kw)):
        assert g.dtype == torch.float32 and _tile_rel_err(g, w) <= 1e-2


def _to(tree, device):
    if isinstance(tree, dict):
        return {key: _to(val, device) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(val, device) for val in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def test_tiny_f32_engine_on_cuda(gen):
    """The CLI's default model (f32 `tiny`, head dim 32) served on the
    card: C at prefill and D and E at decode, in f32 through bf16
    operands. Its greedy streams are the CPU engine's (the plain
    versions, in f32), or part only where the plain forward's logits of
    the two tokens tie within 1e-2 x max|logit|."""
    from nnop_tpu_torch.runtime.engine import Engine

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    prompts = [[1, 2, 3, 1, 2, 3], list(range(40)), [7] * 17, list(range(200, 100, -1))]
    before = decode_attention.launches, flash_fwd.launches
    streams = []
    for p in (params, _to(params, "cuda")):
        eng = Engine(p, cfg, max_batch=4, max_seq=256)
        reqs = [eng.submit(pr, max_new_tokens=24) for pr in prompts]
        eng.run()
        streams.append([r.out for r in reqs])
    assert decode_attention.launches > before[0] and flash_fwd.launches > before[1]
    for prompt, cpu, card in zip(prompts, *streams):
        assert len(cpu) == len(card) == 24
        i = next((i for i, (a, b) in enumerate(zip(cpu, card)) if a != b), None)
        if i is None:
            continue
        toks = torch.tensor([prompt + cpu[:i]])
        logits = forward(params, toks, cfg, plain=True)[0, -1]
        gap = (logits[cpu[i]] - logits[card[i]]).abs().item()
        assert gap <= 1e-2 * logits.abs().max().item(), (i, gap)
