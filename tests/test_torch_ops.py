"""The port's ops (nnop_tpu_torch.ops) against the JAX package's on the CPU.

The same numpy inputs (from a seed) go through the JAX op — its Pallas
kernels in interpret mode, as the root conftest arranges — and through
the port's plain path, in float32. Tolerances: 1e-5 for the elementwise
ops, 5e-5 for attention (sums over keys in another order); the flush is
a copy and must be exact. The kernels themselves are held to these plain
versions on the card by tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnop_tpu.ops.attention_decode import decode_attention as j_decode_attention
from nnop_tpu.ops.flash_attention import flash_attention as j_flash_attention
from nnop_tpu.ops.flash_attention import flash_attention_chunked as j_flash_attention_chunked
from nnop_tpu.ops.flash_attention import lse_merge as j_lse_merge
from nnop_tpu.ops.kv_write import flush_staging as j_flush_staging
from nnop_tpu.ops.rms_norm import rms_norm as j_rms_norm
from nnop_tpu.ops.rope import RotaryEmbedding as JRotaryEmbedding
from nnop_tpu.ops.rope import llama_rope as j_llama_rope
from nnop_tpu_torch.models.weights import tensor_from_numpy
from nnop_tpu_torch.ops.attention_decode import (
    SPLIT_TILE,
    block_rows,
    decode_attention,
    split_count,
    split_tiles,
)
from nnop_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_chunked,
    flash_fwd,
    lse_merge,
)
from nnop_tpu_torch.ops.naive import naive_decode_attention, naive_decode_partials
from nnop_tpu_torch.ops.kv_write import flush_staging
from nnop_tpu_torch.ops.rms_norm import rms_norm
from nnop_tpu_torch.ops.rope import RotaryEmbedding, llama_rope


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    """A JAX or numpy array as a tensor (bf16 stays bf16, bit-exact)."""
    return tensor_from_numpy(np.asarray(a))


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_matches_jax(offset):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 3, 5, 64), _rand(rng, 64)
    want = j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset=offset)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, offset=offset)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 64)], ids=["plain", "ntk-by-parts"])
def test_rotary_embedding_matches_jax(scaling):
    # orig_len 64 puts the NTK ramp inside the 32-dim frequency range
    pos = np.arange(14, dtype=np.int32).reshape(2, 7) * 3
    jr = JRotaryEmbedding(32, 10000.0, scaling=scaling)
    tr = RotaryEmbedding(32, 10000.0, scaling=scaling)
    np.testing.assert_allclose(tr.inv_freq.numpy(), np.asarray(jr.inv_freq), rtol=1e-6)
    jc, js = jr(jnp.asarray(pos))
    tc, ts = tr(torch.from_numpy(pos))
    assert tc.shape == (2, 7, 32) and tc.dtype == torch.float32
    _close(tc, jc, 1e-5)
    _close(ts, js, 1e-5)


def test_llama_rope_matches_jax():
    rng = np.random.default_rng(1)
    q, k = _rand(rng, 2, 4, 7, 32), _rand(rng, 2, 2, 7, 32)
    cos, sin = JRotaryEmbedding(32)(jnp.arange(7)[None].repeat(2, 0) + 5)
    jq, jk = j_llama_rope(jnp.asarray(q), jnp.asarray(k), cos, sin)
    tq, tk = llama_rope(*(torch.from_numpy(np.array(a)) for a in (q, k, cos, sin)))
    _close(tq, jq, 1e-5)
    _close(tk, jk, 1e-5)
    # sin_sign=-1 inverts the rotation
    bq, bk = llama_rope(tq, tk, *(torch.from_numpy(np.array(a)) for a in (cos, sin)),
                        sin_sign=-1.0)
    _close(bq, q, 1e-5)
    _close(bk, k, 1e-5)


def test_flash_attention_causal_gqa_padded_bucket():
    """A 23-token prompt padded to a 32-row bucket (GQA 4:2): every row,
    padding included, matches the JAX kernel."""
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 1, 4, 32, 32), _rand(rng, 1, 2, 32, 32), _rand(rng, 1, 2, 32, 32)
    q[:, :, 23:] = k[:, :, 23:] = v[:, :, 23:] = 0.0
    want = j_flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    _close(got, want, 5e-5)


def test_flash_attention_chunked_offset_kpad():
    """A 16-row chunk at offset 20 of a 48-row buffer whose rows >= 36
    are padding (kpad)."""
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 1, 4, 16, 32), _rand(rng, 1, 2, 48, 32), _rand(rng, 1, 2, 48, 32)
    kpad = (np.arange(48) < 36)[None]
    want = j_flash_attention_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                                     causal_offset=20, kpad_mask=jnp.asarray(kpad))
    got = flash_attention_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal_offset=20, kpad_mask=torch.from_numpy(kpad))
    _close(got, want, 5e-5)


def test_flash_fwd_lse_and_fully_masked_rows():
    """lse is the row log-sum-exp in nats; a row with no visible key gives
    zeros (not NaN) — the kernel semantics the plain version keeps."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 2, 8, 16)) for _ in range(3))
    kpad = torch.zeros((1, 8), dtype=torch.bool)
    kpad[0, 3:] = True  # rows 0..2 see no key under the causal mask
    o, lse = flash_fwd(q, k, v, causal=True, scale=0.25, kpad_mask=kpad)
    assert torch.isfinite(o).all() and (o[:, :, :3] == 0).all()
    s = torch.einsum("bhqe,bhke->bhqk", q, k) * 0.25
    mask = kpad[:, None, None, :] & torch.ones(8, 8, dtype=torch.bool).tril()
    want = torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)[:, :, 3:]
    torch.testing.assert_close(lse[:, :, 3:], want, atol=1e-5, rtol=0)


def test_decode_attention_stacked_staging_ragged():
    """Stacked cache (2 layers), bf16 staging with 3 live rows, ragged
    lengths including an empty slot (which must give zeros)."""
    rng = np.random.default_rng(5)
    B, QH, KH, S, E, NL, W = 3, 4, 2, 64, 32, 2, 32
    q = _rand(rng, B, QH, 1, E)
    kc, vc = _rand(rng, NL, B, KH, S, E), _rand(rng, NL, B, KH, S, E)
    ks = jnp.asarray(_rand(rng, B, NL, KH, W, E), jnp.bfloat16)
    vs = jnp.asarray(_rand(rng, B, NL, KH, W, E), jnp.bfloat16)
    lengths = np.array([0, 5, 40], np.int32)
    want = j_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(lengths), k_stage=ks, v_stage=vs, staged_n=3,
                              layer=1)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                           torch.from_numpy(lengths), k_stage=_t(ks), v_stage=_t(vs),
                           staged_n=3, layer=1)
    assert (got[0] == 0).all()
    _close(got, want, 5e-5)


def test_flush_staging_exact():
    rng = np.random.default_rng(6)
    NL, B, KH, S, E, W = 2, 3, 2, 128, 32, 32
    kc, vc = _rand(rng, NL, B, KH, S, E), _rand(rng, NL, B, KH, S, E)
    ks = jnp.asarray(_rand(rng, B, NL, KH, W, E), jnp.bfloat16)
    vs = jnp.asarray(_rand(rng, B, NL, KH, W, E), jnp.bfloat16)
    lengths = np.array([0, 5, 40], np.int32)
    jk, jv, _, _ = j_flush_staging(jnp.asarray(kc), jnp.asarray(vc), None, None, ks, vs,
                                   jnp.asarray(lengths))
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    out = flush_staging(tk, tv, None, None, _t(ks), _t(vs), torch.from_numpy(lengths))
    assert out[0] is tk and out[1] is tv  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_unported_features_raise_on_the_kernel_path():
    q = torch.zeros(1, 4, 1, 32)
    cache = torch.zeros(1, 2, 8, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 cache"):  # the int8 cache needs its scales
        decode_attention(q, cache, cache, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="staged"):  # T > 1 verifies staged drafts
        decode_attention(torch.zeros(1, 4, 2, 32), cache.float(), cache.float(),
                         torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_lse_merge_matches_jax(dtype):
    """The (o, lse) monoid of two partials, finite lse, f32 or bf16 o."""
    rng = np.random.default_rng(7)
    o1, o2 = (jnp.asarray(_rand(rng, 2, 3, 5, 16), dtype) for _ in range(2))
    lse1, lse2 = (jnp.asarray(_rand(rng, 2, 3, 5, 1) * 4) for _ in range(2))
    want_o, want_lse = j_lse_merge(o1, lse1, o2, lse2)
    got_o, got_lse = lse_merge(_t(o1), _t(lse1), _t(o2), _t(lse2))
    assert got_o.dtype == _t(want_o).dtype
    _close(got_o, want_o, 1e-6)
    _close(got_lse, want_lse, 1e-6)


def _live_first(length, staged_n, T, window):
    """The first live cache row of a slot for its first draft (kernel D's
    walk start)."""
    return max(0, length + staged_n - T + 1 - window) if window else 0


@pytest.mark.parametrize("window", [None, 100], ids=["no_window", "window100"])
def test_decode_split_then_merge_equals_whole(window):
    """Kernel D's split-KV in plain form: each split's (o, lse) over the
    plan's tiles (the staged rows in the last split), merged with
    lse_merge in split order, is the whole call's (o, lse) in f32: lse
    within 1e-5 (l sums the unrounded P), o within the bf16 rounding of
    the staging part's P (2^-8: each split rounds P against its own
    running maximum, the whole call against the cache part's). Dropping
    the split that holds the longest slot's middle rows (a planted fault)
    must read far past both."""
    rng = np.random.default_rng(8)
    lens = [0, 1, 31, 32, 33, 2100]
    B, KH, G, T, E, S, NL, W, n_st = len(lens), 2, 4, 5, 64, 2112, 1, 8, 6
    q = torch.from_numpy(_rand(rng, B, KH * G, T, E) * 2)
    kc, vc = (torch.from_numpy(_rand(rng, NL, B, KH, S, E)) for _ in range(2))
    ks, vs = (torch.from_numpy(_rand(rng, B, NL, KH, W, E)).to(torch.bfloat16) for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32)
    kw = dict(k_stage=ks, v_stage=vs, staged_n=n_st, layer=0, window=window)
    whole = naive_decode_attention(q, kc, vc, lengths, **kw)
    everything = [(torch.zeros(B, dtype=torch.long), torch.full((B,), S))]
    [(whole_o, whole_lse)] = naive_decode_partials(q, kc, vc, lengths, ranges=everything,
                                                   stage_split=0, **kw)
    np.testing.assert_allclose(whole_o.numpy(), whole.numpy(), atol=1e-6, rtol=0)

    rows, Z = block_rows(T, G, E, paged=False)
    assert (rows, Z) == (32, 1)
    span = min(S, window + SPLIT_TILE) if window else S
    n_split = split_count(B * KH * Z, span, n_sm=132)
    assert n_split == (3 if window else 22)
    tiles = [[split_tiles(n, _live_first(n, n_st, T, window), n_split, s) for n in lens]
             for s in range(n_split)]
    ranges = [(torch.tensor([lo * SPLIT_TILE for lo, _ in t]),
               torch.tensor([max(lo, hi) * SPLIT_TILE for lo, hi in t])) for t in tiles]
    parts = naive_decode_partials(q, kc, vc, lengths, ranges=ranges, stage_split=n_split - 1,
                                  **kw)
    mid = (_live_first(2100, n_st, T, window) + 2100) // 2 // SPLIT_TILE
    drop = next(s for s, t in enumerate(tiles) if t[-1][0] <= mid < t[-1][1])

    def merged(skip=None):
        kept = [part for s, part in enumerate(parts) if s != skip]
        o, lse = kept[0]
        for o_s, lse_s in kept[1:]:
            o, lse = lse_merge(o, lse, o_s, lse_s)
        return o, lse

    o, lse = merged()
    assert bool(torch.isfinite(o).all()) and (o[0] == 0).all()  # the empty slot
    np.testing.assert_allclose(lse[1:].numpy(), whole_lse[1:].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(o.numpy(), whole.numpy(), atol=2.0 ** -8, rtol=0)
    o, lse = merged(skip=drop)
    assert (lse[-1] - whole_lse[-1]).abs().max() > 1e-2
    assert (o[-1] - whole[-1]).abs().max() > 2.0 ** -4


def test_decode_split_plan_covers_every_live_row_once():
    """split_tiles: the splits' tiles, cut to the live rows [first, len),
    cover every live row exactly once, in order, for ragged lengths,
    window edges and every split count; split_count stays in its bounds."""
    for length in (0, 1, 31, 32, 33, 63, 64, 65, 300, 2100):
        for first in sorted({0, 1, 40, max(0, length - 100), length}):
            if first > length:
                continue
            for n_split in (1, 2, 3, 7, 33, 128):
                seen = []
                for s in range(n_split):
                    lo, hi = split_tiles(length, first, n_split, s)
                    seen += [r for r in range(lo * SPLIT_TILE, hi * SPLIT_TILE)
                             if first <= r < length]
                assert seen == list(range(first, length)), (length, first, n_split)
    assert split_count(1, 8192, 132) == 128 and split_count(1, 8192 * 64, 132) == 128
    assert split_count(64, 2144, 132) == 5 and split_count(512, 2144, 132) == 1
    assert split_count(16, 10, 132) == 1 and split_count(16, 8192, 132) == 17
