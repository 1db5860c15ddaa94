"""The speculative-decoding ops of the port against the JAX package's on
the CPU: decode attention's multi-token verify mode (T > 1, the JAX
Pallas kernel in interpret mode against the port's plain path), the
prompt-lookup drafter and the rejection-sampling verify.

Tolerances: 5e-5 for attention (sums over keys in another order; f32
queries, so P rounds to the cache's type in the same place on both
sides); the drafter is integer work and must be exact; the verify's
emitted-token distribution is held to 0.012 absolute per token over
40000 draws, as tests/test_engine.py holds the JAX one (its sampling
noise is ~0.0025 at p = 0.5, so 0.012 is ~5 sigma).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnop_tpu.ops.attention_decode import decode_attention as j_decode_attention
from nnop_tpu.runtime.engine import ngram_draft as j_ngram_draft
from nnop_tpu_torch.models.weights import tensor_from_numpy
from nnop_tpu_torch.ops.attention_decode import decode_attention
from nnop_tpu_torch.ops.attention_decode_paged import paged_decode_attention
from nnop_tpu_torch.runtime.engine import ngram_draft, spec_accept

ATOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and a default thread pool per worker oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return tensor_from_numpy(np.asarray(a))


# (cache kind, E, QH, KH, T, staged_n, window, softcap, q scale): one idle
# slot in every case; staged_n > T once; the softcap binds where q is
# scaled up; window 6 < staged_n 7 reaches into the drafts' own rows
VERIFY_CASES = {
    "bf16_cache": ("bf16", 32, 8, 2, 2, 2, None, None, 1.0),
    "int8_cache": ("int8", 32, 8, 2, 5, 7, None, None, 1.0),
    "window_softcap": ("f32", 32, 8, 2, 5, 7, 6, 5.0, 8.0),
    "e256_g2_window": ("f32", 256, 4, 2, 2, 5, 40, None, 1.0),
}


@pytest.mark.parametrize("case", list(VERIFY_CASES))
def test_decode_verify_matches_jax(case):
    kind, E, QH, KH, T, n_st, window, softcap, q_scale = VERIFY_CASES[case]
    rng = np.random.default_rng(11)
    B, S, nl, W = 4, 96, 2, 8
    lengths = np.array([0, 3, 45, 90], np.int32)
    q = (rng.standard_normal((B, QH, T, E)) * q_scale).astype(np.float32)
    kc, vc = (rng.standard_normal((nl, B, KH, S, E)).astype(np.float32) for _ in range(2))
    ks, vs = (jnp.asarray(rng.standard_normal((B, nl, KH, W, E)), jnp.bfloat16)
              for _ in range(2))
    scales = ()
    if kind == "int8":
        kc, vc = (rng.integers(-127, 128, (nl, B, KH, S, E)).astype(np.int8) for _ in range(2))
        scales = tuple((rng.random((nl, B, KH, S)) * 0.02 + 0.01).astype(np.float32)
                       for _ in range(2))
    elif kind == "bf16":
        kc, vc = jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16)
    kw = dict(staged_n=n_st, layer=1, window=window, softcap=softcap)
    want = j_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(lengths), *map(jnp.asarray, scales), k_stage=ks,
                              v_stage=vs, **kw)
    got = decode_attention(_t(q), _t(kc), _t(vc), _t(lengths), *map(_t, scales),
                           k_stage=_t(ks), v_stage=_t(vs), **kw)
    assert got.shape == (B, QH, T, E)
    assert (got[0] == 0).all()  # the idle slot
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_decode_verify_refusals():
    """T > 1 needs the drafts' K/V as the last staged rows, as the JAX op
    does (it raises without staging); the paged op is single-token."""
    q = torch.zeros(1, 4, 3, 32)
    cache = torch.zeros(1, 2, 8, 32)
    stage = torch.zeros(1, 2, 4, 32, dtype=torch.bfloat16)
    lengths = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="staged"):
        decode_attention(q, cache, cache, lengths)
    with pytest.raises(ValueError, match="staged_n >= T"):
        decode_attention(q, cache, cache, lengths, k_stage=stage, v_stage=stage, staged_n=2)
    assert decode_attention(q, cache, cache, lengths, k_stage=stage, v_stage=stage,
                            staged_n=3).shape == q.shape
    table = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="single-token"):
        paged_decode_attention(q, cache, cache, table, lengths, k_stage=stage, v_stage=stage,
                               staged_n=3)


def _draft_both(hist, vlen, k):
    want = j_ngram_draft(jnp.asarray(hist, jnp.int32), jnp.asarray(vlen, jnp.int32), k)
    got = ngram_draft(torch.from_numpy(np.asarray(hist, np.int32)),
                      torch.from_numpy(np.asarray(vlen, np.int32)), k)
    return got.tolist(), np.asarray(want).tolist()


def test_ngram_draft_matches_jax():
    # the two cases of tests/test_engine.py:242-254
    got, want = _draft_both([[3, 5, 9, 2, 3, 5, 8, 0]], [6], 2)
    assert got == want == [[9, 2]]
    got, want = _draft_both([[1, 2, 3, 4, 0, 0, 0, 0]], [4], 3)
    assert got == want == [[4, 4, 4]]
    # random histories over a small vocabulary with planted repeats: a
    # bigram and its continuation copied earlier; continuations that run
    # past vlen; a slot of vlen 0 and one of vlen 1
    rng = np.random.default_rng(3)
    B, S = 16, 48
    hist = rng.integers(0, 9, (B, S)).astype(np.int32)
    vlen = rng.integers(2, S + 1, B).astype(np.int32)
    vlen[:2] = (0, 1)
    for b in range(2, B, 2):
        n = int(vlen[b])
        src = rng.integers(0, max(1, n - 6))
        hist[b, n - 2:n] = hist[b, src:src + 2]
    for k in (1, 4, 9):
        got, want = _draft_both(hist, vlen, k)
        assert got == want, k


def test_spec_accept_preserves_distribution():
    """tests/test_engine.py:496-532 on the port, over a batch of rows with
    one torch.Generator: whatever the drafts propose, each emitted token is
    distributed as sequential sampling from the target distribution."""
    V, k, N = 8, 2, 40_000
    rng = np.random.default_rng(0)
    logits = torch.from_numpy((rng.normal(size=(1, k + 1, V)) * 2.0).astype(np.float32))
    p = torch.softmax(logits, -1)[0].numpy()
    gen = torch.Generator()
    gen.manual_seed(1)
    for d0 in (0, 3):  # a likely and an arbitrary draft token
        drafts = torch.tensor([[d0, 1]]).expand(N, k)
        c, final = spec_accept(logits.expand(N, k + 1, V), drafts, gen)
        # the first emitted token: draft d0 when c >= 1, else the residual
        first = torch.where(c >= 1, torch.full_like(final, d0), final).numpy()
        np.testing.assert_allclose(np.bincount(first, minlength=V) / N, p[0], atol=0.012)
    # forced acceptance at position 0: the second token must follow p[1]
    big = logits.clone()
    big[0, 0] = -100.0
    big[0, 0, 5] = 100.0
    p1 = torch.softmax(big, -1)[0, 1].numpy()
    c, final = spec_accept(big.expand(N, k + 1, V), torch.tensor([[5, 2]]).expand(N, k), gen)
    assert bool((c >= 1).all())
    second = torch.where(c >= 2, torch.full_like(final, 2), final).numpy()
    np.testing.assert_allclose(np.bincount(second, minlength=V) / N, p1, atol=0.012)
