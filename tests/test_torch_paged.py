"""The port's paged serving against the JAX package on the CPU.

Ops (the same numpy inputs through both packages): the plain paged decode
attention against the JAX `paged_decode_attention` in interpret mode
(5e-5: f32 sums in another order), the paged flush and `write_kv_token`
bit-exact, and `PagedKVCache` against the JAX one. Engine: greedy streams
of `Engine(paged=True)` IDENTICAL to the JAX engine's on the tiny f32
config (f32 pool, int8 pool, a prefix-cache hit), then the JAX paged
tests' behaviours port against port (prefix sharing and release, a mixed
load, retire at admission, warmup, page reuse, a sliding window) and the
idle-slot flush regression.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnop_tpu.models.llama import LlamaConfig as JLlamaConfig
from nnop_tpu.models.llama import init_params as j_init_params
from nnop_tpu.ops.attention_decode_paged import paged_decode_attention as j_paged_decode
from nnop_tpu.ops.kv_write import flush_staging_paged as j_flush_paged
from nnop_tpu.ops.kv_write import write_kv_token as j_write_kv_token
from nnop_tpu.runtime.engine import Engine as JEngine
from nnop_tpu.runtime.paged_cache import PagedKVCache as JPagedKVCache
from nnop_tpu_torch.models.llama import LlamaConfig, forward
from nnop_tpu_torch.models.weights import params_from_numpy
from nnop_tpu_torch.ops.attention_decode_paged import paged_decode_attention
from nnop_tpu_torch.ops.kv_write import flush_staging_paged, write_kv_token
from nnop_tpu_torch.ops.naive import naive_attention
from nnop_tpu_torch.runtime.engine import Engine
from nnop_tpu_torch.runtime.paged_cache import PagedKVCache

JCFG = JLlamaConfig.tiny(dtype=jnp.float32)
CFG = LlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and a default thread pool per worker oversubscribes the
    cores (tens of times slower on these tiny tensors under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---- paged decode attention ---------------------------------------------


def _paged_inputs(quantized, seed=0):
    """Stacked pools (2 layers, 16 pages of 32 tokens), a shuffled table
    whose unread entries hold random ids, an empty slot, staging."""
    rng = np.random.default_rng(seed)
    B, QH, KH, E, page, n_pages, max_pages, nl, W = 4, 8, 2, 128, 32, 16, 5, 2, 8
    lengths = np.array([0, 1, 37, 130], np.int32)
    perm = rng.permutation(n_pages).astype(np.int32)
    table = rng.integers(0, n_pages, (B, max_pages)).astype(np.int32)
    used = 0
    for b, n in enumerate(lengths):
        k = -(-int(n) // page)
        table[b, :k] = perm[used:used + k]
        used += k
    shape = (nl, n_pages, KH, page, E)
    if quantized:
        pools = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        scales = [(rng.random(shape[:4]) * 0.02 + 0.01).astype(np.float32) for _ in range(2)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
        scales = [None, None]
    q = rng.standard_normal((B, QH, 1, E)).astype(np.float32)
    stage = [rng.standard_normal((B, nl, KH, W, E)).astype(np.float32) for _ in range(2)]
    return q, pools, scales, table, lengths, stage


@pytest.mark.parametrize("case", ["f32", "int8", "f32_window_softcap"])
def test_paged_decode_matches_jax(case):
    quantized = case == "int8"
    q, pools, scales, table, lengths, stage = _paged_inputs(quantized)
    kw = dict(staged_n=5, layer=1, scale=0.1)
    if case == "f32_window_softcap":
        kw.update(window=40, softcap=5.0)
    bf = jnp.bfloat16
    want = j_paged_decode(
        jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(table), jnp.asarray(lengths),
        *(jnp.asarray(s) if s is not None else None for s in scales),
        k_stage=jnp.asarray(stage[0], bf), v_stage=jnp.asarray(stage[1], bf), **kw)
    got = paged_decode_attention(
        _t(q), *map(_t, pools), _t(table), _t(lengths),
        *(_t(s) if s is not None else None for s in scales),
        k_stage=_t(stage[0]).to(torch.bfloat16), v_stage=_t(stage[1]).to(torch.bfloat16), **kw)
    assert got.shape == q.shape and (got[0] == 0).all()  # the empty slot
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)


# ---- paged flush ---------------------------------------------------------


def _flush_inputs(kind, seed=1):
    """4 live slots of 3 pages each in a 12-page pool of 128 tokens."""
    rng = np.random.default_rng(seed)
    B, nl, KH, E, W, page, max_pages = 4, 2, 2, 128, 32, 128, 3
    n_pages = B * max_pages
    table = rng.permutation(n_pages).astype(np.int32).reshape(B, max_pages)
    shape = (nl, n_pages, KH, page, E)
    if kind == "int8":
        pools = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        scales = [rng.random(shape[:4]).astype(np.float32) for _ in range(2)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
        scales = [None, None]
    stage = [(rng.standard_normal((B, nl, KH, W, E)) * 3).astype(np.float32) for _ in range(2)]
    return pools, scales, stage, table, page


def _torch_pools(kind, pools, scales):
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}[kind]
    return [_t(p).to(dtype) for p in pools] + [_t(s) if s is not None else None for s in scales]


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
def test_flush_staging_paged_matches_jax(kind):
    pools, scales, stage, table, page = _flush_inputs(kind)
    base = np.array([5, 32, 100, 200], np.int32)  # every slot live
    k_pool, v_pool, k_sc, v_sc = _torch_pools(kind, pools, scales)
    stage_t = [_t(s).to(torch.bfloat16) for s in stage]
    flush_staging_paged(k_pool, v_pool, k_sc, v_sc, *stage_t, _t(base), _t(table), page)
    jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32, "int8": jnp.int8}[kind]
    want = j_flush_paged(
        jnp.asarray(pools[0], jdt), jnp.asarray(pools[1], jdt),
        *(jnp.asarray(s) if s is not None else None for s in scales),
        jnp.asarray(stage[0], jnp.bfloat16), jnp.asarray(stage[1], jnp.bfloat16),
        jnp.asarray(base), jnp.asarray(table), page)
    for g, w in zip((k_pool, v_pool, k_sc, v_sc), want):
        if g is not None:  # every dtype compares exactly in f64
            np.testing.assert_array_equal(g.double().numpy(), np.asarray(w, np.float64))


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_flush_staging_paged_skips_idle_slot(kind):
    """Slot 0 holds no request (base 0) and its stale table row points at
    slot 1's first page; slot 1 writes at 200, in its second page. The
    first page must come out unchanged (the TPU flush overwrites it)."""
    pools, scales, stage, table, page = _flush_inputs(kind)
    table[0] = table[1]
    base = np.array([0, 200, 0, 0], np.int32)
    k_pool, v_pool, k_sc, v_sc = _torch_pools(kind, pools, scales)
    before = [t.clone() for t in (k_pool, v_pool, k_sc, v_sc) if t is not None]
    stage_t = [_t(s).to(torch.bfloat16) for s in stage]
    flush_staging_paged(k_pool, v_pool, k_sc, v_sc, *stage_t, _t(base), _t(table), page)
    stale, live = int(table[1, 0]), int(table[1, 1])
    after = [t for t in (k_pool, v_pool, k_sc, v_sc) if t is not None]
    for b4, t in zip(before, after):
        assert torch.equal(t[:, stale], b4[:, stale])
        changed = (t != b4).reshape(t.shape[0], t.shape[1], -1).any(-1).any(0)
        assert changed.nonzero().flatten().tolist() == [live]
    if kind == "f32":  # rows 72..103 of the live page are the staged rows
        assert torch.equal(k_pool[:, live, :, 72:104], stage_t[0][1].float())


# ---- write_kv_token ------------------------------------------------------


@pytest.mark.parametrize("case", ["f32", "int8", "scale"])
def test_write_kv_token_matches_jax(case):
    """The shapes of tests/test_kv_write.py, and an f32 scale cache with a
    trailing 1: bit-exact."""
    rng = np.random.default_rng(2)
    if case == "int8":
        B, KH, S, D = 2, 4, 96, 64
        cache = rng.integers(-127, 128, (B, KH, S, D)).astype(np.int8)
        new = rng.integers(-127, 128, (B, KH, 1, D)).astype(np.int8)
        pos = np.array([5, 95], np.int32)
    else:
        B, KH, S, D = 3, 2, 64, (32 if case == "f32" else 1)
        cache = rng.standard_normal((B, KH, S, D)).astype(np.float32)
        new = rng.standard_normal((B, KH, 1, D)).astype(np.float32)
        pos = np.array([0, 17, 63], np.int32)
    want = np.asarray(j_write_kv_token(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos)))
    got = _t(cache.copy())
    assert write_kv_token(got, _t(new), _t(pos)) is got
    np.testing.assert_array_equal(got.numpy(), want)


# ---- PagedKVCache (tests/test_paged.py:32-80) ----------------------------


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_cache_matches_jax_and_naive(quantized):
    """The same tokens appended to the port's and the JAX cache give the
    same pages and pools bit for bit; decode through the port's table
    matches plain attention over the dense sequences."""
    KH, E, page = 2, 64, 64
    seqs = {0: 70, 1: 37, 2: 130}  # 2, 1 and 3 pages
    cache = PagedKVCache.create(32, KH, page, E, dtype=torch.float32, quantized=quantized)
    jcache = JPagedKVCache.create(32, KH, page, E, dtype=jnp.float32, quantized=quantized)
    rng = np.random.default_rng(3)
    dense = {}
    for sid, n in seqs.items():
        cache.alloc_seq(sid)
        jcache.alloc_seq(sid)
        toks = rng.standard_normal((2, n, KH, E)).astype(np.float32)
        for t in range(n):
            cache.append_token(sid, _t(toks[0, t]), _t(toks[1, t]))
            jcache.append_token(sid, jnp.asarray(toks[0, t]), jnp.asarray(toks[1, t]))
        dense[sid] = toks
    assert cache.tables == jcache.tables and cache.lengths == jcache.lengths
    for mine, theirs in ((cache.pool_k, jcache.pool_k), (cache.pool_v, jcache.pool_v),
                         (cache.pool_k_scale, jcache.pool_k_scale),
                         (cache.pool_v_scale, jcache.pool_v_scale)):
        if mine is not None:
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))

    q = _t(rng.standard_normal((len(seqs), 8, 1, E)).astype(np.float32))
    table, lens = cache.batch_views(list(seqs), max_pages=4)
    assert table.dtype == lens.dtype == torch.int32
    got = paged_decode_attention(q, cache.pool_k, cache.pool_v, table, lens,
                                 cache.pool_k_scale, cache.pool_v_scale)
    atol = 2e-2 if quantized else 1e-5
    for i, sid in enumerate(seqs):
        kd, vd = (_t(x).transpose(0, 1)[None] for x in dense[sid])  # (1, KH, n, E)
        want = naive_attention(q[i:i + 1], kd, vd)
        torch.testing.assert_close(got[i:i + 1], want, atol=atol, rtol=atol)


def test_paged_cache_allocator_reuse():
    cache = PagedKVCache.create(4, 1, 8, 16, dtype=torch.float32)
    cache.alloc_seq(0)
    for _ in range(20):
        cache.append_token(0, torch.zeros(1, 16), torch.zeros(1, 16))
    assert len(cache.tables[0]) == 3 and len(cache.free) == 1  # ceil(20 / 8)
    cache.free_seq(0)
    assert len(cache.free) == 4
    cache.alloc_seq(1)
    with pytest.raises(MemoryError):
        for _ in range(40):
            cache.append_token(1, torch.zeros(1, 16), torch.zeros(1, 16))


# ---- the engine ------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jp = j_init_params(jax.random.key(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 250, n).tolist()


PROMPT = [5, 17, 42, 7, 99, 3, 12, 8]
BASE = _prompt(5, 160)
ENGINE_CASES = {
    "f32_pool": ([[PROMPT]], dict(max_batch=2, max_seq=64)),
    "int8_pool": ([[PROMPT]], dict(max_batch=2, max_seq=64, quantized_kv=True)),
    # the second request shares a 128-token page with the first
    "prefix_hit": ([[BASE + [7, 8, 9]], [BASE + [20, 21]]],
                   dict(max_batch=2, max_seq=512, prefix_cache=True, prefill_chunk=64)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_paged_greedy_streams_match_jax_engine(params, case):
    waves, kw = ENGINE_CASES[case]

    def run(engine_cls, p):
        eng = engine_cls(p, JCFG if engine_cls is JEngine else CFG, paged=True,
                         page_size=128, **kw)
        outs = []
        for wave in waves:  # each wave runs to the end before the next
            reqs = [eng.submit(pr, max_new_tokens=6) for pr in wave]
            eng.run()
            assert all(r.done for r in reqs)
            outs += [r.out for r in reqs]
        return outs, eng.prefix_hits

    want, want_hits = run(JEngine, params[0])
    got, got_hits = run(Engine, params[1])
    assert got == want and all(len(o) == 6 for o in got)
    assert got_hits == want_hits == (128 if case == "prefix_hit" else 0)


def _paged_engine(p, **kw):
    return Engine(p, CFG, max_batch=2, max_seq=512, paged=True, page_size=128,
                  prefix_cache=True, prefill_chunk=64, **kw)


def test_prefix_cache_concurrent_sharing_and_release(params):
    """Two live requests share the prefix pages; when both finish only
    their own pages come back, and the cached pages keep one ref each."""
    base = _prompt(6, 160)
    eng = _paged_engine(params[1])
    eng.submit(base + [3, 4, 5], max_new_tokens=3)
    eng.run()
    cached = list(eng._prefix_cache.values())[0]
    free_before = len(eng._free_pages)
    r2 = eng.submit(base + [9, 9], max_new_tokens=3)
    r3 = eng.submit(base + [1], max_new_tokens=3)
    eng.run()
    assert r2.done and r3.done and eng.prefix_hits == 256
    assert not set(cached) & set(eng._free_pages)
    assert len(eng._free_pages) == free_before
    assert all(eng._page_refs[pid] == 1 for pid in cached)


def test_prefix_cache_stress_mixed_load(params):
    """12 requests through 3 slots and a tight 24-page pool, two shared
    prefixes: EVERY request's stream equals its run alone in the
    contiguous engine."""
    bases = (_prompt(7, 160), _prompt(8, 160))
    prompts = [bases[i % 2] + [(3 * i + 1) % 250 + 1, (7 * i) % 250 + 1] for i in range(12)]
    alone = Engine(params[1], CFG, max_batch=1, max_seq=512, prefill_chunk=64)
    want = [alone.submit(p, max_new_tokens=4) for p in prompts]
    alone.run()
    eng = Engine(params[1], CFG, max_batch=3, max_seq=512, paged=True, page_size=128,
                 prefix_cache=True, prefill_chunk=64, n_pages=24)
    reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
    eng.run()
    assert [r.out for r in reqs] == [w.out for w in want]
    assert eng.prefix_hits >= 128 * 8
    held = {p for ps in eng._prefix_cache.values() for p in ps}
    assert len(eng._free_pages) + len(held) == 24


def test_immediate_retire_releases_pages(params):
    """A request that retires at admission gives its pages back; only the
    published prefix keeps refs, one per page."""
    eng = _paged_engine(params[1])
    free0 = len(eng._free_pages)
    r = eng.submit(_prompt(3, 200), max_new_tokens=1)
    eng.run()
    assert r.done and len(r.out) == 1
    assert eng._slot_pages == [[], []]
    held = {p for ps in eng._prefix_cache.values() for p in ps}
    assert held and len(eng._free_pages) == free0 - len(held)
    assert all(eng._page_refs[p] == 1 for p in held)


def test_warmup_leaves_no_pinned_prefix_pages(params):
    eng = _paged_engine(params[1])
    eng.warmup(prompt_lengths=(200,))
    assert eng._prefix_cache == {}
    assert len(eng._free_pages) == eng.n_pages
    assert all(v <= 0 for v in eng._page_refs.values())
    assert int(eng.state.lengths.abs().sum()) == 0 and eng._host_lens == [0, 0]


def test_paged_continuous_batching_reuses_pages(params):
    """tests/test_engine.py:127-138: pages of finished requests serve later
    ones in a deliberately tight pool."""
    eng = Engine(params[1], CFG, max_batch=2, max_seq=64, paged=True, page_size=128, n_pages=6)
    reqs = [eng.submit(p, max_new_tokens=5) for p in ([1, 2, 3], [10, 20, 30, 40], [7] * 5,
                                                      [9] * 6)]
    eng.run()
    assert all(r.done and len(r.out) == 5 for r in reqs)
    assert len(eng._free_pages) == 6


def test_paged_sliding_window_matches_forward():
    """tests/test_engine.py:177-198, the paged case: decode with a sliding
    window of 12 follows the windowed full-forward greedy chain."""
    jcfg = JLlamaConfig.tiny(dtype=jnp.float32, sliding_window=12)
    cfg = LlamaConfig.tiny(dtype=torch.float32, sliding_window=12)
    p = params_from_numpy(jax.tree.map(np.asarray, j_init_params(jax.random.key(3), jcfg)))
    toks, want = list(PROMPT), []
    for _ in range(10):
        nxt = int(forward(p, torch.tensor([toks]), cfg)[0, -1].argmax())
        want.append(nxt)
        toks.append(nxt)
    eng = Engine(p, cfg, max_batch=2, max_seq=64, paged=True, page_size=128)
    req = eng.submit(PROMPT, max_new_tokens=10)
    eng.run()
    assert req.done and req.out == want


def test_idle_slot_flush_regression(params):
    """One request in 2 slots, pages of 256 and a pool of 2: the request's
    second page is page 0, which the idle slot's zero table row names. A
    flush that wrote the idle slot (as the TPU flush does) would overwrite
    that page; the paged stream must equal the contiguous one."""
    p = params[1]
    paged = Engine(p, CFG, max_batch=2, max_seq=304, paged=True, page_size=256, n_pages=2)
    r = paged.submit(PROMPT, max_new_tokens=290)
    paged.run()
    assert paged._free_pages == [1, 0]  # both pages were the request's
    linear = Engine(p, CFG, max_batch=2, max_seq=304)
    want = linear.submit(PROMPT, max_new_tokens=290)
    linear.run()
    assert r.done and len(r.out) == 290 and r.out == want.out
