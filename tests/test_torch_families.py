"""The model families on the port (Mistral's sliding window, Gemma's
offset norms, GeGLU and embedding scale, Gemma-2's alternating window,
softcaps and post norms, Qwen2's q/k/v biases) against the JAX package on
the CPU, with the same numpy inputs through both.

Ops within 5e-5 (f32 sums in another order): the windowed and softcapped
flash attention (several windows, GQA with ragged rows, kpad, chunked
prefill from an offset, a window >= KL as plain causal) against the JAX
kernels in interpret mode, and the decode attention (linear with staged
rows, paged) with the window and the softcap. Models: tiny `forward`
within 1e-4 of the JAX `forward`. Engine: greedy streams of a tiny
Gemma-2 and a tiny Mistral IDENTICAL to the JAX engine's, with a prompt
admitted in chunks and a generation past the window."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnop_tpu.models.llama import LlamaConfig as JLlamaConfig
from nnop_tpu.models.llama import forward as j_forward
from nnop_tpu.models.llama import init_params as j_init_params
from nnop_tpu.ops.attention_decode import decode_attention as j_decode_attention
from nnop_tpu.ops.attention_decode_paged import paged_decode_attention as j_paged_decode
from nnop_tpu.ops.flash_attention import flash_attention as j_flash_attention
from nnop_tpu.ops.flash_attention import flash_attention_chunked as j_flash_chunked
from nnop_tpu.runtime.engine import Engine as JEngine
from nnop_tpu_torch.models.llama import LlamaConfig, forward
from nnop_tpu_torch.models.weights import params_from_numpy
from nnop_tpu_torch.ops.attention_decode import decode_attention
from nnop_tpu_torch.ops.attention_decode_paged import paged_decode_attention
from nnop_tpu_torch.ops.flash_attention import flash_attention, flash_attention_chunked
from nnop_tpu_torch.runtime.engine import Engine

ATOL_OPS = 5e-5
ATOL_MODEL = 1e-4


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
    return torch.from_numpy(np.array(x))


def _qkv(seed, B, QH, KH, QL, KL, E):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, QH, QL, E)).astype(np.float32),
            rng.standard_normal((B, KH, KL, E)).astype(np.float32),
            rng.standard_normal((B, KH, KL, E)).astype(np.float32))


# ---- flash attention: the window and the softcap -------------------------

ATTN_CASES = {
    # name: ((B, QH, KH, QL, KL, E), window, softcap, kpad lengths or None)
    "window1": ((2, 2, 2, 96, 96, 32), 1, None, None),
    "window17_gqa_ragged": ((1, 4, 2, 75, 75, 32), 17, None, None),
    "window33_kpad": ((2, 2, 2, 128, 128, 32), 33, None, (100, 128)),
    "softcap5": ((1, 4, 2, 80, 80, 32), None, 5.0, None),
    "window17_softcap5_kpad": ((2, 4, 1, 70, 70, 64), 17, 5.0, (60, 70)),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_window_softcap_matches_jax(case):
    shape, window, softcap, kpad_lens = ATTN_CASES[case]
    q, k, v = _qkv(1, *shape)
    kw = dict(causal=True, window=window, softcap=softcap)
    kpad = None
    if kpad_lens is not None:
        kpad = np.arange(shape[4])[None, :] < np.array(kpad_lens)[:, None]
    want = jax.jit(lambda a, b, c, m: j_flash_attention(a, b, c, kpad_mask=m, **kw))(
        q, k, v, kpad)
    got = flash_attention(_t(q), _t(k), _t(v), kpad_mask=None if kpad is None else _t(kpad),
                          **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_OPS, rtol=0)


@pytest.mark.parametrize("window", [90, 1000])
def test_flash_attention_window_ge_kl_is_causal(window):
    """A window that never binds (>= KL) is dropped: plain causal, exactly."""
    q, k, v = (_t(a) for a in _qkv(1, 1, 2, 2, 90, 90, 32))
    torch.testing.assert_close(flash_attention(q, k, v, causal=True, window=window),
                               flash_attention(q, k, v, causal=True), atol=0, rtol=0)


@pytest.mark.parametrize("window,softcap", [(8, None), (33, 5.0)],
                         ids=["window8", "window33_softcap"])
def test_flash_attention_chunked_window_matches_jax(window, softcap):
    """A chunk of rows from offset 96 over a 160-key buffer whose last 32
    keys are padding (the engine's chunked prefill)."""
    q, k, v = _qkv(2, 1, 4, 2, 160, 160, 32)
    off, C = 96, 32
    valid = np.arange(160)[None] < off + C
    kw = dict(causal_offset=off, window=window, softcap=softcap)
    want = jax.jit(lambda a, b, c, m: j_flash_chunked(a, b, c, kpad_mask=m, **kw))(
        q[:, :, off:off + C], k, v, valid)
    got = flash_attention_chunked(_t(q[:, :, off:off + C]), _t(k), _t(v), kpad_mask=_t(valid),
                                  **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_OPS, rtol=0)


def test_flash_attention_grad_with_window_or_softcap_raises():
    """Under grad the window and the softcap no longer raise (the name is
    from when they did): dq, dk, dv with both, at head dim 256 and a
    softcap that binds (q x 8), against jax.vjp of the JAX op. L 128: the
    JAX backward with a softcap gives NaN gradients at a length that is
    not a multiple of its key block."""
    q, k, v = _qkv(4, 1, 2, 1, 128, 128, 256)
    q = 8 * q
    do = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=True, window=4, softcap=5.0)
    want = jax.jit(lambda q, k, v, do: jax.vjp(
        lambda a, b, c: j_flash_attention(a, b, c, **kw), q, k, v)[1](do))(q, k, v, do)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves, **kw), leaves, _t(do))
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_OPS, rtol=0,
                                   err_msg=f"d{name}")


# ---- decode attention: the window and the softcap ------------------------


@pytest.mark.parametrize("window,softcap", [(5, None), (33, 5.0)],
                         ids=["window5_in_staging", "window33_softcap"])
def test_decode_window_softcap_matches_jax(window, softcap):
    """Linear stacked caches with staged rows; the query sits after the
    staged rows, so window 5 < staged_n 7 reaches only into them."""
    rng = np.random.default_rng(3)
    B, QH, KH, S, E, nl, W = 4, 8, 2, 96, 32, 2, 8
    lengths = np.array([0, 1, 40, 90], np.int32)
    q = rng.standard_normal((B, QH, 1, E)).astype(np.float32)
    kc, vc = (rng.standard_normal((nl, B, KH, S, E)).astype(np.float32) for _ in range(2))
    ks, vs = (rng.standard_normal((B, nl, KH, W, E)).astype(np.float32) for _ in range(2))
    kw = dict(staged_n=7, layer=1, scale=0.2, window=window, softcap=softcap)
    bf = jnp.bfloat16
    want = j_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(lengths), k_stage=jnp.asarray(ks, bf),
                              v_stage=jnp.asarray(vs, bf), **kw)
    got = decode_attention(_t(q), _t(kc), _t(vc), _t(lengths),
                           k_stage=_t(ks).to(torch.bfloat16), v_stage=_t(vs).to(torch.bfloat16),
                           **kw)
    assert (got[0] == 0).all()  # the empty slot
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_OPS, rtol=0)


@pytest.mark.parametrize("window", [5, 33])
def test_paged_decode_window_softcap_matches_jax(window):
    """Pools of 32-token pages through a shuffled table, softcap 5."""
    rng = np.random.default_rng(4)
    B, QH, KH, E, page, n_pages, max_pages, nl, W = 3, 4, 1, 64, 32, 12, 4, 2, 8
    lengths = np.array([1, 45, 100], np.int32)
    table = rng.permutation(n_pages)[: B * max_pages].astype(np.int32).reshape(B, max_pages)
    pk, pv = (rng.standard_normal((nl, n_pages, KH, page, E)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((B, QH, 1, E)).astype(np.float32)
    ks, vs = (rng.standard_normal((B, nl, KH, W, E)).astype(np.float32) for _ in range(2))
    kw = dict(staged_n=6, layer=0, window=window, softcap=5.0)
    bf = jnp.bfloat16
    want = j_paged_decode(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
                          jnp.asarray(lengths), k_stage=jnp.asarray(ks, bf),
                          v_stage=jnp.asarray(vs, bf), **kw)
    got = paged_decode_attention(_t(q), _t(pk), _t(pv), _t(table), _t(lengths),
                                 k_stage=_t(ks).to(torch.bfloat16),
                                 v_stage=_t(vs).to(torch.bfloat16), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_OPS, rtol=0)


# ---- the families' forward and engine ------------------------------------

FAMILIES = {
    "mistral": dict(sliding_window=8),
    "gemma": dict(rms_offset=1.0, act="gelu", tie_embeddings=True, embed_scale=128.0**0.5),
    "gemma2": dict(rms_offset=1.0, act="gelu", tie_embeddings=True, embed_scale=128.0**0.5,
                   post_norms=True, attn_softcap=20.0, final_softcap=15.0, sliding_window=8,
                   window_pattern=2),
    "qwen2": dict(qkv_bias=True),
}


def _family_params(family, seed=0):
    """The JAX tree of a tiny family config with nonzero norm weights and
    (Qwen2) biases, as numpy, and the same tree for the port."""
    jcfg = JLlamaConfig.tiny(dtype=jnp.float32, **FAMILIES[family])
    jp = jax.tree.map(np.array, j_init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    for layer in jp["layers"]:
        for name, a in layer.items():
            if name.startswith("b") or name.endswith("norm"):
                layer[name] = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return jcfg, jp, params_from_numpy(jp)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_forward_matches_jax(family):
    jcfg, jp, tp = _family_params(family)
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    want = jax.jit(j_forward, static_argnums=2)(jp, jnp.asarray(tokens), jcfg)
    cfg = LlamaConfig.tiny(dtype=torch.float32, **FAMILIES[family])
    got = forward(tp, torch.from_numpy(tokens).long(), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_MODEL, rtol=0)


@pytest.mark.parametrize("family", ["gemma2", "mistral"])
def test_family_engine_streams_match_jax(family):
    """Chunked admission (prompts of 75 and 40 tokens in chunks of 32) and
    decoding far past the window of 8: the greedy streams equal the JAX
    engine's token for token."""
    jcfg, jp, tp = _family_params(family, seed=1)
    cfg = LlamaConfig.tiny(dtype=torch.float32, **FAMILIES[family])
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (75, 40)]
    kw = dict(max_batch=2, max_seq=128, prefill_chunk=32, chunk_size=4)
    streams = []
    for eng in (JEngine(jp, jcfg, **kw), Engine(tp, cfg, **kw)):
        reqs = [eng.submit(p, max_new_tokens=14) for p in prompts]
        eng.run()
        streams.append([r.out for r in reqs])
    assert all(len(s) == 14 for s in streams[1])
    assert streams[1] == streams[0]
