"""Speculative decoding and per-token logprobs in the port's engine on the
CPU (tiny float32 config, the same weights as the JAX package's):
greedy Engine(spec_k=2|4) streams and acceptance counters IDENTICAL to
the JAX Engine's; spec decoding equal to plain decoding over the int8 KV
cache and on tiny_moe; Engine(logprobs=True) within 1e-4 of the JAX
engine's logprobs (log_softmax of f32 logits reached through two stacks
of f32 ops in another order), one per token and trimmed with the tokens
by a stop string; the server's "logprobs" field; the refusals; warmup;
the counters' metering; and a sampled spec run (jax.random cannot be
matched, so sampling is tested by behaviour). On the CPU decode
attention runs its plain version; the kernel's verify mode is held to it
on the card (tests/test_torch_kernels.py, chip_smoke.py phase 3)."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnop_tpu.models.llama import LlamaConfig as JLlamaConfig
from nnop_tpu.models.llama import init_params as j_init_params
from nnop_tpu.runtime.engine import Engine as JEngine
from nnop_tpu_torch.models.llama import LlamaConfig, forward, init_params
from nnop_tpu_torch.models.weights import params_from_numpy
from nnop_tpu_torch.runtime.engine import STAGE_W, Engine, make_spec_chunk
from nnop_tpu_torch.runtime.server import EngineServer

JCFG = JLlamaConfig.tiny(dtype=jnp.float32)
CFG = LlamaConfig.tiny(dtype=torch.float32)
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [10, 20, 30, 40, 50], [7] * 6]
SPEC_KW = dict(max_batch=2, max_seq=96, chunk_size=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and a default thread pool per worker oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = j_init_params(jax.random.key(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


class _EchoTok:
    """Tokenizer stub: token i decodes to "<i>" (concatenative bytes)."""

    def decode(self, ids):
        return "".join(f"<{i}>" for i in ids)

    def decode_bytes(self, ids):
        return self.decode(ids).encode("utf-8")


def _run(eng, prompts, max_new, **kw):
    reqs = [eng.submit(p, max_new_tokens=max_new, **kw) for p in prompts]
    eng.run()
    assert all(r.done for r in reqs)
    return reqs


@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_streams_match_jax_engine(params, spec_k):
    """The JAX engine's own spec test (tests/test_engine.py:257) on both
    engines: the streams, equal to plain greedy decoding's, and the
    measured tokens per verify step."""
    want_eng = JEngine(params[0], JCFG, spec_k=spec_k, **SPEC_KW)
    want = _run(want_eng, PROMPTS, 12)
    eng = Engine(params[1], CFG, spec_k=spec_k, **SPEC_KW)
    got = _run(eng, PROMPTS, 12)
    plain = _run(Engine(params[1], CFG, **SPEC_KW), PROMPTS, 12)
    assert [r.out for r in got] == [r.out for r in want] == [r.out for r in plain]
    assert (eng.spec_emitted, eng.spec_verify_slots) == (
        want_eng.spec_emitted, want_eng.spec_verify_slots)
    assert eng.spec_emitted > eng.spec_verify_slots  # the repeated prompt's drafts land


def test_spec_matches_plain_over_int8_kv(params):
    """tests/test_engine.py:277 on the port: the verify over the int8 cache."""
    prompts = [[5, 6, 5, 6, 5, 6], [9, 8, 7]]
    kw = dict(max_batch=2, max_seq=96, chunk_size=3, quantized_kv=True)
    plain = _run(Engine(params[1], CFG, **kw), prompts, 10)
    spec = _run(Engine(params[1], CFG, spec_k=3, **kw), prompts, 10)
    assert [r.out for r in spec] == [r.out for r in plain]


def test_spec_matches_plain_on_moe():
    """tests/test_moe.py:383 on the port: the verify forward runs the
    grouped expert MLP at T > 1 rows a slot."""
    cfg = LlamaConfig.tiny_moe(dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    p = init_params(gen, cfg)
    prompt = [5, 17, 42, 7, 5, 17, 42, 7]
    plain = _run(Engine(p, cfg, **SPEC_KW), [prompt], 10)
    spec = _run(Engine(p, cfg, spec_k=2, **SPEC_KW), [prompt], 10)
    assert spec[0].out == plain[0].out and len(spec[0].out) == 10


def test_logprobs_match_jax_engine(params):
    """One logprob per token, against the JAX engine's, and a stop string
    that trims the tokens and their logprobs alike."""
    prompt, kw = [5, 17, 42, 7, 99, 3], dict(max_batch=2, max_seq=64, chunk_size=4)
    want_eng = JEngine(params[0], JCFG, logprobs=True, tokenizer=_EchoTok(), **kw)
    want = _run(want_eng, [prompt], 9)[0]
    eng = Engine(params[1], CFG, logprobs=True, tokenizer=_EchoTok(), **kw)
    got = _run(eng, [prompt], 9)[0]
    assert got.out == want.out and len(got.logprobs) == len(got.out) == 9
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4, rtol=0)
    assert all(lp <= 0.0 for lp in got.logprobs)
    # stop on the 5th token's text: 4 tokens and 4 logprobs stay, on both
    stop = [f"<{got.out[4]}>"]
    want_s = _run(want_eng, [prompt], 9, stop_texts=stop)[0]
    got_s = _run(eng, [prompt], 9, stop_texts=stop)[0]
    assert got_s.out == want_s.out == got.out[:4]
    assert len(got_s.logprobs) == len(want_s.logprobs) == 4
    np.testing.assert_allclose(got_s.logprobs, want_s.logprobs, atol=1e-4, rtol=0)


def test_server_logprobs_field(params):
    """The answer carries "logprobs" (one per token) when the engine has
    logprobs=True, and no such field otherwise."""
    prompt = [9, 1, 3, 8, 2]

    def post(eng):
        with EngineServer(eng) as srv:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/completions",
                data=json.dumps({"prompt": prompt, "max_tokens": 6}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

    kw = dict(max_batch=2, max_seq=64)
    want = _run(Engine(params[1], CFG, logprobs=True, **kw), [prompt], 6)[0]
    out = post(Engine(params[1], CFG, logprobs=True, **kw))
    assert out["tokens"] == want.out and len(out["logprobs"]) == 6
    np.testing.assert_allclose(out["logprobs"], want.logprobs, atol=1e-6, rtol=0)
    assert "logprobs" not in post(Engine(params[1], CFG, **kw))


def test_spec_chunk_logits_match_forward(params):
    """make_spec_chunk(with_logits=True) on admitted slots: each slot's
    verify logits (T rows) against the port's forward (held to the JAX
    one by tests/test_torch_model.py) over the prompt and the T input
    tokens [last, drafts], per row at cosine >= 0.99999 with the same
    argmax: the T rows' K/V sit in the bf16 staging, as in the JAX
    engine, so their attention rounds K and V by up to 2^-9 where the
    f32 forward does not (a relative error ~1e-3, cosine ~1 - 1e-6);
    each row against its neighbour's reads below 0.9999 (the tiny
    model's rows share a common direction: ~0.993). The emitted tokens
    are the argmax of their rows (greedy: the accepted drafts, then the
    row after them)."""
    spec_k, T = 2, 3
    eng = Engine(params[1], CFG, spec_k=spec_k, **SPEC_KW)
    for p in PROMPTS[:2]:
        eng.submit(p, max_new_tokens=8)
    while eng.queue or eng._admitting:
        eng._admit()
    lens = eng.state.lengths.tolist()
    chunk = make_spec_chunk(CFG, 1, spec_k, with_logits=True)
    emitted, counts, logits = chunk(eng.params, eng.state, eng._history, eng._gen)
    assert logits.shape == (1, 2, T, CFG.vocab_size) and logits.dtype == torch.float32
    for b, prompt in enumerate(PROMPTS[:2]):
        L, n = lens[b], int(counts[0, b])
        assert torch.equal(emitted[0, b, :n], logits[0, b, :n].argmax(-1))
        toks = prompt + eng._history[b, L:L + T].tolist()
        with torch.no_grad():
            want = forward(params[1], torch.tensor([toks]), CFG)[0, L:].double().numpy()
        got = logits[0, b].double().numpy()
        cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
        off = (got[1:] * want[:-1]).sum(1) / np.linalg.norm(got[1:], axis=1) / np.linalg.norm(
            want[:-1], axis=1)
        assert cos.min() >= 0.99999 and off.max() < 0.9999, (cos, off)
        assert (got.argmax(1) == want.argmax(1)).all()


def test_spec_refusals(params):
    """As in the JAX engine: spec decoding with paged pools or with
    logprobs, or with more drafts than the staging holds, raises."""
    for kw in (dict(spec_k=2, paged=True), dict(spec_k=2, logprobs=True),
               dict(spec_k=STAGE_W)):
        with pytest.raises(ValueError):
            Engine(params[1], CFG, max_batch=1, max_seq=64, **kw)
    assert Engine(params[1], CFG, max_batch=1, max_seq=64, spec_k=STAGE_W - 1).spec_k


def test_warmup_spec_and_quantized(params):
    """tests/test_engine.py:631: warmup (which resets the history and the
    staging) composes with spec decoding and the int8 cache."""
    kw = dict(max_batch=2, max_seq=96, spec_k=2, quantized_kv=True)
    eng = Engine(params[1], CFG, **kw).warmup(prompt_lengths=(8,))
    assert not eng._history.any()
    p = [5, 17, 42, 7, 99, 3]
    assert _run(eng, [p], 8)[0].out == _run(Engine(params[1], CFG, **kw), [p], 8)[0].out


def test_spec_counters_stop_at_finish(params):
    """tests/test_engine.py:685: a request finishing on its first decode
    token meters one verify step, not the rest of the chunk."""
    eng = Engine(params[1], CFG, max_batch=1, max_seq=96, spec_k=2, chunk_size=4)
    r = _run(eng, [[5, 17, 42]], 2)[0]
    assert len(r.out) == 2
    assert eng.spec_verify_slots == 1 and 1 <= eng.spec_emitted <= 1 + eng.spec_k


def test_spec_sampling_runs_to_length(params):
    """A sampled spec run (temperature 0.8, top_p 0.9) yields its full
    length of in-vocabulary tokens, seeded runs repeat, and greedy spec
    still equals plain greedy."""
    prompt = [5, 17, 42, 7, 99, 3, 12, 8]
    kw = dict(max_batch=2, max_seq=96, spec_k=2, temperature=0.8, top_p=0.9, seed=11)
    a = _run(Engine(params[1], CFG, **kw), [prompt], 16)[0].out
    b = _run(Engine(params[1], CFG, **kw), [prompt], 16)[0].out
    assert a == b and len(a) == 16 and all(0 <= t < CFG.vocab_size for t in a)
