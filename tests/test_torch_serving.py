"""The port's serving front end and engine host controls on the CPU
(tiny float32 config): EngineServer returns the engine's greedy tokens,
EOS/stops/cancel/backpressure/warmup behave as the JAX engine's do, the
scheduling options never change greedy streams, sampling is tested by
behaviour (jax.random cannot be matched), and importing the port leaves
JAX out."""

import json
import os
import subprocess
import sys
import urllib.request

import pytest
import torch

from nnop_tpu_torch.cli import main
from nnop_tpu_torch.models.llama import LlamaConfig, init_params
from nnop_tpu_torch.runtime.engine import Engine, QueueFullError, sample_tokens
from nnop_tpu_torch.runtime.server import EngineServer
from nnop_tpu_torch.runtime.tokenizer import BPETokenizer

CFG = LlamaConfig.tiny(dtype=torch.float32)
LONG = [(7 * i + 3) % 256 for i in range(40)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and a default thread pool per worker oversubscribes the
    cores (tens of times slower on these tiny tensors under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    gen = torch.Generator()
    gen.manual_seed(0)
    return init_params(gen, CFG)


def _streams(p, prompts, max_new, **kw):
    eng = Engine(p, CFG, **kw)
    reqs = [eng.submit(pr, max_new_tokens=max_new) for pr in prompts]
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def test_server_completion(params):
    """Token ids and a text prompt (submit_text, raw-byte tokenizer)
    through the port's EngineServer return the engine's greedy tokens."""
    prompt = [9, 1, 3, 8, 2]
    want = _streams(params, [prompt, list(b"hi")], 6, max_batch=2, max_seq=64)
    eng = Engine(params, CFG, max_batch=2, max_seq=64, tokenizer=BPETokenizer([]))

    def post(port, payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            return json.loads(r.read())

    with EngineServer(eng) as srv:
        assert post(srv.port, {"prompt": prompt, "max_tokens": 6})["tokens"] == want[0]
        out = post(srv.port, {"prompt": "hi", "max_tokens": 6})
        assert out["tokens"] == want[1] and out["text"] == eng.tokenizer.decode(want[1])
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/v1/stats", timeout=30) as r:
            stats = json.loads(r.read())
    assert stats["requests_completed"] == 2 and stats["tokens_generated"] == 12


def test_scheduling_options_keep_greedy_streams(params):
    """pipeline_depth, chunk_size and prefill_chunks_per_step change when
    tokens are collected and prompts admitted, never which tokens."""
    prompts = [[5, 17, 42], LONG, [9] * 6]
    kw = dict(max_batch=2, max_seq=96, prefill_chunk=16)
    base = _streams(params, prompts, 7, **kw)
    for opt in (dict(pipeline_depth=1), dict(pipeline_depth=3, chunk_size=3),
                dict(prefill_chunks_per_step=1)):
        assert _streams(params, prompts, 7, **kw, **opt) == base, opt


def test_eos_and_stop_sequences(params):
    prompt = [5, 17, 42, 7, 99, 3]
    base = _streams(params, [prompt], 8, max_batch=1, max_seq=64)[0]
    eos = base[2]
    eng = Engine(params, CFG, max_batch=1, max_seq=64, eos_id=eos)
    r = eng.submit(prompt, max_new_tokens=8)
    eng.run()
    assert r.done and r.out == base[: base.index(eos) + 1]  # EOS kept, then stop
    eng = Engine(params, CFG, max_batch=1, max_seq=64)
    r = eng.submit(prompt, max_new_tokens=8, stop=[base[3:5]])
    eng.run()
    assert r.done and r.out == base[:3]  # the matched stop tokens are stripped


def test_cancel_backpressure_and_warmup(params):
    eng = Engine(params, CFG, max_batch=1, max_seq=64, max_queue=2)
    a = eng.submit([1, 2, 3], max_new_tokens=20)
    b = eng.submit([4, 5, 6], max_new_tokens=6)
    with pytest.raises(ValueError):  # invalid beats full: a 400, not a 429
        eng.submit([1] * 60, max_new_tokens=8)
    with pytest.raises(QueueFullError):
        eng.submit([7], max_new_tokens=4)
    assert eng.cancel(b.rid) and b.done and b.cancelled and not eng.cancel(b)
    eng.step()  # admits `a` and dispatches its first chunk
    assert eng.slots[0] is a and eng.cancel(a)
    assert eng.slots[0] is None and int(eng.state.lengths[0]) == 0
    eng.run()
    assert a.cancelled and len(a.out) < 20
    # warmup leaves no trace: serving afterwards matches a fresh engine
    fresh = _streams(params, [[5, 17, 42]], 6, max_batch=1, max_seq=64)[0]
    eng = Engine(params, CFG, max_batch=1, max_seq=64).warmup((20,))
    r = eng.submit([5, 17, 42], max_new_tokens=6)
    eng.run()
    assert r.out == fresh


def test_sampling_behaviour(params):
    """Temperature sampling: reproducible per seed, different across seeds,
    greedy at top_k=1."""
    prompt = [5, 17, 42, 7]

    def sample(seed, top_k):
        eng = Engine(params, CFG, max_batch=1, max_seq=64, temperature=1.0,
                     top_k=top_k, seed=seed)
        r = eng.submit(prompt, max_new_tokens=12)
        eng.run()
        assert r.done and len(r.out) == 12
        return r.out

    assert sample(0, 1) == _streams(params, [prompt], 12, max_batch=1, max_seq=64)[0]
    a, b, c = sample(0, 8), sample(0, 8), sample(1, 8)
    assert a == b, "same seed, same stream"
    assert a != c, "different seeds should sample differently"


def test_sample_tokens_filters():
    """top_k / top_p / min_p never let a filtered-out token through."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    gen = torch.Generator()
    gen.manual_seed(0)
    for kw, allowed in ((dict(top_k=2), {0, 1}), (dict(top_p=0.7), {0, 1}),
                        (dict(min_p=0.4), {0, 1}), (dict(min_p=0.9), {0})):
        seen = {int(sample_tokens(logits, gen, temperature=1.0, **kw)[0]) for _ in range(64)}
        assert seen <= allowed, (kw, seen)
    assert int(sample_tokens(logits, None)[0]) == 0  # temperature 0: argmax


@pytest.mark.parametrize("option,refused_with", [(dict(spec_k=2), dict(paged=True)),
                                                  (dict(logprobs=True), dict(spec_k=2))],
                         ids=["spec_k", "logprobs"])
def test_unported_engine_options_raise(params, option, refused_with):
    """spec_k and logprobs are ported (tests/test_torch_spec.py); what the
    JAX engine refuses with them, spec decoding over paged pools or with
    logprobs, raises ValueError."""
    assert Engine(params, CFG, max_batch=1, max_seq=64, **option).spec_k == option.get("spec_k", 0)
    with pytest.raises(ValueError, match="not supported"):
        Engine(params, CFG, max_batch=1, max_seq=64, **option, **refused_with)


def test_prefix_cache_needs_paged(params):
    with pytest.raises(ValueError, match="requires paged=True"):
        Engine(params, CFG, max_batch=1, max_seq=64, prefix_cache=True)


def test_cli_generate(capsys):
    """`generate` on the tiny config on the CPU prints each request's
    tokens, with float weights, int8 weights and the int8 KV cache, and
    int4 weights."""
    for flags in ([], ["--wbits", "8", "--int8-kv"], ["--wbits", "4"]):
        main(["generate", "--model", "tiny", "--device", "cpu", "--prompt", "abc", "hi",
              "--max-new", "5", "--batch", "2", *flags])
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("[0] [") and out[1].startswith("[1] ["), flags
        assert all(len(json.loads(line.split(" ", 1)[1])) == 5 for line in out[:2]), flags
        assert "10 tokens in" in out[2], flags


def test_cli_profile(capsys):
    """`profile` runs decode steps with every slot live and reports the
    step time (on the CPU: no device time)."""
    main(["profile", "--model", "tiny", "--device", "cpu", "--wbits", "8", "--int8-kv",
          "--batch", "2", "--prompt-len", "12", "--steps", "1"])
    out = capsys.readouterr().out
    assert "1 steps x 8 tokens x 2 slots" in out and "ms per step" in out


def test_import_leaves_jax_out():
    # every module of the package, found by walking it
    code = (
        "import importlib, pkgutil, sys, nnop_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(nnop_tpu_torch.__path__, 'nnop_tpu_torch.')]\n"
        "assert 'nnop_tpu_torch.ops.flash_attention_bwd' in names, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'nnop_tpu', 'triton'))\n"
        "assert not bad, bad"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
