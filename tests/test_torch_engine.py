"""The port's engine (nnop_tpu_torch.runtime.engine) against the JAX
package's on the CPU: on the tiny float32 config with the same weights,
greedy token streams must be IDENTICAL to the JAX Engine's — a short
prompt, chunked admission, continuous batching and a stop string. The
server, the host controls and sampling are in test_torch_serving.py."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnop_tpu.models.llama import LlamaConfig as JLlamaConfig
from nnop_tpu.models.llama import init_params as j_init_params
from nnop_tpu.runtime.engine import Engine as JEngine
from nnop_tpu_torch.models.llama import LlamaConfig
from nnop_tpu_torch.models.weights import params_from_numpy
from nnop_tpu_torch.runtime.engine import Engine

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


@pytest.fixture(scope="module")
def jax_engine(params):
    """The JAX Engine for a setting, built once per module and reused by
    the cases that share the setting: its first requests compile its
    programs (seconds each). Every one decodes text with _EchoTok, which
    changes no token of a greedy stream."""
    engines = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in engines:
            engines[key] = JEngine(params[0], JCFG, tokenizer=_EchoTok(), **kw)
        return engines[key]

    return get


def _streams(engine_cls, p, prompts, max_new, stop_texts=None, **kw):
    eng = engine_cls(p, JCFG if engine_cls is JEngine else CFG, **kw)
    return _run(eng, prompts, max_new, stop_texts)


def _run(eng, prompts, max_new, stop_texts=None):
    reqs = [eng.submit(pr, max_new_tokens=max_new, stop_texts=stop_texts) for pr in prompts]
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


LONG = [(7 * i + 3) % 256 for i in range(70)]
CASES = {
    "short": ([[5, 17, 42, 7, 99, 3, 12, 8]], 10, dict(max_batch=2, max_seq=64)),
    # 70 tokens > prefill_chunk 32: 3 chunks through the offset-aware kernel
    "chunked": ([LONG], 6, dict(max_batch=1, max_seq=96, prefill_chunk=32)),
    # four prompts through 2 slots: admission interleaves with decode
    "batching": ([[1, 2, 3], [10, 20, 30, 40, 50], [7, 7, 7, 7], [9] * 6], 6,
                 dict(max_batch=2, max_seq=64, chunk_size=4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_streams_match_jax_engine(params, jax_engine, case):
    prompts, max_new, kw = CASES[case]
    want = _run(jax_engine(**kw), prompts, max_new)
    got = _streams(Engine, params[1], prompts, max_new, **kw)
    assert got == want
    assert all(len(o) == max_new for o in got)


def test_stop_string_matches_jax_engine(params, jax_engine):
    prompt = [5, 17, 42]
    kw = dict(max_batch=2, max_seq=64)  # the "short" case's engine
    probe = _streams(Engine, params[1], [prompt], 6, **kw)[0]
    stop = [f"<{probe[2]}>"]  # the 3rd generated token's text
    want = _run(jax_engine(**kw), [prompt], 6, stop_texts=stop)
    got = _streams(Engine, params[1], [prompt], 6, stop_texts=stop, tokenizer=_EchoTok(), **kw)
    assert got == want == [probe[:2]]


def test_interleaved_admission_keeps_streams_alive(params):
    """tests/test_engine.py:373 on the port: while a long prompt admits
    chunk by chunk, the active stream keeps producing tokens, and the
    streams equal those of Engine(interleave_prefill=False), which admits
    the whole prompt in one step."""
    long_prompt = [(3 * i + 1) % CFG.vocab_size for i in range(60)]
    short = [5, 17, 42]
    outs = {}
    for inter in (False, True):
        eng = Engine(params[1], CFG, max_batch=2, max_seq=128, prefill_chunk=16, chunk_size=2,
                     pipeline_depth=1, interleave_prefill=inter, prefill_chunks_per_step=1)
        r1 = eng.submit(short, max_new_tokens=20)
        eng.step()  # admit + first decode chunk for the short stream
        r2 = eng.submit(long_prompt, max_new_tokens=4)
        if inter:
            # 60 tokens / 16 = 4 prefill chunks -> 4 steps to admit; the
            # short stream must gain tokens during them
            before, grew = len(r1.out), 0
            for _ in range(4):
                eng.step()
                if len(r1.out) > before:
                    grew += 1
                    before = len(r1.out)
                assert not r2.done
            assert grew >= 2, "short stream stalled during admission"
        else:
            eng.step()
            assert not eng._admitting and eng.slots[1] is r2  # admitted in one step
        eng.run()
        assert r1.done and r2.done
        outs[inter] = (r1.out, r2.out)
    assert outs[True] == outs[False]


def test_fuse_weights_false_takes_fused_params(params):
    """Engine(fuse_weights=False) on params fused beforehand serves the
    same greedy streams as an engine that fuses them itself."""
    from nnop_tpu_torch.runtime.engine import fuse_decode_weights

    fused = fuse_decode_weights(params[1])
    outs = [_streams(Engine, p, [[5, 17, 42, 7]], 6, max_batch=1, max_seq=64, **kw)
            for p, kw in ((params[1], {}), (fused, dict(fuse_weights=False)))]
    assert outs[0] == outs[1]
    eng = Engine(fused, CFG, max_batch=1, max_seq=64, fuse_weights=False)
    assert eng.params is fused
