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


def _streams(engine_cls, p, prompts, max_new, stop_texts=None, **kw):
    eng = engine_cls(p, JCFG if engine_cls is JEngine else CFG, **kw)
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
def test_greedy_streams_match_jax_engine(params, case):
    prompts, max_new, kw = CASES[case]
    want = _streams(JEngine, params[0], prompts, max_new, **kw)
    got = _streams(Engine, params[1], prompts, max_new, **kw)
    assert got == want
    assert all(len(o) == max_new for o in got)


def test_stop_string_matches_jax_engine(params):
    prompt = [5, 17, 42]
    probe = _streams(Engine, params[1], [prompt], 6, max_batch=1, max_seq=64)[0]
    stop = [f"<{probe[2]}>"]  # the 3rd generated token's text
    kw = dict(max_batch=1, max_seq=64, tokenizer=_EchoTok())
    want = _streams(JEngine, params[0], [prompt], 6, stop_texts=stop, **kw)
    got = _streams(Engine, params[1], [prompt], 6, stop_texts=stop, **kw)
    assert got == want == [probe[:2]]
