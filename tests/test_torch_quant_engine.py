"""The port's quantized serving against the JAX package's engine on the
CPU: on the tiny float32 config with the same weights, greedy token
streams must be IDENTICAL to the JAX Engine's with (a) the int8 KV cache
on float weights, (b) int8 weights with W8A8 prefill and the int8 KV cache
— one prompt long enough that its prefill products have 256 rows, so
W8A8 runs in both engines — and (c) packed int4 weights with the int8 KV
cache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnop_tpu_torch.models.quantized as tquant
from nnop_tpu.models.llama import LlamaConfig as JLlamaConfig
from nnop_tpu.models.llama import init_params as j_init_params
from nnop_tpu.models.quantized import quantize_params as j_quantize_params
from nnop_tpu.runtime.engine import Engine as JEngine
from nnop_tpu_torch.models.llama import LlamaConfig
from nnop_tpu_torch.models.weights import params_from_numpy
from nnop_tpu_torch.runtime.engine import Engine

JCFG = JLlamaConfig.tiny(dtype=jnp.float32)
CFG = LlamaConfig.tiny(dtype=torch.float32)
SHORT = [[5, 17, 42, 7, 99, 3, 12, 8], [9, 9, 9]]
LONG = [(7 * i + 3) % 256 for i in range(200)]  # prefill bucket 256: 256-row products

CASES = {
    "int8_kv": (16, False, SHORT, dict(max_batch=2, max_seq=64)),
    "int8_w8a8_int8_kv": (8, True, [LONG, SHORT[0]], dict(max_batch=2, max_seq=224)),
    "int4_int8_kv": (4, False, SHORT, dict(max_batch=2, max_seq=64)),
}


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
def float_params():
    return j_init_params(jax.random.key(0), JCFG)


@pytest.mark.parametrize("case", list(CASES))
def test_quantized_greedy_streams_match_jax_engine(float_params, case, monkeypatch):
    wbits, w8a8, prompts, kw = CASES[case]
    jp = float_params if wbits == 16 else j_quantize_params(float_params, wbits=wbits)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    w8a8_rows = []
    real = tquant.quantized_matmul_w8a8
    monkeypatch.setattr(tquant, "quantized_matmul_w8a8",
                        lambda x, w: w8a8_rows.append(x.numel() // x.shape[-1]) or real(x, w))

    def streams(engine_cls, p):
        eng = engine_cls(p, JCFG if engine_cls is JEngine else CFG, quantized_kv=True,
                         w8a8=w8a8, **kw)
        reqs = [eng.submit(pr, max_new_tokens=6) for pr in prompts]
        eng.run()
        assert all(r.done for r in reqs)
        return [r.out for r in reqs]

    want = streams(JEngine, jp)
    got = streams(Engine, tp)
    assert got == want
    assert all(len(o) == 6 for o in got)
    assert (w8a8_rows and min(w8a8_rows) >= 256) if w8a8 else not w8a8_rows
