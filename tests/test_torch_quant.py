"""The port's quantization ops against the JAX package's on the CPU.

The same numpy inputs (from a seed) go through the JAX op — its Pallas
kernels in interpret mode, as the root conftest arranges — and through
the port's plain path. Tolerances: the quantizers, the int8 flush and the
W8A8 product (on activations JAX has already quantized) are bit-exact;
the weight-only products 1e-5 relative in f32 (fp32 sums in another
order); int8 decode attention 5e-5 absolute in f32 (the bf16 roundings of
q and P are the same on both sides). The kernels are held to these plain
versions on the card by tests/test_torch_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnop_tpu.models.llama import LlamaConfig as JLlamaConfig
from nnop_tpu.models.llama import init_params as j_init_params
from nnop_tpu.models.llama import init_quantized_params as j_init_quantized_params
from nnop_tpu.models.quantized import quantize_params as j_quantize_params
from nnop_tpu.ops import quantization as jq
from nnop_tpu.ops import quantized_matmul as jqm
from nnop_tpu.ops.attention_decode import decode_attention as j_decode_attention
from nnop_tpu.ops.kv_write import flush_staging as j_flush_staging
from nnop_tpu_torch.models.llama import LlamaConfig, init_quantized_params
from nnop_tpu_torch.models.quantized import quantize_params
from nnop_tpu_torch.models.weights import params_from_numpy, tensor_from_numpy
from nnop_tpu_torch.ops import quantization as tq
from nnop_tpu_torch.ops.attention_decode import decode_attention
from nnop_tpu_torch.ops.kv_write import flush_staging
from nnop_tpu_torch.ops.quantized_matmul import (
    quantize_act,
    quantized_matmul,
    quantized_matmul4,
    quantized_matmul_w8a8,
)

SHAPES = {"aligned": (8, 256, 384), "ragged": (100, 300, 200)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and a default thread pool per worker oversubscribes the
    cores (tens of times slower on these tiny tensors under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _equal(got, want):
    """Bit-exact: the tensor and the JAX/numpy array hold the same bytes."""
    want = np.asarray(want)
    got = got.contiguous()
    if got.dtype == torch.float8_e4m3fn:
        got, want = got.view(torch.uint8), want.view(np.uint8)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _inputs(shape, seed=0):
    M, K, N = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


@pytest.mark.parametrize("kind,shape", [("int8", (256, 384)), ("fp8", (128, 256)),
                                        ("int4", (1024, 384)), ("int4", (1000, 256))],
                         ids=["int8", "fp8", "int4", "int4-padded-K"])
def test_quantizers_bit_exact(kind, shape):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    if kind == "int4":
        jw, tw = jq.quantize4(jnp.asarray(w)), tq.quantize4(torch.from_numpy(w))
        assert (tw.group, tw.pack_block) == (jw.group, jw.pack_block)
        _equal(tw.packed, jw.packed)
        _equal(tw.scale, jw.scale)
        _equal(tq.dequantize4(tw), jq.dequantize4(jw))
        return
    jdt, tdt = (jnp.int8, torch.int8) if kind == "int8" else (jnp.float8_e4m3fn,
                                                               torch.float8_e4m3fn)
    jw, tw = jq.quantize(jnp.asarray(w), axis=0, dtype=jdt), tq.quantize(torch.from_numpy(w),
                                                                        axis=0, dtype=tdt)
    _equal(tw.values, jw.values)
    _equal(tw.scale, jw.scale)
    _equal(tq.dequantize(tw), jq.dequantize(jw))


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_quantized_matmul_matches_jax(shape, dtype):
    x, w = _inputs(SHAPES[shape])
    jdt = jnp.int8 if dtype == "int8" else jnp.float8_e4m3fn
    jw = jq.quantize(jnp.asarray(w), axis=0, dtype=jdt)
    want = jqm.quantized_matmul(jnp.asarray(x), jw)
    tw = tq.QTensor(_t(jw.values), _t(jw.scale), 0)
    got = quantized_matmul(torch.from_numpy(x), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_quantized_matmul4_matches_jax(shape):
    x, w = _inputs(SHAPES[shape])
    jw = jq.quantize4(jnp.asarray(w * 0.05))
    want = jqm.quantized_matmul4(jnp.asarray(x), jw)
    tw = tq.QTensor4(_t(jw.packed), _t(jw.scale), jw.group, jw.pack_block)
    got = quantized_matmul4(torch.from_numpy(x), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_quantized_matmul_w8a8_matches_jax(shape):
    """quantize_act is bit-exact; on the activations JAX quantized, the
    product is exact against JAX's kernel and an int64 reference."""
    x, w = _inputs(SHAPES[shape])
    jxv, jxs = jqm.quantize_act(jnp.asarray(x))
    txv, txs = quantize_act(torch.from_numpy(x))
    _equal(txv, jxv)
    _equal(txs, jxs)
    jw = jq.quantize(jnp.asarray(w), axis=0)
    want = jqm.quantized_matmul_w8a8((jxv, jxs), jw, out_dtype=jnp.float32)
    got = quantized_matmul_w8a8((_t(jxv), _t(jxs)), tq.QTensor(_t(jw.values), _t(jw.scale), 0),
                                out_dtype=torch.float32)
    acc = np.asarray(jxv, np.int64) @ np.asarray(jw.values, np.int64)
    ref = acc.astype(np.float32) * np.asarray(jxs) * np.asarray(jw.scale)
    _equal(got, want)
    _equal(got, ref)


def test_int8_decode_attention_matches_jax():
    """Stacked int8 caches with per-token scales, bf16 staging, ragged
    lengths with an empty slot."""
    rng = np.random.default_rng(2)
    NL, B, KH, G, S, E, W = 2, 4, 2, 4, 96, 128, 32
    kc = rng.integers(-127, 128, (NL, B, KH, S, E)).astype(np.int8)
    vc = rng.integers(-127, 128, (NL, B, KH, S, E)).astype(np.int8)
    ksc = (rng.uniform(0.5, 1.5, (NL, B, KH, S)) / 127).astype(np.float32)
    vsc = (rng.uniform(0.5, 1.5, (NL, B, KH, S)) / 127).astype(np.float32)
    kst = jnp.asarray(rng.standard_normal((B, NL, KH, W, E)), jnp.bfloat16)
    vst = jnp.asarray(rng.standard_normal((B, NL, KH, W, E)), jnp.bfloat16)
    q = rng.standard_normal((B, KH * G, 1, E)).astype(np.float32)
    lengths = np.array([0, 5, 33, 90], np.int32)
    kw = dict(staged_n=7, layer=1)
    want = j_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(lengths), jnp.asarray(ksc), jnp.asarray(vsc),
                              k_stage=kst, v_stage=vst, **kw)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                           torch.from_numpy(lengths), torch.from_numpy(ksc),
                           torch.from_numpy(vsc), k_stage=_t(kst), v_stage=_t(vst), **kw)
    assert (got[0] == 0).all()  # the empty slot
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)


def test_int8_flush_bit_exact():
    rng = np.random.default_rng(3)
    NL, B, KH, S, E, W = 2, 3, 2, 128, 64, 32
    kc = rng.integers(-127, 128, (NL, B, KH, S, E)).astype(np.int8)
    vc = rng.integers(-127, 128, (NL, B, KH, S, E)).astype(np.int8)
    ksc = rng.uniform(0, 1, (NL, B, KH, S)).astype(np.float32)
    vsc = rng.uniform(0, 1, (NL, B, KH, S)).astype(np.float32)
    kst = rng.standard_normal((B, NL, KH, W, E)).astype(np.float32)
    kst[1, 0, 1, 3] = 0.0  # an all-zero row takes the 1e-8 floor
    kst = jnp.asarray(kst, jnp.bfloat16)
    vst = jnp.asarray(rng.standard_normal((B, NL, KH, W, E)), jnp.bfloat16)
    lengths = np.array([0, 7, 40], np.int32)
    want = j_flush_staging(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ksc), jnp.asarray(vsc),
                           kst, vst, jnp.asarray(lengths))
    got = [torch.from_numpy(a.copy()) for a in (kc, vc, ksc, vsc)]
    flush_staging(*got, _t(kst), _t(vst), torch.from_numpy(lengths))
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("wbits,dtype", [(8, "int8"), (8, "fp8"), (4, "int8")],
                         ids=["int8", "fp8", "int4"])
def test_quantized_params_cross_bit_exact(wbits, dtype):
    """params_from_numpy carries a JAX quantize_params tree byte for byte,
    and the port's quantize_params on the same float weights gives the
    same bytes."""
    cfg = JLlamaConfig.tiny(dtype=jnp.float32)
    jp = j_init_params(jax.random.key(0), cfg)
    jdt, tdt = (jnp.int8, torch.int8) if dtype == "int8" else (jnp.float8_e4m3fn,
                                                               torch.float8_e4m3fn)
    jqp = jax.tree.map(np.asarray, j_quantize_params(jp, jdt, wbits=wbits))
    crossed = params_from_numpy(jqp)
    ported = quantize_params(params_from_numpy(jax.tree.map(np.asarray, jp)), tdt, wbits=wbits)
    for tree in (crossed, ported):
        for key in ("lm_head", "embed"):
            _check_leaf(tree[key], jqp[key])
        for tl, jl in zip(tree["layers"], jqp["layers"]):
            assert tl.keys() == jl.keys()
            for key in jl:
                _check_leaf(tl[key], jl[key])


def _check_leaf(t, j):
    if isinstance(t, tq.QTensor4):
        assert (t.group, t.pack_block) == (j.group, j.pack_block)
        _equal(t.packed, j.packed)
        _equal(t.scale, j.scale)
    elif isinstance(t, tq.QTensor):
        assert t.axis == j.axis
        _equal(t.values, j.values)
        _equal(t.scale, j.scale)
    else:
        _equal(t, j)


def test_random_int4_nibbles_are_zero_mean():
    """The JAX package's init_quantized_params(wbits=4) draws whole bytes,
    so its nibbles have mean -0.5 (a common component in every weight);
    the port draws each nibble from [-7, 7]."""
    jp = j_init_quantized_params(jax.random.key(0), JLlamaConfig.tiny(), wbits=4)
    jw = jp["layers"][0]["w_gate"]
    j_mean = tq.unpack4(tq.QTensor4(_t(jw.packed), _t(jw.scale), jw.group,
                                    jw.pack_block)).double().mean().item()
    gen = torch.Generator()
    gen.manual_seed(0)
    tw = init_quantized_params(gen, LlamaConfig.tiny(), wbits=4)["layers"][0]["w_gate"]
    nibbles = tq.unpack4(tw)
    assert abs(j_mean + 0.5) < 0.05
    assert abs(nibbles.double().mean().item()) < 0.05 and nibbles.abs().max() <= 7
