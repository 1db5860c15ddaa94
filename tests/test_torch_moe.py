"""The port's mixture-of-experts serving path (Mixtral) against the JAX
package on the CPU, on the tiny_moe config with the same numpy inputs:

* the grouped products (bf16/f32, int8, W8A8, int4) against the JAX
  functions, whose Pallas kernels run in interpret mode here: f32 within
  1e-4, W8A8 with f32 output exact;
* the router, the dispatch, the expert sort (identical integers) and the
  MoE layer (einsum and grouped), the forward logits within 1e-4;
* greedy token streams IDENTICAL to the JAX Engine's for f32 experts and
  for int8 experts with W8A8 prefill and the int8 KV cache (a 200-token
  prompt: its prefill pads to Tp 1024 rows, so W8A8 runs in both
  engines); int4 experts and the paged engine against the port itself;
* quantized trees crossing from the JAX package byte for byte.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnop_tpu.ops.grouped_matmul as jgmm
import nnop_tpu_torch.models.moe as tmoe
from nnop_tpu.models import moe as jmoe
from nnop_tpu.models.llama import LlamaConfig as JLlamaConfig
from nnop_tpu.models.llama import forward as j_forward
from nnop_tpu.ops.quantization import QTensor as JQTensor
from nnop_tpu.ops.quantization import quantize as j_quantize
from nnop_tpu.runtime.engine import Engine as JEngine
from nnop_tpu_torch.models.llama import LlamaConfig, forward, init_params
from nnop_tpu_torch.models.quantized import quantize_params
from nnop_tpu_torch.models.weights import params_from_numpy
from nnop_tpu_torch.ops import grouped_matmul as tgmm
from nnop_tpu_torch.ops.quantization import QTensor, QTensor4, dequantize4, quantize
from nnop_tpu_torch.ops.quantized_matmul import quantize_act
from nnop_tpu_torch.runtime.engine import Engine, fuse_decode_weights

JCFG = JLlamaConfig.tiny_moe(dtype=jnp.float32)
CFG = LlamaConfig.tiny_moe(dtype=torch.float32)
PROMPTS = [[5, 17, 42, 7, 99, 3, 12, 8], [9, 9, 9]]
LONG = [(7 * i + 3) % 256 for i in range(200)]  # bucket 256: 512 assignments, Tp 1024


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
def jparams():
    """The tiny_moe weights (the port's init from seed 0) as a numpy tree,
    handed to both packages."""
    gen = torch.Generator()
    gen.manual_seed(0)
    tree = init_params(gen, CFG)
    return {k: [{n: a.numpy() for n, a in layer.items()} for layer in v] if k == "layers"
            else v.numpy() for k, v in tree.items()}


@pytest.fixture(scope="module")
def int8_trees(jparams):
    """The port's int8 tree of jparams and the same bytes as the JAX
    package's tree (its quantize_params gives these bytes:
    test_quantized_trees_cross_byte_for_byte)."""
    tp = quantize_params(params_from_numpy(jparams))

    def to_jax(t):
        if isinstance(t, dict):
            return {k: to_jax(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_jax(v) for v in t]
        if isinstance(t, QTensor):
            return JQTensor(jnp.asarray(t.values.numpy()), jnp.asarray(t.scale.numpy()), t.axis)
        return jnp.asarray(t.numpy())

    return tp, to_jax(tp)


def _t(a):
    return torch.from_numpy(np.array(a))


def _silu(x):
    return torch.nn.functional.silu(x)


# ---- the grouped products --------------------------------------------


def _gmm_inputs(K=256, N=384, bm=8):
    """E = 4 experts, 5 blocks: expert 1 has no block, expert 2 two."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5 * bm, K)).astype(np.float32)
    w = (0.05 * rng.standard_normal((4, K, N))).astype(np.float32)
    return x, w, np.array([0, 2, 2, 3, 3], np.int32), bm


@pytest.mark.parametrize("mode", ["f32", "int8", "w8a8", "int4"])
def test_grouped_products_match_jax(mode):
    x, w, bg, bm = _gmm_inputs(K=200 if mode == "w8a8" else 256)
    xj, bgj = jnp.asarray(x), jnp.asarray(bg)

    def jit(fn, *args, **kw):
        return jax.jit(lambda *a: fn(*a, block_m=bm, **kw))(*args)

    with jax.default_matmul_precision("highest"):
        if mode == "f32":
            want = jit(jgmm.grouped_matmul, xj, jnp.asarray(w), bgj)
            got = tgmm.grouped_matmul(_t(x), _t(w), _t(bg), block_m=bm)
        elif mode == "int8":
            wq = j_quantize(jnp.asarray(w), axis=1)
            want = jit(jgmm.grouped_matmul_quantized, xj, wq, bgj)
            got = tgmm.grouped_matmul_quantized(_t(x), params_from_numpy(
                jax.tree.map(np.asarray, wq)), _t(bg), block_m=bm)
        elif mode == "w8a8":  # rows quantized by the port (exact division) for both
            wq = j_quantize(jnp.asarray(w), axis=1)
            xv, xs = quantize_act(_t(x))
            want = jit(jgmm.grouped_matmul_w8a8, (jnp.asarray(xv.numpy()),
                       jnp.asarray(xs.numpy())), wq, bgj, block_k=128, out_dtype=jnp.float32)
            got = tgmm.grouped_matmul_w8a8((xv, xs), params_from_numpy(
                jax.tree.map(np.asarray, wq)), _t(bg), block_m=bm, out_dtype=torch.float32)
        else:
            wq = jgmm.quantize4_experts(jnp.asarray(w), group=64, pack_block=256)
            want = jit(jgmm._grouped_matmul_q4, xj, wq, bgj, block_n=384)
            tq = params_from_numpy(jax.tree.map(np.asarray, wq))
            got = tgmm._grouped_matmul_q4(_t(x), tq, _t(bg), block_m=bm)
            # the port's quantize4_experts gives the JAX package's bytes
            mine = tgmm.quantize4_experts(_t(w), group=64, pack_block=256)
            assert torch.equal(mine.packed, tq.packed) and torch.equal(mine.scale, tq.scale)
    if mode == "w8a8":  # exact int32 sums: the same f32 bits
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert got.shape == (5 * bm, w.shape[2]) and tgmm.grouped_matmul.launches == 0


def test_grouped_w8a8_is_forward_only():
    x, w, bg, bm = _gmm_inputs()
    wq = quantize(_t(w), axis=1)
    with pytest.raises(RuntimeError, match="forward-only"):
        tgmm.grouped_matmul_w8a8(_t(x).requires_grad_(True), wq, _t(bg), block_m=bm)


# ---- router, dispatch, sort, the layer -------------------------------


def _layer_and_h(jparams, T, seed=1):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((T, JCFG.dim)).astype(np.float32)
    return jparams["layers"][0], h


@pytest.mark.parametrize("T,k", [(50, 3)])
def test_router_dispatch_sort_match_jax(jparams, T, k):
    layer, h = _layer_and_h(jparams, T)
    with jax.default_matmul_precision("highest"):
        jw, jidx, jprobs = jax.jit(jmoe.router_topk, static_argnums=2)(
            jnp.asarray(h), jnp.asarray(layer["w_router"]), k)
    w, idx, probs = tmoe.router_topk(_t(h), _t(layer["w_router"]), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(tmoe.load_balance_loss(probs, idx, 4)),
                               float(jmoe.load_balance_loss(jprobs, jidx, 4)), rtol=1e-6)

    C = tmoe.expert_capacity(T, 4, k, 1.0)
    assert C == jmoe.expert_capacity(T, 4, k, 1.0)
    jd, jc = jax.jit(jmoe.make_dispatch, static_argnums=(2, 3))(jidx, jw, 4, C)
    d, c = tmoe.make_dispatch(idx, w, 4, C)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6, rtol=0)

    for bm in (8, 32):
        want = jax.jit(jmoe.sort_tokens_by_expert, static_argnums=(1, 2))(jidx, 4, bm)
        src, dest, groups, Tp, order, rows = tmoe.sort_tokens_by_expert(idx, 4, bm)
        assert Tp == int(want[3])
        for got_a, want_a in zip((src, dest, groups, order), want[:3] + want[4:]):
            np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
        # block_rows: each block's real rows, counted from the layout
        real = np.zeros(Tp // bm, np.int64)
        np.add.at(real, dest.numpy() // bm, 1)
        np.testing.assert_array_equal(rows.numpy(), real)


@pytest.mark.parametrize("impl,T,k", [("einsum", 16, 2), ("grouped", 50, 3)])
def test_moe_mlp_matches_jax(jparams, impl, T, k):
    layer, h = _layer_and_h(jparams, T)
    jcfg, cfg = (dataclasses.replace(c, n_experts_per_token=k) for c in (JCFG, CFG))
    with jax.default_matmul_precision("highest"):
        want, jaux = jax.jit(lambda lay, x: jmoe.moe_mlp(lay, x, jcfg, act=jax.nn.silu,
                                                         impl=impl))(
            jax.tree.map(jnp.asarray, layer), jnp.asarray(h))
    tlayer = params_from_numpy(layer)
    got, aux = tmoe.moe_mlp(tlayer, _t(h), cfg, act=_silu, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    oracle = tmoe.moe_mlp_naive(tlayer, _t(h), cfg, act=_silu)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=1e-4, rtol=0)


def test_forward_logits_match_jax(jparams):
    tokens = np.random.default_rng(2).integers(0, 256, (2, 16))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(j_forward, static_argnums=2)(jax.tree.map(jnp.asarray, jparams),
                                                    jnp.asarray(tokens), JCFG)
    params = params_from_numpy(jparams)
    logits, aux = forward(params, _t(tokens), CFG, return_aux=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert float(aux) > 0
    grouped = forward(params, _t(tokens), dataclasses.replace(CFG, moe_impl="grouped"))
    np.testing.assert_allclose(grouped.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    # the engine's fused tree gives the same logits (fusing twice changes nothing)
    fused = fuse_decode_weights(fuse_decode_weights(params))
    assert fused["layers"][0]["w_gateup"].shape == (4, 128, 512)
    np.testing.assert_allclose(forward(fused, _t(tokens), CFG).numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("wbits", [16, 8, 4])
def test_quantized_trees_cross_byte_for_byte(jparams, int8_trees, wbits):
    """The port's quantize_params of the JAX package's float tree gives
    the JAX package's bytes, a stacked expert leaf (QTensor, axis 1) as
    the JAX quantize_params makes it (quantize(w, axis=1)) crosses
    params_from_numpy byte for byte, and the router stays floating point
    (int4: the experts become quantize4_experts, whose bytes
    test_grouped_products_match_jax holds to the JAX package's); fusing
    concatenates the experts along N, values and scales."""
    tp = params_from_numpy(jparams)
    if wbits == 4:
        tp = quantize_params(tp, wbits=4, group=64)
    elif wbits == 8:
        tp = int8_trees[0]
    layer = tp["layers"][1]
    if wbits == 16:
        for name in ("w_router", "w_gate", "w_up", "w_down"):
            assert np.array_equal(layer[name].numpy(), jparams["layers"][1][name])
    elif wbits == 8:
        assert np.array_equal(layer["w_router"].numpy(), jparams["layers"][1]["w_router"])
        j = jax.tree.map(np.asarray, j_quantize(jnp.asarray(jparams["layers"][1]["w_up"]),
                                                axis=1))
        for t in (layer["w_up"], params_from_numpy(j)):
            assert np.array_equal(t.values.numpy(), j.values)
            assert np.array_equal(t.scale.numpy(), j.scale)
            assert t.axis == 1 and t.scale.shape == (4, 256)
        assert layer["wq"].axis == 0 and layer["w_down"].values.shape == (4, 256, 128)
    else:
        w = params_from_numpy(jparams)["layers"][1]["w_down"]
        want = tgmm.quantize4_experts(w, group=64)
        got = layer["w_down"]
        assert torch.equal(got.packed, want.packed) and torch.equal(got.scale, want.scale)
        assert got.packed.shape == (4, 128, 128) and isinstance(layer["wq"], QTensor4)
    gu = fuse_decode_weights(tp)["layers"][1]["w_gateup"]
    g, u = layer["w_gate"], layer["w_up"]
    if wbits == 16:
        assert torch.equal(gu, torch.cat([g, u], dim=2))
    elif wbits == 8:
        assert torch.equal(gu.values, torch.cat([g.values, u.values], dim=2))
        assert torch.equal(gu.scale, torch.cat([g.scale, u.scale], dim=1)) and gu.axis == 1
    else:
        assert torch.equal(gu.packed, torch.cat([g.packed, u.packed], dim=2))
        assert torch.equal(gu.scale, torch.cat([g.scale, u.scale], dim=2))


# ---- serving -----------------------------------------------------------

ENGINE_CASES = {
    "f32_experts": (16, False, PROMPTS, dict(max_batch=2, max_seq=64)),
    "int8_experts_w8a8_int8_kv": (8, True, [LONG],
                                  dict(max_batch=2, max_seq=224, quantized_kv=True)),
}


def _streams(engine_cls, params, cfg, w8a8, prompts, kw):
    eng = engine_cls(params, cfg, w8a8=w8a8, **kw)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


@pytest.fixture(scope="module")
def jax_streams(jparams, int8_trees):
    """The JAX Engine's streams for each case, built once, with the padded
    rows of every W8A8 grouped product the JAX engine traced."""
    out = {}
    for case, (wbits, w8a8, prompts, kw) in ENGINE_CASES.items():
        jp = jax.tree.map(jnp.asarray, jparams) if wbits == 16 else int8_trees[1]
        rows = []
        real = jgmm.grouped_matmul_w8a8
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jgmm, "grouped_matmul_w8a8",
                       lambda x, *a, **k: rows.append(x.shape[0]) or real(x, *a, **k))
            out[case] = (_streams(JEngine, jp, JCFG, w8a8, prompts, kw), rows)
    return out


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_greedy_streams_match_jax_engine(jparams, int8_trees, jax_streams, case, monkeypatch):
    wbits, w8a8, prompts, kw = ENGINE_CASES[case]
    tp = params_from_numpy(jparams) if wbits == 16 else int8_trees[0]
    rows = []
    real = tmoe.grouped_matmul_w8a8
    monkeypatch.setattr(tmoe, "grouped_matmul_w8a8",
                        lambda x, *a, **k: rows.append(x.shape[0]) or real(x, *a, **k))
    got = _streams(Engine, tp, CFG, w8a8, prompts, kw)
    want, jrows = jax_streams[case]
    assert got == want
    assert all(len(o) == 6 for o in got)
    if w8a8:  # the long prompt's prefill ran W8A8 in both engines
        assert rows and min(rows) >= 1024 and jrows and min(jrows) >= 1024
    else:
        assert not rows and not jrows


def test_int4_engine_matches_dequantized_forward(jparams):
    """Packed int4 projections and experts: the engine's greedy chain
    equals the plain forward's on the dequantized weights (the same
    int4 values), as the JAX package's test_engine_serves_int4_moe holds."""
    fp = params_from_numpy(jparams)
    qp = quantize_params(fp, wbits=4, group=64)

    def deq(v, like):
        if isinstance(v, QTensor4):
            if v.packed.dim() == 3:
                d = torch.stack([dequantize4(QTensor4(p, s, v.group, v.pack_block))
                                 for p, s in zip(v.packed, v.scale)])
            else:
                d = dequantize4(v)
            return d[..., : like.shape[-2], :]
        return v

    dq = {k: deq(v, fp[k]) for k, v in qp.items() if k != "layers"}
    dq["layers"] = [{k: deq(v, fl[k]) for k, v in ql.items()}
                    for ql, fl in zip(qp["layers"], fp["layers"])]
    prompt = [5, 17, 42, 7, 99, 3]
    toks, want = list(prompt), []
    for _ in range(6):
        nxt = int(forward(dq, torch.tensor([toks]), CFG)[0, -1].argmax())
        want.append(nxt)
        toks.append(nxt)
    eng = Engine(qp, CFG, max_batch=2, max_seq=64)
    req = eng.submit(prompt, max_new_tokens=6)
    eng.run()
    assert req.out == want


def test_paged_engine_matches_contiguous(jparams):
    params = params_from_numpy(jparams)
    prompt = [9, 3, 1, 4, 1, 5]
    outs = []
    for kw in (dict(), dict(paged=True, page_size=128)):
        eng = Engine(params, CFG, max_batch=2, max_seq=256, **kw)
        req = eng.submit(prompt, max_new_tokens=8)
        eng.run()
        assert req.done
        outs.append(req.out)
    assert outs[0] == outs[1]
