"""The port's MoE training path (Mixtral's, on tiny_moe) against the JAX
package's on the CPU, in float32, from the same numpy inputs. The JAX
side runs as its own tests run it: its grouped products' Pallas kernels
(the forward, dx and `_gmm_dw`) in interpret mode. Tolerances, each with
its reason:
- 1e-5 for the grouped product's dx and dw and the plain dw (f32 sums of
  at most 16 rows or columns taken in another order);
- 1e-4 for the MoE layer's gradients, the tiny model's loss and every
  gradient leaf (f32 products and their transposes over two layers,
  summed in another order);
- 1e-3 for the losses of a 3-step training loop (Adam turns gradient
  noise near zero into steps of +-lr, as tests/test_torch_train.py says);
- exact for an expert with no row (its dw is zero).
The grouped products' backward is a torch.autograd.Function: on the CPU
it runs the plain versions of kernel I (dx) and the dw kernel, and these
tests count the plain dw's calls to show that the Function's backward,
not autograd through the plain forward, made the gradients. The kernels
themselves are held to these plain versions on the card by
tests/test_torch_kernels.py and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnop_tpu.ops.grouped_matmul as jgmm
import nnop_tpu_torch.ops.grouped_matmul as tgmm
from nnop_tpu.models import moe as jmoe
from nnop_tpu.models.llama import LlamaConfig as JLlamaConfig
from nnop_tpu.models.llama import loss_fn as j_loss_fn
from nnop_tpu.parallel.tp_llama import AdamW as JAdamW
from nnop_tpu.runtime import dataio as j_dataio
from nnop_tpu_torch import cli
from nnop_tpu_torch.models import moe as tmoe
from nnop_tpu_torch.models.llama import LlamaConfig, forward, init_params, loss_fn
from nnop_tpu_torch.models.weights import params_from_numpy
from nnop_tpu_torch.ops import naive
from nnop_tpu_torch.ops.quantization import quantize
from nnop_tpu_torch.parallel.tp_llama import tree_leaves
from nnop_tpu_torch.runtime import dataio

JCFG = JLlamaConfig.tiny_moe(dtype=jnp.float32)
CFG = LlamaConfig.tiny_moe(dtype=torch.float32)
IMPLS = ["einsum", "grouped"]


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
    """The tiny_moe weights (the port's init from seed 0) as the JAX
    package's tree, built once (the JAX init takes seconds on the CPU)."""
    gen = torch.Generator()
    gen.manual_seed(0)
    tree = init_params(gen, CFG)
    return jax.tree.map(lambda a: jnp.asarray(a.numpy()), tree)


@pytest.fixture(scope="module")
def j_value_and_grad():
    """The JAX loss's value_and_grad on tiny_moe with its default
    moe_impl ("einsum", what the JAX CLI trains), jitted once and shared
    by the loss and training-loop tests of both of the port's moe_impl
    values (a compile takes seconds). The layers compute one function
    (dropless), and the JAX package's own test holds its grouped path's
    gradients to its einsum path's (tests/test_moe.py:216); the port's
    grouped layer is held to the JAX grouped layer below."""
    vg = jax.jit(jax.value_and_grad(j_loss_fn), static_argnums=3)
    return lambda p, toks, tgts: vg(p, toks, tgts, JCFG)


class _CountDw:
    """Counts the plain dw's calls from the grouped product's backward."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = tgmm.naive_grouped_matmul_dw

        def counted(*a, **kw):
            self.calls += 1
            return real(*a, **kw)

        monkeypatch.setattr(tgmm, "naive_grouped_matmul_dw", counted)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=msg)


def _port(jp):
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


# ---- the grouped product's backward -----------------------------------


def test_grouped_matmul_grads_match_jax(monkeypatch):
    """tests/test_moe.py:152 on the port: dx and dw of grouped_matmul
    against the JAX custom_vjp's, experts 1 and 3 without a block."""
    E, K, N, bm = 4, 64, 96, 8
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4 * bm, K)).astype(np.float32)
    w = (0.1 * rng.standard_normal((E, K, N))).astype(np.float32)
    t = rng.standard_normal((4 * bm, N)).astype(np.float32)
    bg = np.array([0, 0, 2, 2], np.int32)
    with jax.default_matmul_precision("highest"):
        jgx, jgw = jax.jit(jax.grad(
            lambda x, w: jnp.sum(jgmm.grouped_matmul(x, w, jnp.asarray(bg), block_m=bm) * t),
            argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    dw_calls = _CountDw(monkeypatch)
    tx, tw = _t(x, True), _t(w, True)
    (tgmm.grouped_matmul(tx, tw, _t(bg), block_m=bm) * _t(t)).sum().backward()
    assert dw_calls.calls == 1
    _close(tx.grad, jgx, 1e-5, "dx")
    _close(tw.grad, jgw, 1e-5, "dw")
    for e in (1, 3):
        assert (tw.grad[e] == 0).all() and (np.asarray(jgw[e]) == 0).all()


@pytest.mark.parametrize("rows", [None, [8, 3, 8, 5, 0]])
def test_plain_dw_matches_jax_gmm_dw(rows):
    """naive_grouped_matmul_dw against the JAX `_gmm_dw` kernel with ragged
    K and N (96, 160) and an expert without a block. With block_rows the
    rows past each block's real rows hold noise that the port must skip;
    the JAX kernel, which has no block_rows, sees them as zeros."""
    E, K, N, bm = 4, 96, 160, 8
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5 * bm, K)).astype(np.float32)
    dy = rng.standard_normal((5 * bm, N)).astype(np.float32)
    bg = np.array([0, 0, 2, 3, 3], np.int32)
    xz = x.copy()
    if rows is not None:
        pad = (np.arange(bm)[None] >= np.array(rows)[:, None]).reshape(-1)
        xz[pad] = 0.0
    with jax.default_matmul_precision("highest"):
        want = jgmm._gmm_dw(jnp.asarray(xz), jnp.asarray(dy), jnp.asarray(bg), block_m=bm,
                            block_n=512, block_k=512, w_shape=(E, K, N), w_dtype=jnp.float32)
    got = naive.naive_grouped_matmul_dw(_t(x), _t(dy), _t(bg), bm, E,
                                        None if rows is None else _t(np.array(rows, np.int32)))
    assert got.shape == (E, K, N) and (got[1] == 0).all()
    _close(got, want, 1e-5)


def test_moe_layer_grads_match_jax_and_einsum(jparams, monkeypatch):
    """tests/test_moe.py:216 on the port: the grouped layer's gradients
    (w_router, w_gate, w_up, w_down, h) equal the einsum layer's (dropless,
    so both compute the same function), and both the JAX grouped
    layer's."""
    layer = jparams["layers"][0]
    layer = {k: layer[k] for k in ("w_router", "w_gate", "w_up", "w_down")}
    T, d = 24, JCFG.dim
    rng = np.random.default_rng(4)
    h, t = (rng.standard_normal((T, d)).astype(np.float32) for _ in range(2))
    names = ("w_router", "w_gate", "w_up", "w_down")

    def jloss(layer, h):
        out, aux = jmoe.moe_mlp_grouped(layer, h, JCFG, act=jax.nn.silu)
        return jnp.sum(out * t) + aux

    with jax.default_matmul_precision("highest"):
        jg_layer, jg_h = jax.jit(jax.grad(jloss, argnums=(0, 1)))(layer, jnp.asarray(h))
    dw_calls = _CountDw(monkeypatch)
    for impl in IMPLS:
        tl = {k: _t(v, True) for k, v in layer.items()}
        th = _t(h, True)
        out, aux = tmoe.moe_mlp(tl, th, CFG, act=torch.nn.functional.silu, impl=impl)
        (out * _t(t)).sum().add(aux).backward()
        for name in names:
            _close(tl[name].grad, jg_layer[name], 1e-4, f"{impl} {name}")
        _close(th.grad, jg_h, 1e-4, f"{impl} h")
        assert tl["w_router"].grad.abs().sum() > 0
    assert dw_calls.calls == 3  # the grouped layer's three products


def _batch(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, JCFG.vocab_size, (2, 16)).astype(np.int32) for _ in range(2))


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_grads_match_jax(jparams, j_value_and_grad, impl, monkeypatch):
    """tests/test_moe.py:107 on the port: loss_fn and every gradient leaf
    on tiny_moe, with either moe_impl, against the JAX loss_fn; the router
    gets a gradient in every layer, and the loss is the cross-entropy plus
    router_aux_coef * aux / n_layers."""
    toks, tgts = _batch(5)
    jloss, jgrads = j_value_and_grad(jparams, jnp.asarray(toks), jnp.asarray(tgts))
    cfg = dataclasses.replace(CFG, moe_impl=impl)
    params = _port(jparams)
    dw_calls = _CountDw(monkeypatch)
    loss = loss_fn(params, torch.from_numpy(toks), torch.from_numpy(tgts), cfg)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert dw_calls.calls == (3 * cfg.n_layers if impl == "grouped" else 0)
    assert abs(loss.item() - float(jloss)) <= 1e-4
    j_leaves = jax.tree.leaves(jgrads)  # sorted dict keys, as tree_leaves
    assert len(j_leaves) == len(grads) == cfg.n_layers * 10 + 3
    for i, (g, jg) in enumerate(zip(grads, j_leaves)):
        _close(g, jg, 1e-4, f"leaf {i}")
    for layer in jgrads["layers"]:
        assert float(jnp.abs(layer["w_router"]).sum()) > 0
    router = [g for g, p in zip(grads, tree_leaves(params))
              if any(p is layer["w_router"] for layer in params["layers"])]
    assert len(router) == cfg.n_layers and all(g.abs().sum() > 0 for g in router)
    with torch.no_grad():
        logits, aux = forward(params, torch.from_numpy(toks), cfg, return_aux=True)
        ce = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                               torch.from_numpy(tgts).long().reshape(-1))
    assert aux.item() > 0
    assert abs((loss.item() - ce.item()) - cfg.router_aux_coef * aux.item() / cfg.n_layers) <= 1e-6


@pytest.mark.parametrize("impl", IMPLS)
def test_train_loop_matches_jax(jparams, j_value_and_grad, impl):
    """3 steps of cli.train_loop on tiny_moe, with either moe_impl,
    against the JAX CLI's step (value_and_grad of its loss_fn, then AdamW's
    update; each jitted) from the same params on the CLI's synthetic
    stream."""
    seq, batch = 16, 2
    rows = dataio.pack_tokens([[(7 * i + 3) % JCFG.vocab_size for i in range(seq * 64)]],
                              seq_len=seq)
    jopt = JAdamW(lr=1e-3)
    update = jax.jit(jopt.update)
    jp, jstate = jparams, jopt.init(jparams)
    vg = j_value_and_grad
    jlosses = []
    for toks, tgts in j_dataio.batches(rows, batch, seed=0):
        loss, grads = vg(jp, jnp.asarray(toks), jnp.asarray(tgts))
        jp, jstate = update(grads, jstate, jp)
        jlosses.append(float(loss))
        if len(jlosses) == 3:
            break
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    _, state, losses = cli.train_loop(dataclasses.replace(CFG, moe_impl=impl), params, rows,
                                      steps=3, batch=batch, lr=1e-3, device="cpu",
                                      log=lambda s: None)
    assert state["count"] == 3
    np.testing.assert_allclose(losses, jlosses, atol=1e-3, rtol=0)


def test_cli_train_tiny_moe(capsys):
    cli.main(["train", "--model", "tiny_moe", "--device", "cpu", "--steps", "2", "--seq", "16",
              "--batch", "2"])
    out = capsys.readouterr().out
    assert "step 2: loss" in out


# ---- the forward-only products -----------------------------------------


@pytest.mark.parametrize("mode", ["int8", "int4", "w8a8"])
def test_quantized_experts_refuse_grad(mode):
    """Quantized experts are not trained: their grouped products raise for
    activations that require a gradient, also through the MoE layer."""
    rng = np.random.default_rng(6)
    x = _t(rng.standard_normal((16, 64)).astype(np.float32), True)
    w = torch.from_numpy((0.05 * rng.standard_normal((2, 64, 32))).astype(np.float32))
    bg = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="forward-only"):
        if mode == "int8":
            tgmm.grouped_matmul_quantized(x, quantize(w, axis=1), bg, block_m=8)
        elif mode == "int4":
            tgmm._grouped_matmul_q4(x, tgmm.quantize4_experts(w, group=32, pack_block=64), bg,
                                    block_m=8)
        else:
            tgmm.grouped_matmul_w8a8(x, quantize(w, axis=1), bg, block_m=8)
    with torch.no_grad():  # serving: the same call without a gradient
        tgmm.grouped_matmul_quantized(x, quantize(w, axis=1), bg, block_m=8)
    layer = {"w_router": torch.zeros(64, 2), "w_gate": quantize(w, axis=1),
             "w_up": quantize(w, axis=1), "w_down": quantize(w.transpose(1, 2), axis=1)}
    cfg = dataclasses.replace(CFG, dim=64, hidden_dim=32, n_experts=2)
    with pytest.raises(RuntimeError, match="forward-only"):
        tmoe.moe_mlp(layer, x, cfg, act=torch.nn.functional.silu)
