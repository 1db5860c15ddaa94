"""Training the families on the port (Mistral's sliding window, Gemma-2's
score softcap, alternating window, post norms, offset norms and final
softcap) against the JAX package on the CPU.

The same numpy inputs (from a seed) go through the JAX function (its
Pallas kernels in interpret mode, as the root conftest arranges, under
`jax.jit`) and through the port's plain path, in float32. Tolerances,
each with its reason:
- 5e-5 for flash_attention's dq, dk and dv with a window that binds, a
  softcap that binds (q scaled so that |s| reaches several times the
  cap), both, head dim 256 with the softcap, and segment ids with the
  softcap (sums over keys, queries and the GQA group in another order);
- 1e-4 for the tiny models' loss and every gradient leaf (two layers of
  f32 products and their transposes summed in another order);
- 1e-3 for the losses of a 3-step loop (Adam turns gradient noise near
  zero into steps of +-lr).
The dQ and dK/dV kernels in these modes are held to the same plain
versions on the card by tests/test_torch_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnop_tpu.models.llama import LlamaConfig as JLlamaConfig
from nnop_tpu.models.llama import init_params as j_init_params
from nnop_tpu.models.llama import loss_fn as j_loss_fn
from nnop_tpu.ops.flash_attention import flash_attention as j_flash_attention
from nnop_tpu.parallel.tp_llama import AdamW as JAdamW
from nnop_tpu.runtime import dataio as j_dataio
from nnop_tpu_torch import cli
from nnop_tpu_torch.models.llama import LlamaConfig, loss_fn
from nnop_tpu_torch.models.weights import params_from_numpy
from nnop_tpu_torch.ops.flash_attention import flash_attention
from nnop_tpu_torch.parallel.tp_llama import tree_leaves
from nnop_tpu_torch.runtime import dataio

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


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=msg)


# ---- the op: dq, dk, dv with the window, the softcap and head dim 256 ------

# The JAX backward with a softcap gives NaN gradients where L is not a
# multiple of its key block (128 at these lengths): it multiplies dS by
# 1 - tanh^2 after the mask, and the ragged block's padding (NaN in
# interpret mode) makes 0 * NaN. So the softcap cases run at L 128.
GRAD_CASES = {
    # name: ((QH, KH, L, E), window, softcap, q scale, segment cuts or None).
    # At scale 1/sqrt(E) the scores of unit inputs have std ~|q scale|, so a
    # softcap of 2 binds at q x 4
    "window8_gqa4/2": ((4, 2, 40, 32), 8, None, 1.0, None),
    "softcap2_binds": ((4, 2, 128, 32), None, 2.0, 4.0, None),
    "window8_softcap2": ((4, 2, 128, 32), 8, 2.0, 4.0, None),
    "e256_softcap5": ((1, 1, 128, 256), None, 5.0, 8.0, None),
    "segments_softcap2_window8": ((4, 2, 128, 32), 8, 2.0, 4.0, (40, 83)),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_flash_attention_grads_match_jax(case):
    (QH, KH, L, E), window, softcap, q_scale, cuts = GRAD_CASES[case]
    rng = np.random.default_rng(11)
    q = (q_scale * rng.standard_normal((1, QH, L, E))).astype(np.float32)
    k, v = (rng.standard_normal((1, KH, L, E)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((1, QH, L, E)).astype(np.float32)
    seg = None
    if cuts is not None:
        seg = np.zeros((1, L), np.int32)
        for c in cuts:
            seg[:, c:] += 1
    kw = dict(causal=True, window=window, softcap=softcap)

    def j_attn(q, k, v, s):
        return j_flash_attention(q, k, v, segment_ids=None if s is None else (s, s), **kw)

    j_out, want = jax.jit(lambda q, k, v, s, do: (
        j_attn(q, k, v, s), jax.vjp(lambda a, b, c: j_attn(a, b, c, s), q, k, v)[1](do)))(
        q, k, v, seg, do)
    leaves = [_leaf(a) for a in (q, k, v)]
    tseg = None if seg is None else (torch.from_numpy(seg),) * 2
    out = flash_attention(*leaves, segment_ids=tseg, **kw)
    _close(out, j_out, ATOL_OPS, "o")
    if softcap is not None:  # the cap binds: the uncapped scores differ
        uncapped = flash_attention(*(t.detach() for t in leaves), segment_ids=tseg,
                                   **dict(kw, softcap=None))
        assert (uncapped - out).abs().max().item() > 1e-2
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, ATOL_OPS, f"d{name}")


# ---- the models: loss and every gradient leaf, and a 3-step loop ---------

FAMILIES = {
    "mistral": dict(sliding_window=8),
    "gemma2": dict(rms_offset=1.0, act="gelu", tie_embeddings=True, embed_scale=128.0**0.5,
                   post_norms=True, attn_softcap=20.0, final_softcap=15.0, sliding_window=8,
                   window_pattern=2),
}
# Gemma-2 (the softcap) at L 128: see GRAD_CASES
TOKENS = {"mistral": (1, 32), "gemma2": (2, 128)}
# the JAX loss's value_and_grad, compiled once per family for the loss and
# the loop tests (the same shapes)
_J_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(j_loss_fn), static_argnums=3)


def _family(family, seed=0):
    """The JAX config and numpy tree of a tiny family config, norm weights
    moved off their init so that their gradients are not trivial."""
    jcfg = JLlamaConfig.tiny(dtype=jnp.float32, **FAMILIES[family])
    jp = jax.tree.map(np.array, j_init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    for layer in jp["layers"]:
        for name, a in layer.items():
            if name.endswith("norm"):
                layer[name] = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return jcfg, jp, LlamaConfig.tiny(dtype=torch.float32, **FAMILIES[family])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_loss_and_grads_match_jax(family):
    jcfg, jp, cfg = _family(family, seed=2)
    rng = np.random.default_rng(5)
    toks, tgts = (rng.integers(0, jcfg.vocab_size, TOKENS[family]).astype(np.int32)
                  for _ in range(2))
    jloss, jgrads = _J_VALUE_AND_GRAD(jax.tree.map(jnp.asarray, jp), jnp.asarray(toks),
                                      jnp.asarray(tgts), jcfg)
    params = params_from_numpy(jp)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, torch.from_numpy(toks), torch.from_numpy(tgts), cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jloss)) <= ATOL_MODEL
    j_leaves = jax.tree.leaves(jgrads)  # sorted dict keys, as tree_leaves
    assert len(j_leaves) == len(grads)
    for i, (g, jg) in enumerate(zip(grads, j_leaves)):
        _close(g, jg, ATOL_MODEL, f"leaf {i}")
    if family == "gemma2":  # the post norms carry gradient
        post = params["layers"][0]["attn_post_norm"]
        assert next(g for p, g in zip(leaves, grads) if p is post).abs().max().item() > 0


def test_gemma2_train_loop_matches_jax():
    """3 steps of cli.train_loop on the tiny Gemma-2 against the JAX CLI's
    loop (value_and_grad of its loss_fn, then AdamW's update) from the same
    params on the CLI's synthetic stream."""
    jcfg, jp, cfg = _family("gemma2")
    batch, seq = TOKENS["gemma2"]
    rows = dataio.pack_tokens([[(7 * i + 3) % jcfg.vocab_size for i in range(seq * 64)]],
                              seq_len=seq)
    jopt = JAdamW(lr=1e-3)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jopt.init(jparams)
    update = jax.jit(jopt.update)
    jlosses = []
    for toks, tgts in j_dataio.batches(rows, batch, seed=0):
        loss, grads = _J_VALUE_AND_GRAD(jparams, jnp.asarray(toks), jnp.asarray(tgts), jcfg)
        jparams, jstate = update(grads, jstate, jparams)
        jlosses.append(float(loss))
        if len(jlosses) == 3:
            break
    _, state, losses = cli.train_loop(cfg, params_from_numpy(jp), rows, steps=3, batch=batch,
                                      lr=1e-3, device="cpu", log=lambda s: None)
    assert state["count"] == 3
    np.testing.assert_allclose(losses, jlosses, atol=1e-3, rtol=0)
