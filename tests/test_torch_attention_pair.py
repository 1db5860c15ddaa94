"""The port's flash_attention with the pair bias, key padding and segment
ids, and packed-document forward and training, against the JAX package
on the CPU.

The same numpy inputs (from a seed) go through the JAX function — its
Pallas kernels in interpret mode, as the root conftest arranges — and
through the port's plain path. Tolerances, each with its reason:
- 5e-5 for attention's output and its gradients dq, dk, dv and dpair
  (sums over keys, queries and the GQA group in another order), and
  dpair exactly 0 where the mask hides the score;
- 1e-6 for the head-dim padding against the unpadded plain path (zero
  lanes add exact zeros; only the order of the sums may differ);
- 1e-4 for the packed tiny model's logits and gradient leaves (two
  layers of f32 products and their transposes summed in another order).
The CUDA kernels themselves are held to these plain versions on the card
by tests/test_torch_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnop_tpu import flash_attention as j_flash_attention
from nnop_tpu.models.llama import LlamaConfig as JLlamaConfig
from nnop_tpu.models.llama import forward as j_forward
from nnop_tpu.models.llama import init_params as j_init_params
from nnop_tpu_torch.models.llama import LlamaConfig, forward
from nnop_tpu_torch.models.weights import params_from_numpy
from nnop_tpu_torch.ops import naive
from nnop_tpu_torch.ops.flash_attention import flash_attention, kernel_head_dim, pad_head_dim
from nnop_tpu_torch.parallel.tp_llama import tree_leaves
from nnop_tpu_torch.runtime.dataio import pack_tokens_segmented


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and a default thread pool per worker oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0, err_msg=msg)


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


# ---- flash attention: pair bias, kpad, segment ids --------------------------


def _segs(L, cuts):
    """Segment ids 1, 2, ... with a new document starting at each cut."""
    return np.cumsum(np.isin(np.arange(L), cuts)).astype(np.int32)[None] + 1


# (name, causal, QL, KL, pair, kpad, segments): QH 4 over KH 2, E 32
ATTN_CASES = [
    ("pair-causal", True, 96, 96, True, False, False),
    ("pair-kpad-noncausal", False, 64, 96, True, True, False),
    ("segments-causal", True, 80, 80, False, False, True),
    ("pair-kpad-segments-causal", True, 96, 96, True, True, True),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_flash_attention_features_match_jax(case):
    """o and dq, dk, dv, dpair against the JAX op under jax.vjp; dpair is
    exactly 0 wherever the mask (causal, kpad, segment) hides the score."""
    _, causal, QL, KL, has_pair, kpad, segments = case
    rng = np.random.default_rng(6)
    q, k, v = _rand(rng, 1, 4, QL, 32), _rand(rng, 1, 2, KL, 32), _rand(rng, 1, 2, KL, 32)
    do, pair = _rand(rng, 1, 4, QL, 32), _rand(rng, 1, 4, QL, KL)
    mask = np.ones((1, KL), bool)
    if kpad:
        mask[:, 5:9] = False
        mask[:, KL - 13:] = False
    seg = (_segs(QL, [30, 61]), _segs(KL, [30, 61])) if segments else None
    jkw = dict(causal=causal, kpad_mask=jnp.asarray(mask) if kpad else None,
               segment_ids=tuple(map(jnp.asarray, seg)) if segments else None)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v) + ((pair,) if has_pair else ()))

    def jfn(*a):
        return j_flash_attention(*a[:3], a[3] if has_pair else None, **jkw)

    jo, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(do))
    leaves = [_leaf(a) for a in (q, k, v) + ((pair,) if has_pair else ())]
    o = flash_attention(*leaves[:3], leaves[3] if has_pair else None, causal=causal,
                        kpad_mask=torch.from_numpy(mask) if kpad else None,
                        segment_ids=tuple(map(torch.from_numpy, seg)) if segments else None)
    _close(o, jo, 5e-5, "o")
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    for g, want, name in zip(grads, jgrads, ("dq", "dk", "dv", "dpair")):
        _close(g, want, 5e-5, name)
    if has_pair:
        visible = np.broadcast_to(mask[:, None, None, :], (1, 4, QL, KL))
        if causal:
            visible = visible & np.tri(QL, KL, dtype=bool)
        if segments:
            visible = visible & (seg[0][:, None, :, None] == seg[1][:, None, None, :])
        assert (grads[3].numpy()[~visible] == 0).all()
        assert (np.asarray(jgrads[3])[~visible] == 0).all()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_plain_attention_bwd_with_pair_and_segments_matches_autograd(causal):
    """naive_attention_bwd (the kernels' oracle) with the pair, kpad and
    segment ids against autograd through naive_attention: dpair is dS."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(_rand(rng, 2, h, 21, 16)).requires_grad_(True)
               for h in (4, 2, 2))
    pair = torch.from_numpy(_rand(rng, 2, 4, 21, 21)).requires_grad_(True)
    do = torch.from_numpy(_rand(rng, 2, 4, 21, 16))
    kpad = torch.ones((2, 21), dtype=torch.bool)
    kpad[1, 3:6] = False
    seg = torch.from_numpy(np.concatenate([_segs(21, [8]), _segs(21, [12, 15])]))
    kw = dict(causal=causal, scale=0.25, kpad_mask=kpad, segment_ids=(seg, seg))
    o, lse = naive.naive_attention(q, k, v, pair, return_lse=True, **kw)
    want = torch.autograd.grad(o, (q, k, v, pair), do)
    got = naive.naive_attention_bwd(q.detach(), k.detach(), v.detach(), o.detach(),
                                    lse.detach(), do, pair=pair.detach(), **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv", "dpair")):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0, msg=name)


def test_head_dim_padding_gives_the_plain_result():
    """The card's head-dim padding (E 48 run at 64, E 96 at 128, E 200 at
    256, with or without gradients) gives the unpadded plain result,
    output and gradients, with the scale of the true E; E past the
    kernels' largest raises."""
    rng = np.random.default_rng(8)
    for E in (48, 96, 200):
        Ep = kernel_head_dim(E)
        assert Ep == {48: 64, 96: 128, 200: 256}[E]
        leaves = [_leaf(_rand(rng, 1, h, 40, E)) for h in (4, 2, 2)]
        pair = _leaf(_rand(rng, 1, 4, 40, 40))
        do = torch.from_numpy(_rand(rng, 1, 4, 40, E))
        kw = dict(causal=True, scale=E ** -0.5)
        want_o = flash_attention(*leaves, pair, **kw)
        want = torch.autograd.grad(want_o, leaves + [pair], do)
        got_o = pad_head_dim(lambda q, k, v: flash_attention(q, k, v, pair, **kw), *leaves, Ep)
        got = torch.autograd.grad(got_o, leaves + [pair], do)
        torch.testing.assert_close(got_o, want_o, atol=1e-6, rtol=0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=0)
    assert kernel_head_dim(256) == 256
    with pytest.raises(ValueError):
        kernel_head_dim(257)
    with pytest.raises(ValueError):
        kernel_head_dim(300)


# ---- packed documents ------------------------------------------------------


def test_packed_documents_match_jax():
    """Three documents packed by pack_tokens_segmented (positions reset per
    document): the tiny f32 model's logits and the gradient of the mean
    next-token cross-entropy over the packed row against the JAX
    forward(positions=, segment_ids=) and jax.grad."""
    jcfg = JLlamaConfig.tiny(dtype=jnp.float32)
    jp = j_init_params(jax.random.key(3), jcfg)
    rng = np.random.default_rng(9)
    docs = [rng.integers(1, jcfg.vocab_size, n).tolist() for n in (15, 20, 25)]
    rows, segs, poss = (a[:1] for a in pack_tokens_segmented(docs, seq_len=48))
    toks, tgts, seg, pos = rows[:, :-1], rows[:, 1:], segs[:, :-1], poss[:, :-1]
    assert set(seg[0].tolist()) == {1, 2, 3} and (pos[0][seg[0] == 2] == np.arange(21)).all()

    def jloss(p):
        logits = j_forward(p, jnp.asarray(toks), jcfg, positions=jnp.asarray(pos),
                           segment_ids=jnp.asarray(seg))
        ll = jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(tgts)[..., None], -1)
        return -ll.mean(), logits

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    logits = forward(params, torch.from_numpy(toks), LlamaConfig.tiny(dtype=torch.float32),
                     positions=torch.from_numpy(pos), segment_ids=torch.from_numpy(seg))
    _close(logits, jlogits, 1e-4, "logits")
    ll = torch.gather(torch.log_softmax(logits, -1), -1, torch.from_numpy(tgts).long()[..., None])
    loss = -ll.mean()
    assert abs(loss.item() - float(jl)) <= 1e-4
    grads = torch.autograd.grad(loss, leaves)
    j_leaves = jax.tree.leaves(jgrads)
    assert len(j_leaves) == len(grads)
    for i, (g, jg) in enumerate(zip(grads, j_leaves)):
        _close(g, jg, 1e-4, f"leaf {i}")
