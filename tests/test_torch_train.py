"""The port's training path against the JAX package's on the CPU.

The same numpy inputs (from a seed) go through the JAX function — its
Pallas kernels in interpret mode, as the root conftest arranges — and
through the port's plain path, in float32. Tolerances, each with its
reason:
- 1e-5 for the RMS-norm and rope gradients (elementwise f32 arithmetic
  and one row reduction taken in another order);
- 5e-5 for the attention gradients (sums over keys, queries and the GQA
  group in another order);
- 1e-4 for the tiny model's loss and every gradient leaf (two layers of
  f32 products and their transposes summed in another order);
- 1e-6 for AdamW (the same f32 elementwise update; the schedule's lr in
  f64 here and f32 there differs by < 1e-7 relative);
- 1e-3 for the losses of a 3-step training loop: Adam turns gradient
  noise near zero into steps of +-lr, so agreement at the 1e-6 level in
  the gradients becomes ~1e-4 in the parameters after a step;
- exact for the data pipeline (the same numpy code and seed) and the
  checkpoint (the same bytes).
The backward kernels themselves are held to these plain versions on the
card by tests/test_torch_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnop_tpu import flash_attention as j_flash_attention
from nnop_tpu.models.llama import LlamaConfig as JLlamaConfig
from nnop_tpu.models.llama import init_params as j_init_params
from nnop_tpu.models.llama import loss_fn as j_loss_fn
from nnop_tpu.models.weights import load_checkpoint as j_load_checkpoint
from nnop_tpu.ops.rms_norm import rms_norm as j_rms_norm
from nnop_tpu.ops.rope import RotaryEmbedding as JRotaryEmbedding
from nnop_tpu.ops.rope import llama_rope as j_llama_rope
from nnop_tpu.parallel.tp_llama import AdamW as JAdamW
from nnop_tpu.parallel.tp_llama import clip_by_global_norm as j_clip_by_global_norm
from nnop_tpu.parallel.tp_llama import cosine_warmup_schedule as j_cosine
from nnop_tpu.runtime import dataio as j_dataio
from nnop_tpu_torch import cli
from nnop_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
from nnop_tpu_torch.models.weights import load_checkpoint, params_from_numpy, save_checkpoint
from nnop_tpu_torch.ops import naive
from nnop_tpu_torch.ops.flash_attention import flash_attention
from nnop_tpu_torch.ops.rms_norm import rms_norm
from nnop_tpu_torch.ops.rope import RotaryEmbedding, llama_rope, llama_rope_bwd
from nnop_tpu_torch.parallel.tp_llama import (
    AdamW, clip_by_global_norm, cosine_warmup_schedule, tree_leaves,
)
from nnop_tpu_torch.runtime import dataio


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and a default thread pool per worker oversubscribes the
    cores (tens of times slower on these tiny tensors under load)."""
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


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_grads_match_jax(offset):
    rng = np.random.default_rng(0)
    x, w, dy = _rand(rng, 3, 5, 64), 0.5 + _rand(rng, 64), _rand(rng, 3, 5, 64)
    jdx, jdw = jax.jit(lambda x, w, dy: jax.vjp(
        lambda x, w: j_rms_norm(x, w, 1e-5, offset=offset), x, w)[1](dy))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(dy))
    tx, tw = _leaf(x), _leaf(w)
    dx, dw = torch.autograd.grad(rms_norm(tx, tw, 1e-5, offset=offset), (tx, tw),
                                 torch.from_numpy(dy))
    _close(dx, jdx, 1e-5, "dx")
    _close(dw, jdw, 1e-5, "dw")


def test_rope_grads_match_jax():
    rng = np.random.default_rng(1)
    q, k = _rand(rng, 2, 4, 7, 32), _rand(rng, 2, 2, 7, 32)
    dq, dk = _rand(rng, 2, 4, 7, 32), _rand(rng, 2, 2, 7, 32)
    cos, sin = (np.array(a) for a in JRotaryEmbedding(32)(jnp.arange(7)[None].repeat(2, 0) + 5))
    jdq, jdk = jax.jit(lambda q, k, d: jax.vjp(lambda q, k: j_llama_rope(q, k, cos, sin), q, k)[1](
        d))(jnp.asarray(q), jnp.asarray(k), (jnp.asarray(dq), jnp.asarray(dk)))
    tq, tk = _leaf(q), _leaf(k)
    got = torch.autograd.grad(llama_rope(tq, tk, torch.from_numpy(cos), torch.from_numpy(sin)),
                              (tq, tk), (torch.from_numpy(dq), torch.from_numpy(dk)))
    _close(got[0], jdq, 1e-5, "dq")
    _close(got[1], jdk, 1e-5, "dk")


# (name, causal, QH, KH, QL, KL, kpad): every row sees key 0, as the JAX
# naive oracle differs from its kernels on a row with no visible key
FLASH_CASES = [
    ("causal-gqa4/2", True, 4, 2, 48, 48, False),
    ("noncausal-gqa4/2", False, 4, 2, 40, 56, False),
    ("causal-kpad", True, 4, 2, 48, 48, True),
    ("noncausal-kpad", False, 4, 2, 40, 56, True),
    ("causal-ragged-L37", True, 4, 2, 37, 37, False),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_grads_match_jax(case):
    _, causal, QH, KH, QL, KL, kpad = case
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 1, QH, QL, 32), _rand(rng, 1, KH, KL, 32), _rand(rng, 1, KH, KL, 32)
    do = _rand(rng, 1, QH, QL, 32)
    mask = np.ones((1, KL), bool)
    if kpad:
        mask[:, KL - 11:] = False
    jmask = jnp.asarray(mask) if kpad else None
    want = jax.jit(lambda q, k, v, do: jax.vjp(
        lambda q, k, v: j_flash_attention(q, k, v, causal=causal, kpad_mask=jmask), q, k, v)[1](do)
    )(*(jnp.asarray(a) for a in (q, k, v, do)))
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    o = flash_attention(tq, tk, tv, causal=causal,
                        kpad_mask=torch.from_numpy(mask) if kpad else None)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, 5e-5, f"d{name}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_plain_attention_bwd_matches_autograd(causal):
    """naive_attention_bwd (the kernels' oracle) against autograd through
    naive_attention, GQA 4/2, ragged lengths, a kpad row with no visible
    key (its gradients are zeros)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_rand(rng, 2, *s, 16)).requires_grad_(True)
               for s in ((4, 21), (2, 21), (2, 21)))
    do = torch.from_numpy(_rand(rng, 2, 4, 21, 16))
    kpad = torch.ones((2, 21), dtype=torch.bool)
    kpad[1, :5] = False  # under causal, rows 0-4 of batch 1 see no key
    kw = dict(causal=causal, scale=0.25, kpad_mask=kpad)
    o, lse = naive.naive_attention(q, k, v, return_lse=True, **kw)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = naive.naive_attention_bwd(q.detach(), k.detach(), v.detach(), o.detach(),
                                    lse.detach(), do, **kw)
    for g, w, name in zip(got, want, "qkv"):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0, msg=f"d{name}")
    if causal:
        assert (got[0][1, :, :5] == 0).all()


@pytest.mark.parametrize("feature", [dict(window=4), dict(softcap=0.5)],
                         ids=["window", "softcap"])
def test_flash_attention_features_have_no_backward(feature):
    """The window and the softcap have a backward now (the name is from
    when a call under grad raised): naive_attention_bwd, the kernels'
    oracle, against autograd through naive_attention, with GQA, ragged
    rows and a feature that binds (window 4 of 21 keys; softcap 0.5 under
    scores of std ~1); flash_attention's gradients on the CPU are the plain
    backward's."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_rand(rng, 2, h, 21, 16)).requires_grad_(True)
               for h in (4, 2, 2))
    do = torch.from_numpy(_rand(rng, 2, 4, 21, 16))
    kw = dict(causal=True, scale=0.25, **feature)
    o, lse = naive.naive_attention(q, k, v, return_lse=True, **kw)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = naive.naive_attention_bwd(q.detach(), k.detach(), v.detach(), o.detach(),
                                    lse.detach(), do, **kw)
    for g, w, name in zip(got, want, "qkv"):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0, msg=f"d{name}")
    without = naive.naive_attention(q, k, v, causal=True, scale=0.25)
    assert (without - o).abs().max().item() > 1e-2  # the feature binds
    out = flash_attention(q, k, v, **kw)
    torch.testing.assert_close(out, o, atol=0, rtol=0)
    for g, w in zip(torch.autograd.grad(out, (q, k, v), do), got):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_plain_rms_norm_and_rope_bwd_match_autograd(offset):
    rng = np.random.default_rng(4)
    x, w = (torch.from_numpy(a).requires_grad_(True) for a in (_rand(rng, 9, 32),
                                                             0.5 + _rand(rng, 32)))
    dy = torch.from_numpy(_rand(rng, 9, 32))
    want = torch.autograd.grad(naive.naive_rms_norm(x, w, eps=1e-5, offset=offset), (x, w), dy)
    _, rstd = naive.naive_rms_norm_fwd(x.detach(), w.detach(), eps=1e-5, offset=offset)
    got = naive.naive_rms_norm_bwd(x.detach(), w.detach(), rstd, dy, offset)
    for g, wt in zip(got, want):
        torch.testing.assert_close(g, wt, atol=1e-5, rtol=0)
    q, k = (torch.from_numpy(_rand(rng, 1, h, 6, 16)).requires_grad_(True) for h in (4, 2))
    dq, dk = (torch.from_numpy(_rand(rng, 1, h, 6, 16)) for h in (4, 2))
    cos, sin = RotaryEmbedding(16)(torch.arange(3, 9)[None])
    want = torch.autograd.grad(naive.naive_rope(q, k, cos, sin), (q, k), (dq, dk))
    for g, wt in zip(llama_rope_bwd(dq, dk, cos, sin), want):
        torch.testing.assert_close(g, wt, atol=1e-5, rtol=0)


# the JAX loss's value_and_grad, compiled once for the loss and the loop
# tests (the same config and shapes)
_J_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(j_loss_fn), static_argnums=3)


def _tiny_jax(seed=0, **kw):
    jcfg = JLlamaConfig.tiny(dtype=jnp.float32, **kw)
    return jcfg, j_init_params(jax.random.key(seed), jcfg)


def _to_port(jp):
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def test_loss_and_grads_match_jax():
    jcfg, jp = _tiny_jax(2)
    rng = np.random.default_rng(5)
    toks, tgts = (rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32) for _ in range(2))
    jloss, jgrads = _J_VALUE_AND_GRAD(jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg)
    params = _to_port(jp)
    loss = loss_fn(params, torch.from_numpy(toks), torch.from_numpy(tgts),
                   LlamaConfig.tiny(dtype=torch.float32))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert abs(loss.item() - float(jloss)) <= 1e-4
    j_leaves = jax.tree.leaves(jgrads)  # sorted dict keys, as tree_leaves
    assert len(j_leaves) == len(grads) == 2 * 9 + 3
    for i, (g, jg) in enumerate(zip(grads, j_leaves)):
        _close(g, jg, 1e-4, f"leaf {i}")


def _adam_trees(rng):
    shapes = {"a": (7, 5), "b": [(3,), (4, 2)]}
    p = {"a": _rand(rng, *shapes["a"]), "b": [_rand(rng, *s) for s in shapes["b"]]}
    gs = [{"a": _rand(rng, *shapes["a"]), "b": [_rand(rng, *s) for s in shapes["b"]]}
          for _ in range(2)]
    return p, gs


@pytest.mark.parametrize("kind", ["plain", "clip", "schedule", "bf16"])
def test_adamw_matches_jax(kind):
    """Two updates with identical gradients (the second exercises the bias
    corrections past step 1); with clip_norm, or with the cosine warmup
    schedule and weight decay, or on bf16 params and gradients (the
    training cell's leaves) with weight decay and clip_norm (the clip scale
    applied in f32, as JAX promotes it): there each param within one bf16
    ulp of the JAX update's, the f32 moments within 1e-6."""
    rng = np.random.default_rng(6)
    p, gs = _adam_trees(rng)
    kw = {"plain": dict(lr=1e-2),
          "clip": dict(lr=1e-2, clip_norm=0.5),
          "schedule": dict(wd=0.1),
          "bf16": dict(lr=1e-2, wd=0.1, clip_norm=0.5)}[kind]
    if kind == "schedule":
        jopt = JAdamW(lr=j_cosine(1e-2, 1, 4, 1e-3), **kw)
        opt = AdamW(lr=cosine_warmup_schedule(1e-2, 1, 4, 1e-3), **kw)
        for step in range(6):
            assert abs(opt.lr(step) - float(jopt.lr(step))) <= 1e-9
    else:
        jopt, opt = JAdamW(**kw), AdamW(**kw)
    jdt, dt = (jnp.bfloat16, torch.bfloat16) if kind == "bf16" else (jnp.float32, torch.float32)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)
    jstate = jopt.init(jparams)
    params = jax.tree.map(lambda a: torch.from_numpy(a).to(dt), p)
    state = opt.init(params)
    update = jax.jit(jopt.update)
    for g in gs:
        jparams, jstate = update(jax.tree.map(lambda a: jnp.asarray(a, jdt), g), jstate, jparams)
        params, state = opt.update(jax.tree.map(lambda a: torch.from_numpy(a).to(dt), g), state,
                                   params)
    assert state["count"] == int(jstate["count"]) == 2
    for got, want in zip(tree_leaves(state["mu"]) + tree_leaves(state["nu"]),
                         jax.tree.leaves(jstate["mu"]) + jax.tree.leaves(jstate["nu"])):
        _close(got, want, 1e-6)
    for got, want in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        assert got.dtype == dt
        if kind == "bf16":
            want = torch.from_numpy(np.asarray(want, np.float32)).to(dt)
            ulp = (torch.nextafter(want.abs(), torch.full_like(want, float("inf")))
                   - want.abs()).float()
            assert bool(((got.float() - want.float()).abs() <= ulp).all())
        else:
            _close(got, want, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_jax(dtype):
    """The clip binding (norm ~7 against 0.5) on f32 and on bf16 leaves:
    the norm within 1e-6 of JAX's, each clipped leaf within one ulp of its
    dtype of JAX's (the scale applied in f32, then rounded once)."""
    jdt, dt = getattr(jnp, dtype), getattr(torch, dtype)
    g, _ = _adam_trees(np.random.default_rng(6))
    jclipped, jnorm = j_clip_by_global_norm(jax.tree.map(lambda a: jnp.asarray(a, jdt), g), 0.5)
    clipped, norm = clip_by_global_norm(jax.tree.map(lambda a: torch.from_numpy(a).to(dt), g), 0.5)
    assert abs(norm.item() - float(jnorm)) <= 1e-6 * float(jnorm) and float(jnorm) > 1.0
    for got, want in zip(tree_leaves(clipped), jax.tree.leaves(jclipped)):
        want = torch.from_numpy(np.asarray(want, np.float32)).to(dt)
        ulp = (torch.nextafter(want.abs(), torch.full_like(want, float("inf")))
               - want.abs()).float()
        assert got.dtype == dt and bool(((got.float() - want.float()).abs() <= ulp).all())


def test_dataio_matches_jax():
    rng = np.random.default_rng(7)
    docs = [rng.integers(1, 50, n).tolist() for n in (5, 17, 40, 3, 29)]
    rows = dataio.pack_tokens(docs, seq_len=16)
    np.testing.assert_array_equal(rows, j_dataio.pack_tokens(docs, seq_len=16))
    for seed in (0, 3):
        for (t, g), (jt, jg) in zip(dataio.batches(rows, 2, seed=seed),
                                    j_dataio.batches(rows, 2, seed=seed), strict=True):
            np.testing.assert_array_equal(t, jt)
            np.testing.assert_array_equal(g, jg)
    for got, want in zip(dataio.pack_tokens_segmented(docs, seq_len=16),
                         j_dataio.pack_tokens_segmented(docs, seq_len=16), strict=True):
        np.testing.assert_array_equal(got, want)
    batch = next(dataio.prefetch_to_device(dataio.batches(rows, 2, seed=0), "cpu"))
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.int32 for t in batch)


def test_train_loop_matches_jax():
    """3 steps of cli.train_loop against the JAX CLI's loop (value_and_grad
    of its loss_fn, then AdamW's update; each jitted) from the same params
    on the CLI's synthetic stream."""
    jcfg, jp = _tiny_jax(0)
    seq, batch = 16, 2
    rows = dataio.pack_tokens([[(7 * i + 3) % jcfg.vocab_size for i in range(seq * 64)]],
                              seq_len=seq)
    jopt = JAdamW(lr=1e-3)
    jstate = jopt.init(jp)
    update = jax.jit(jopt.update)
    jlosses = []
    for toks, tgts in j_dataio.batches(rows, batch, seed=0):
        loss, grads = _J_VALUE_AND_GRAD(jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg)
        jp, jstate = update(grads, jstate, jp)
        jlosses.append(float(loss))
        if len(jlosses) == 3:
            break
    params = params_from_numpy(jax.tree.map(np.asarray, _tiny_jax(0)[1]))
    _, state, losses = cli.train_loop(LlamaConfig.tiny(dtype=torch.float32), params, rows,
                                      steps=3, batch=batch, lr=1e-3, device="cpu",
                                      log=lambda s: None)
    assert state["count"] == 3
    np.testing.assert_allclose(losses, jlosses, atol=1e-3, rtol=0)


def test_checkpoint_read_by_jax_and_served(tmp_path, capsys):
    """A port-written checkpoint of trained params: the JAX
    load_checkpoint reads the same values, the port's reads them back bit
    for bit, and `generate --checkpoint` serves them as an Engine on the
    params in memory does."""
    from nnop_tpu_torch.runtime.engine import Engine
    from nnop_tpu_torch.runtime.tokenizer import BPETokenizer

    jcfg, jp = _tiny_jax(1)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    rows = dataio.pack_tokens([list(range(1, 9)) * 20], seq_len=16)
    params, _, _ = cli.train_loop(cfg, _to_port(jp), rows, steps=2, batch=2, lr=1e-2,
                                  device="cpu", log=lambda s: None)
    path = str(tmp_path / "trained.npz")
    save_checkpoint(path, params)
    loaded = j_load_checkpoint(path, jp)
    for got, want in zip(tree_leaves(params), jax.tree.leaves(loaded), strict=True):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    for got, want in zip(tree_leaves(load_checkpoint(path)), tree_leaves(params), strict=True):
        assert torch.equal(got, want.detach())
    bf = {"w": torch.randn(5, 3).to(torch.bfloat16)}
    save_checkpoint(str(tmp_path / "bf16.npz"), bf)
    assert torch.equal(load_checkpoint(str(tmp_path / "bf16.npz"))["w"], bf["w"])

    cli.main(["generate", "--model", "tiny", "--device", "cpu", "--checkpoint", path,
              "--prompt", "abcabc", "--max-new", "6", "--batch", "1"])
    printed = capsys.readouterr().out.splitlines()[0]
    frozen = {k: v.detach() if isinstance(v, torch.Tensor) else
              [{n: t.detach() for n, t in layer.items()} for layer in v]
              for k, v in params.items()}
    eng = Engine(frozen, cfg, max_batch=1, max_seq=cfg.max_seq_len, tokenizer=BPETokenizer([]))
    req = eng.submit_text("abcabc", 6)
    eng.run()
    assert printed == f"[{req.rid}] {req.out}"


def test_train_loop_end_to_end():
    """tests/test_dataio.py::test_train_loop_end_to_end on the port: a
    tiny LM overfits a repeating pattern and the loss halves."""
    cfg = LlamaConfig.tiny(dtype=torch.float32, n_layers=1, vocab_size=32)
    gen = torch.Generator()
    gen.manual_seed(0)
    rows = dataio.pack_tokens([list(range(8)) * 200], seq_len=32)
    n_steps = 6 * (rows.shape[0] // 4)  # six epochs, as the JAX test runs
    _, _, losses = cli.train_loop(cfg, init_params(gen, cfg), rows, steps=n_steps, batch=4,
                                  lr=3e-3, device="cpu", log=lambda s: None)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
