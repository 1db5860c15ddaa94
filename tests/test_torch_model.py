"""The port's model (nnop_tpu_torch.models) against the JAX package's on
the CPU: parameter trees cross between the packages as numpy, and the
tiny config's float32 logits agree within 1e-4 (two layers of float32
products summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnop_tpu.models.llama import LlamaConfig as JLlamaConfig
from nnop_tpu.models.llama import forward as j_forward
from nnop_tpu.models.llama import init_params as j_init_params
from nnop_tpu.models.weights import save_checkpoint
from nnop_tpu_torch.models.llama import Llama, LlamaConfig, forward, init_params
from nnop_tpu_torch.models.weights import load_checkpoint, params_from_numpy


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from ((f"{k}/{p}", v) for p, v in _leaves(tree[k]))
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from ((f"{i}/{p}", v) for p, v in _leaves(x))
    else:
        yield "", tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_round_trip(dtype):
    jp = j_init_params(jax.random.key(0), JLlamaConfig.tiny(dtype=getattr(jnp, dtype)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    j_leaves, t_leaves = list(_leaves(jp)), list(_leaves(tp))
    assert [p for p, _ in j_leaves] == [p for p, _ in t_leaves]
    for (_, j), (_, t) in zip(j_leaves, t_leaves):
        assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == j.shape
        # bit-exact: the values come back as the same f32 numbers
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


def test_load_checkpoint_npz(tmp_path):
    jp = j_init_params(jax.random.key(1), JLlamaConfig.tiny(dtype=jnp.bfloat16))
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, jp)
    tp = load_checkpoint(path)
    assert len(tp["layers"]) == 2
    for (pj, j), (pt, t) in zip(_leaves(jp), _leaves(tp)):
        assert pj == pt and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


def test_init_params_matches_the_jax_tree():
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(3)
    g2.manual_seed(3)
    tp, tp2 = init_params(g1, cfg), init_params(g2, cfg)
    jp = j_init_params(jax.random.key(3), JLlamaConfig.tiny(dtype=jnp.float32))
    assert [(p, j.shape) for p, j in _leaves(jp)] == [(p, tuple(t.shape)) for p, t in _leaves(tp)]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_leaves(tp), _leaves(tp2)))
    assert abs(tp["layers"][0]["wq"].std().item() - cfg.dim ** -0.5) < 0.01


def test_tiny_logits_match_jax():
    jcfg = JLlamaConfig.tiny(dtype=jnp.float32)
    jp = j_init_params(jax.random.key(2), jcfg)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 19)).astype(np.int32)
    want = jax.jit(j_forward, static_argnums=2)(jp, jnp.asarray(tokens), jcfg)
    model = Llama(LlamaConfig.tiny(dtype=torch.float32),
                  params_from_numpy(jax.tree.map(np.asarray, jp)))
    got = model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and got.shape == (2, 19, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    # the plain-op path is the same computation on the CPU
    torch.testing.assert_close(model(torch.from_numpy(tokens).long(), plain=True), got)
    assert not model.training
    assert all(not p.requires_grad for p in model.parameters())
    assert forward(model.params, torch.from_numpy(tokens).long(), model.cfg).shape == got.shape
