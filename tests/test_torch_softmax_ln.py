"""The port's online_softmax and layer_norm against the JAX package on
the CPU, and the port's public names.

The same numpy inputs (from a seed) go through the JAX function — its
Pallas kernels in interpret mode, as the root conftest arranges — and
through the port's plain path. Tolerances, each with its reason:
- 1e-6 for softmax in f32, forward and gradient (the same f32 exp and
  row sums, taken in another order), as tests/test_softmax.py holds the
  JAX op; bf16 outputs to one bf16 ulp of the value (2^-8 relative);
- 1e-5 for layer norm and its gradients in f32 (two row reductions in
  another order), as tests/test_layer_norm.py; bf16 to one bf16 ulp.
The Triton kernels themselves are held to these plain versions on the
card by tests/test_torch_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnop_tpu
import nnop_tpu_torch
from nnop_tpu import layer_norm as j_layer_norm
from nnop_tpu import online_softmax as j_online_softmax
from nnop_tpu_torch.ops import naive
from nnop_tpu_torch.ops.layer_norm import layer_norm
from nnop_tpu_torch.ops.softmax import online_softmax


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


def test_public_names_cover_jax():
    assert set(nnop_tpu.__all__) <= set(nnop_tpu_torch.__all__)
    assert all(hasattr(nnop_tpu_torch, name) for name in nnop_tpu_torch.__all__)


# ---- online_softmax ---------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 33), (4, 256), (4, 513), (2, 5, 128)],
                         ids=["33", "256", "513", "3d"])
def test_softmax_matches_jax(shape):
    x = _rand(np.random.default_rng(0), *shape)
    _close(online_softmax(torch.from_numpy(x)), j_online_softmax(jnp.asarray(x)), 1e-6)


def test_softmax_bf16_and_a_row_of_minus_inf_match_jax():
    """bf16 in and out (one bf16 ulp: both round the same f32 value, which
    may differ in its last f32 bits); a row of -inf gives what the JAX op
    gives (its guard turns the max to 0, so 0 / 0: NaN), beside finite rows."""
    rng = np.random.default_rng(1)
    x = _rand(rng, 6, 256)
    got = online_softmax(torch.from_numpy(x).to(torch.bfloat16))
    want = np.asarray(j_online_softmax(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=0)
    x[2] = -np.inf
    got = online_softmax(torch.from_numpy(x)).numpy()
    want = np.asarray(j_online_softmax(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2]).all() and np.isfinite(np.delete(got, 2, axis=0)).all()
    np.testing.assert_allclose(np.delete(got, 2, axis=0), np.delete(want, 2, axis=0),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("seq", [33, 256, 513])
def test_softmax_grad_matches_jax(seq):
    """The gradient of sum(softmax(x) * cos x), as tests/test_softmax.py."""
    x = _rand(np.random.default_rng(2), 4, seq)
    want = jax.jit(jax.grad(lambda a: jnp.sum(j_online_softmax(a) * jnp.cos(a))))(
        jnp.asarray(x))
    tx = _leaf(x)
    (got,) = torch.autograd.grad((online_softmax(tx) * torch.cos(tx)).sum(), tx)
    _close(got, want, 1e-6)


def test_plain_softmax_bwd_matches_autograd():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_rand(rng, 5, 40)).requires_grad_(True)
    dy = torch.from_numpy(_rand(rng, 5, 40))
    (want,) = torch.autograd.grad(torch.softmax(x, dim=-1), x, dy)
    got = naive.naive_softmax_bwd(naive.naive_softmax(x.detach()), dy)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


# ---- layer_norm -------------------------------------------------------------


@pytest.mark.parametrize("emb,n", [(15, 16), (255, 25), (512, 1), (513, 17)])
def test_layer_norm_and_grads_match_jax(emb, n):
    """Forward and the gradients in x, w and b of sum(y * sin(arange)), as
    tests/test_layer_norm.py."""
    rng = np.random.default_rng(4)
    x, w, b = _rand(rng, n, emb), _rand(rng, emb), _rand(rng, emb)
    ramp = np.sin(np.arange(emb, dtype=np.float32))

    def jloss(x, w, b):
        return jnp.sum(j_layer_norm(x, w, b) * ramp)

    jy = j_layer_norm(*(jnp.asarray(a) for a in (x, w, b)))
    jg = jax.jit(jax.grad(jloss, (0, 1, 2)))(*(jnp.asarray(a) for a in (x, w, b)))
    tx, tw, tb = _leaf(x), _leaf(w), _leaf(b)
    y = layer_norm(tx, tw, tb)
    _close(y, jy, 1e-5, "y")
    got = torch.autograd.grad((y * torch.from_numpy(ramp)).sum(), (tx, tw, tb))
    for g, want, name in zip(got, jg, ("dx", "dw", "db")):
        _close(g, want, 1e-5, name)
    with torch.no_grad():
        _close(layer_norm(tx, tw, tb), jy, 1e-5, "y without grad")


def test_layer_norm_bf16_matches_jax():
    """bf16 x, w and b: f32 math, y rounded to bf16 (one bf16 ulp), and
    the gradients of w and b back in bf16."""
    rng = np.random.default_rng(5)
    x, w, b, dy = _rand(rng, 9, 96), _rand(rng, 96), _rand(rng, 96), _rand(rng, 9, 96)
    jx, jw, jb, jdy = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b, dy))
    jy, vjp = jax.vjp(j_layer_norm, jx, jw, jb)
    jg = vjp(jdy)
    tx, tw, tb = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
                  for a in (x, w, b))
    y = layer_norm(tx, tw, tb)
    got = torch.autograd.grad(y, (tx, tw, tb), torch.from_numpy(dy).to(torch.bfloat16))
    for g, want, name in zip((y, *got), (jy, *jg), ("y", "dx", "dw", "db")):
        assert g.dtype == torch.bfloat16, name
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(g.detach().float().numpy(), want,
                                   rtol=2 ** -8, atol=1e-6 * np.abs(want).max(), err_msg=name)
