"""The Hopper kernels against their plain versions, on the card.

Every test carries the `gpu` marker and skips where CUDA is unavailable
(the kernels cannot run on a CPU). This file imports no JAX, so it runs
on the card's machine:

    NNOP_TEST_TPU=1 python -m pytest tests/test_torch_kernels.py -q

(NNOP_TEST_TPU=1 keeps the root conftest from importing JAX.) Tolerance:
2e-2 absolute for bf16 outputs (one bf16 ulp below magnitude 4 is
<= 1.6e-2, and both sides accumulate in fp32 in another order); the
flush is a copy and must be bit-exact.
"""

import pytest
import torch

from nnop_tpu_torch.ops import naive
from nnop_tpu_torch.ops.attention_decode import decode_attention
from nnop_tpu_torch.ops.flash_attention import flash_fwd
from nnop_tpu_torch.ops.kv_write import flush_staging
from nnop_tpu_torch.ops.rms_norm import rms_norm
from nnop_tpu_torch.ops.rope import RotaryEmbedding, llama_rope

pytestmark = pytest.mark.gpu
TOL = dict(atol=2e-2, rtol=0)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100): the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _bf(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(torch.bfloat16)


def test_rms_norm_kernel(gen):
    x, w = _bf(gen, 64, 4096), _bf(gen, 4096, scale=0.1) + 0.5
    before = rms_norm.launches
    got = rms_norm(x, w, 1e-5, offset=1.0)
    assert rms_norm.launches == before + 1
    torch.testing.assert_close(got, naive.naive_rms_norm(x, w, eps=1e-5, offset=1.0), **TOL)


def test_rope_kernel(gen):
    q, k = _bf(gen, 2, 32, 9, 128, scale=0.5), _bf(gen, 2, 8, 9, 128, scale=0.5)
    cos, sin = RotaryEmbedding(128, 500000.0)(torch.arange(18, device="cuda").view(2, 9))
    for got, want in zip(llama_rope(q, k, cos, sin), naive.naive_rope(q, k, cos, sin)):
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("causal,offset", [(True, 0), (True, 70), (False, 0)])
def test_flash_kernel(gen, causal, offset):
    q, k, v = _bf(gen, 1, 32, 100, 128), _bf(gen, 1, 8, 200, 128), _bf(gen, 1, 8, 200, 128)
    kpad = (torch.arange(200, device="cuda") < 170)[None]
    kw = dict(causal=causal, scale=128 ** -0.5, causal_offset=offset, kpad_mask=kpad)
    for got, want in zip(flash_fwd(q, k, v, **kw),
                         naive.naive_attention(q, k, v, return_lse=True, **kw)):
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_decode_kernel(gen, dtype):
    """The cache (and q) in bf16, as served, or f32; staging is bf16."""
    kc, vc = _bf(gen, 2, 4, 8, 256, 128).to(dtype), _bf(gen, 2, 4, 8, 256, 128).to(dtype)
    ks, vs = _bf(gen, 4, 2, 8, 32, 128), _bf(gen, 4, 2, 8, 32, 128)
    lengths = torch.tensor([0, 1, 65, 200], dtype=torch.int32, device="cuda")
    q = _bf(gen, 4, 32, 1, 128).to(dtype)
    kw = dict(k_stage=ks, v_stage=vs, staged_n=7, layer=1)
    got = decode_attention(q, kc, vc, lengths, **kw)
    assert got.dtype == dtype and (got[0] == 0).all()  # the empty slot
    torch.testing.assert_close(got, naive.naive_decode_attention(q, kc, vc, lengths, **kw), **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flush_kernel(gen, dtype):
    kc, vc = _bf(gen, 2, 4, 8, 256, 128).to(dtype), _bf(gen, 2, 4, 8, 256, 128).to(dtype)
    ks, vs = _bf(gen, 4, 2, 8, 32, 128), _bf(gen, 4, 2, 8, 32, 128)
    lengths = torch.tensor([0, 1, 65, 200], dtype=torch.int32, device="cuda")
    kc2, vc2 = kc.clone(), vc.clone()
    flush_staging(kc2, vc2, None, None, ks, vs, lengths)
    naive.naive_flush_staging(kc, vc, ks, vs, lengths)
    torch.cuda.synchronize()
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
