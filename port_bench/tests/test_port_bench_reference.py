"""The plain reference at a tiny size on the CPU: its attention gradient
against autograd through a dense masked softmax, and its forward, loss and
gradients against the program's plain f32 path on the same weights."""

from __future__ import annotations

import math

import pytest
import torch

import tiny
from pbench import weights as W
from reference import model as ref

SEED = 2**33 + 5


def _dense_attention(q, k, v, window):
    L = q.shape[2]
    rep = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    i = torch.arange(L)[:, None]
    j = torch.arange(L)[None]
    m = (j <= i) & ((i - j < window) if window else True)
    return torch.softmax(s.masked_fill(~m, -math.inf), -1) @ v


@pytest.mark.parametrize("window", [None, 5])
def test_attention_and_its_gradient(window, monkeypatch):
    monkeypatch.setattr(ref, "ATTN_BLOCK", 4)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, dtype=torch.float64, requires_grad=True)
               for s in ((1, 4, 11, 8), (1, 2, 11, 8), (1, 2, 11, 8)))
    do = torch.randn(1, 4, 11, 8, generator=g, dtype=torch.float64)
    got = ref.attention(q, k, v, window)
    want = _dense_attention(q, k, v, window)
    assert torch.allclose(got, want, atol=1e-12)
    a = torch.autograd.grad(got, (q, k, v), do)
    b = torch.autograd.grad(want, (q, k, v), do)
    for x, y in zip(a, b):
        assert torch.allclose(x, y, atol=1e-10)


def _program_params(cfg, seed):
    tree = W.make_model(cfg, seed, "cpu")
    return {"embed": tree["embed"].float(), "final_norm": tree["final_norm"].float(),
            "lm_head": tree["lm_head"].float(),
            "layers": [{k: v.float() for k, v in layer.items()} for layer in tree["layers"]]}


def test_loss_and_gradients_against_the_programs_plain_path():
    from drivers._program import port_config
    from nnop_tpu_torch.models.llama import loss_fn

    cfg = tiny.cell("mistral-7b.train-l8192").config
    pcfg = port_config(cfg, max_seq=64, dtype=torch.float32)
    params = _program_params(cfg, SEED)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg["vocab_size"], (2, 40), generator=g)
    tgts = torch.randint(0, cfg["vocab_size"], (2, 40), generator=g)
    flat = W.flatten(params)
    names = sorted(flat)
    for t in flat.values():
        t.requires_grad_(True)
    want = loss_fn(params, toks, tgts, pcfg, plain=True)
    gw = torch.autograd.grad(want, [flat[n] for n in names])
    mine = {n: t.detach().clone().requires_grad_(True) for n, t in flat.items()}
    got = ref.loss_fn(mine, toks, tgts, cfg)
    gg = torch.autograd.grad(got, [mine[n] for n in names])
    assert got.item() == pytest.approx(want.item(), abs=1e-5)
    for n, a, b in zip(names, gg, gw):
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-4), n


def test_first_token_logits_against_the_programs_plain_path():
    from drivers._program import port_config
    from nnop_tpu_torch.models.llama import forward

    cfg = tiny.cell("mistral-7b.prefill-longdoc").config
    pcfg = port_config(cfg, max_seq=128, dtype=torch.float32)
    params = _program_params(cfg, SEED)
    prompts = [[5, 9, 200, 3] * 9, list(range(1, 31))]
    got = ref.last_logits(cfg, SEED, prompts, torch.device("cpu"))
    for p, row in zip(prompts, got):
        want = forward(params, torch.tensor([p]), pcfg, plain=True)[0, -1]
        assert torch.allclose(row, want, atol=1e-4, rtol=1e-4)


def test_train_steps_follow_adamw():
    cfg = tiny.cell("mistral-7b.train-l8192").config
    g = torch.Generator().manual_seed(2)
    batches = [(torch.randint(0, 256, (1, 16), generator=g),
                torch.randint(0, 256, (1, 16), generator=g)) for _ in range(2)]
    losses, grad1, change = ref.train_steps(cfg, SEED, batches, 1e-3, torch.device("cpu"))
    names = set(W.flatten(W.make_model(cfg, SEED, "cpu")))
    assert len(losses) == 2 and set(grad1) == set(change) == names
    # after one AdamW step each element of the head moves by lr (times the
    # sign of its gradient), then rounds to bf16
    _, _, one = ref.train_steps(cfg, SEED, batches[:1], 1e-2, torch.device("cpu"))
    n = W.make_head(cfg, SEED, "cpu").numel()
    assert one["lm_head"] == pytest.approx(1e-2 * math.sqrt(n), rel=0.2)
