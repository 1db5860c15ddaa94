"""The plain reference at a tiny size on the CPU: its attention gradient
against autograd through a dense masked softmax, and its forward, loss and
gradients against the program's plain f32 path on the same weights; its
routed layer against a per-token oracle in f64, and, with the program's
routing replayed, against the program's plain grouped path."""

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


def _moe_cfg():
    return tiny.cell("mistral-7b.train-l8192", experts=(4, 2)).config


def _oracle(x, lw, cfg, route=None):
    """Mixtral's routed SwiGLU one token at a time."""
    k = cfg["num_experts_per_tok"]
    h = ref.rms_norm(x, lw["mlp_norm"], cfg["rms_norm_eps"])[0]
    out = torch.zeros_like(h)
    for t in range(h.shape[0]):
        r = h[t] @ lw["w_router"]
        idx = r.topk(k).indices if route is None else route[t].long()
        w = torch.softmax(r[idx], -1)
        for j, e in enumerate(idx.tolist()):
            g = torch.nn.functional.silu(h[t] @ lw["w_gate"][e]) * (h[t] @ lw["w_up"][e])
            out[t] += w[j] * (g @ lw["w_down"][e])
    return x + out[None]


@pytest.mark.parametrize("given", [False, True])
def test_routed_layer_against_a_per_token_oracle(given):
    cfg = _moe_cfg()
    lw = {n: t.double() for n, t in W.make_layer(cfg, SEED, 0, "cpu").items()}
    x = torch.randn(1, 13, cfg["hidden_size"], generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    g = torch.Generator().manual_seed(4)
    route = torch.stack([torch.randperm(4, generator=g)[:2] for _ in range(13)]) if given else None
    routing = ref.Routing()
    got, aux = ref.moe_block(x, lw, cfg, route=route, routing=routing, key=(0, 0))
    assert torch.allclose(got, _oracle(x, lw, cfg, route), atol=1e-12, rtol=1e-12)
    assert aux.item() > 0
    if given:
        assert routing.chosen[(0, 0)].long().equal(route)
    else:
        assert routing.flips == 0 and routing.margin == 0.0


def test_routing_margin_by_hand():
    # logits of 2 tokens over 4 experts; the reference's own top 2 are
    # {0, 1} and {2, 3}; the given choices take expert 2 for token 0 (1.5
    # below its 2nd logit) and agree for token 1
    logits = torch.tensor([[3.0, 2.0, 0.5, 0.0], [0.0, 1.0, 4.0, 2.0]])
    routing = ref.Routing()
    routing.note((0, 0), logits, logits.topk(2, -1), torch.tensor([[0, 2], [3, 2]]))
    assert routing.margin == 1.5 and routing.flips == 1 and routing.assignments == 4


def test_routed_loss_and_gradients_against_the_programs_grouped_path():
    from drivers._program import Patch, port_config, record_routes
    from nnop_tpu_torch.models.llama import loss_fn

    cfg = _moe_cfg()
    pcfg = port_config(cfg, max_seq=64, dtype=torch.float32)
    assert (pcfg.n_experts, pcfg.n_experts_per_token, pcfg.moe_impl) == (4, 2, "grouped")
    assert pcfg.router_aux_coef == 0.02
    params = _program_params(cfg, SEED)
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg["vocab_size"], (2, 40), generator=g)
    tgts = torch.randint(0, cfg["vocab_size"], (2, 40), generator=g)
    flat = W.flatten(params)
    names = sorted(flat)
    for t in flat.values():
        t.requires_grad_(True)
    routes = []
    with Patch() as patch:
        record_routes(patch, routes.append)
        want = loss_fn(params, toks, tgts, pcfg, plain=True)
    gw = torch.autograd.grad(want, [flat[n] for n in names])
    assert [r.shape for r in routes] == [(80, 2)] * cfg["num_hidden_layers"]
    mine = {n: t.detach().clone().requires_grad_(True) for n, t in flat.items()}
    routing = ref.Routing()
    got = ref.loss_fn(mine, toks, tgts, cfg, route=routes, routing=routing)
    gg = torch.autograd.grad(got, [mine[n] for n in names])
    assert got.item() == pytest.approx(want.item(), abs=1e-5)
    for n, a, b in zip(names, gg, gw):
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-4), n
    assert routing.margin < 1e-4  # the same f32 router on both sides


def test_int8_weights_are_the_programs_quantized_values():
    from nnop_tpu_torch.ops.quantization import dequantize, quantize

    cfg = _moe_cfg()
    layer = W.make_layer(cfg, SEED, 1, "cpu")
    for name in ("wq", "wo", "w_gate", "w_down"):
        w = layer[name]
        q = quantize(w, axis=w.ndim - 2)  # the program's per-channel rule (experts: axis 1)
        assert torch.equal(ref.int8_weight(w), dequantize(q)), name
    int8 = dict(cfg, weights="int8")
    assert torch.equal(ref.stored(int8, "w_router", layer["w_router"]),
                       layer["w_router"].float())
