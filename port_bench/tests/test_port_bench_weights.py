"""The seeded weights: a dense model draws the bits it always has, and a
routed layer has the program's expert leaves, made again alone bit for
bit."""

from __future__ import annotations

import hashlib

import pytest
import torch

import tiny
from pbench import weights as W

SEED = 2**31 + 7
# sha256 of the tiny dense model's leaves (name, then bf16 bits, in
# flatten's order) as the weights were drawn before routed experts came
DENSE = "20386423c2c8c0a7282c3b7ce50cc5d182eaeef7b9976a63b6ded1b47f7ab992"


def _digest(leaves):
    h = hashlib.sha256()
    for name, t in leaves:
        h.update(name.encode())
        h.update(t.view(torch.int16).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("cell", ["mistral-7b.train-l8192", "mistral-7b.prefill-longdoc"])
def test_dense_weights_draw_the_same_bits(cell):
    cfg = tiny.cell(cell).config
    assert _digest(W.flatten(W.make_model(cfg, SEED, "cpu")).items()) == DENSE
    assert _digest(W.leaves(cfg, SEED, "cpu")) == DENSE


def test_routed_layers_have_the_programs_expert_leaves():
    from drivers._program import port_config
    from nnop_tpu_torch.models.moe import init_moe_layer

    cfg = tiny.cell("mistral-7b.train-l8192", experts=(4, 2)).config
    d, F = cfg["hidden_size"], cfg["intermediate_size"]
    layer = W.make_layer(cfg, SEED, 1, "cpu")
    program = init_moe_layer(port_config(cfg, max_seq=64), lambda s: torch.zeros(s))
    for name, t in program.items():
        assert layer[name].shape == t.shape and layer[name].dtype == torch.bfloat16, name
    assert set(layer) == {"attn_norm", "wq", "wk", "wv", "wo", "mlp_norm"} | set(program)
    for name, fan_in in (("w_router", d), ("w_gate", d), ("w_up", d), ("w_down", F)):
        assert layer[name].float().std().item() == pytest.approx(fan_in ** -0.5, rel=0.1)
    # every expert its own draw, every leaf made again alone the same
    assert not torch.equal(layer["w_gate"][0], layer["w_gate"][1])
    assert not torch.equal(layer["w_gate"], layer["w_up"])
    again = dict(W.layer_leaves(cfg, SEED, 1, "cpu"))
    assert all(torch.equal(again[n], t) for n, t in layer.items())
    assert not torch.equal(W.make_layer(cfg, SEED, 0, "cpu")["w_down"], layer["w_down"])
    flat = W.flatten(W.make_model(cfg, SEED, "cpu"))
    leaves = list(W.leaves(cfg, SEED, "cpu"))
    assert [n for n, _ in leaves] == list(flat)
    assert all(torch.equal(flat[n], t) for n, t in leaves)
