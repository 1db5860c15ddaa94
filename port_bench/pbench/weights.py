"""Model weights made from the seed, on the device, one layer at a time.

Both sides of the comparison take their weights from here: the program
gets them as its tree of tensors (the drivers do that), and the plain
reference makes the same tensors again, layer by layer, once the
program's state is freed. Each layer, and the embedding, the head and the
final norm, has a generator seeded from (seed, its tag), so any one of
them can be made again alone, bit for bit, on the same device.

Every leaf is bf16, as the configurations store their weights.
Projections are N(0, 1/fan_in); the embedding N(0, 0.02^2); norm weights
1 + N(0, 0.1^2).

A layer with routed experts (the configuration's `num_local_experts`)
has the leaves of the program's models/moe.py:init_moe_layer: the router
w_router (d, E) beside the attention's leaves, in their one draw, and the
stacked experts w_gate, w_up (E, d, F) and w_down (E, F, d), each from a
generator of its own, drawn one expert at a time, so that making a layer
of Mixtral-8x7B's width (1.45 B values) never holds more than one
expert's slab in float32. A dense layer draws as it always has."""

from __future__ import annotations

import hashlib

import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit generator seed from the run's seed and a tag."""
    h = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def _gen(seed, tag, device):
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, tag))
    return g


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def n_experts(cfg: dict) -> int | None:
    """The routed experts of each layer, or None for a dense MLP."""
    return cfg.get("num_local_experts")


def layer_specs(cfg: dict):
    """(name, shape, fan_in or None for a norm) of the leaves of a layer's
    one draw, in the order they are drawn."""
    d, F = cfg["hidden_size"], cfg["intermediate_size"]
    H, KH, E = cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg)
    attn = [("attn_norm", (d,), None), ("wq", (d, H * E), d), ("wk", (d, KH * E), d),
            ("wv", (d, KH * E), d), ("wo", (H * E, d), H * E), ("mlp_norm", (d,), None)]
    if n_experts(cfg):
        return attn + [("w_router", (d, n_experts(cfg)), d)]
    return attn + [("w_gate", (d, F), d), ("w_up", (d, F), d), ("w_down", (F, d), F)]


def expert_specs(cfg: dict):
    """(name, shape, fan_in) of a layer's stacked experts; none for a dense
    layer."""
    if not n_experts(cfg):
        return []
    d, F, X = cfg["hidden_size"], cfg["intermediate_size"], n_experts(cfg)
    return [("w_gate", (X, d, F), d), ("w_up", (X, d, F), d), ("w_down", (X, F, d), F)]


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def _floats(specs, g, device):
    """One draw for all of `specs`, cut into the bf16 leaves."""
    flat = torch.randn(sum(_numel(s) for _, s, _ in specs), generator=g, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape, fan_in in specs:
        x = flat[at:at + _numel(shape)].view(shape)
        at += _numel(shape)
        out[name] = (x * 0.1 + 1.0 if fan_in is None else x * fan_in ** -0.5).to(torch.bfloat16)
    return out


def _experts(seed, tag, shape, fan_in, device):
    """One stacked expert leaf from its own generator, an expert at a time."""
    g = _gen(seed, tag, device)
    out = torch.empty(shape, dtype=torch.bfloat16, device=device)
    for e in range(shape[0]):
        x = torch.randn(shape[1:], generator=g, device=device, dtype=torch.float32)
        out[e] = (x * fan_in ** -0.5).to(torch.bfloat16)
    return out


def layer_leaves(cfg: dict, seed: int, i: int, device):
    """Layer i's leaves one at a time: (name, bf16 tensor)."""
    yield from _floats(layer_specs(cfg), _gen(seed, f"layer{i}", device), device).items()
    for name, shape, fan_in in expert_specs(cfg):
        yield name, _experts(seed, f"layer{i}.{name}", shape, fan_in, device)


def make_layer(cfg: dict, seed: int, i: int, device):
    """Layer i's leaves: {name: bf16 tensor}."""
    return dict(layer_leaves(cfg, seed, i, device))


def make_embed(cfg: dict, seed: int, device):
    g = _gen(seed, "embed", device)
    V, d = cfg["vocab_size"], cfg["hidden_size"]
    return (torch.randn((V, d), generator=g, device=device) * 0.02).to(torch.bfloat16)


def make_final_norm(cfg: dict, seed: int, device):
    g = _gen(seed, "final_norm", device)
    d = cfg["hidden_size"]
    return (torch.randn((d,), generator=g, device=device) * 0.1 + 1.0).to(torch.bfloat16)


def make_head(cfg: dict, seed: int, device):
    g = _gen(seed, "head", device)
    spec = [("lm_head", (cfg["hidden_size"], cfg["vocab_size"]), cfg["hidden_size"])]
    return _floats(spec, g, device)["lm_head"]


def make_model(cfg: dict, seed: int, device):
    """The whole tree, in the layout the program takes: {"embed",
    "layers": [...], "final_norm", "lm_head"}."""
    return {
        "embed": make_embed(cfg, seed, device),
        "layers": [make_layer(cfg, seed, i, device) for i in range(cfg["num_hidden_layers"])],
        "final_norm": make_final_norm(cfg, seed, device),
        "lm_head": make_head(cfg, seed, device),
    }


def leaves(cfg: dict, seed: int, device):
    """Every leaf of the model one at a time, (flat name, bf16 tensor), in
    flatten's order: no more than one leaf is made at once."""
    yield "embed", make_embed(cfg, seed, device)
    yield "final_norm", make_final_norm(cfg, seed, device)
    yield "lm_head", make_head(cfg, seed, device)
    for i in range(cfg["num_hidden_layers"]):
        for name, t in layer_leaves(cfg, seed, i, device):
            yield f"layers.{i}.{name}", t


def flatten(tree) -> dict:
    """{name: leaf} of a tree in make_model's layout."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return out
