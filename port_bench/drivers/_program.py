"""The program's side of the harness: its configuration and weights built
from the benchmark's files, the record of its expert choices, and
attributes patched for the length of a run."""

from __future__ import annotations

import torch

from pbench import weights as W

# the configuration's "weights" key -> the program's quantize_params(wbits=)
WBITS = {"int8": 8, "int4": 4}


def port_config(cfg: dict, *, max_seq: int, dtype=torch.bfloat16):
    """The program's LlamaConfig for a configuration file (HF keys). A
    configuration with routed experts gives their count, the experts a
    token takes and the router's aux coefficient, and may name the
    program's expert path (`moe_impl`); without it the program's default
    holds."""
    from nnop_tpu_torch.models.llama import LlamaConfig

    moe = {}
    if W.n_experts(cfg):
        moe = dict(n_experts=cfg["num_local_experts"],
                   n_experts_per_token=cfg["num_experts_per_tok"],
                   router_aux_coef=float(cfg["router_aux_loss_coef"]))
        if "moe_impl" in cfg:
            moe["moe_impl"] = cfg["moe_impl"]
    return LlamaConfig(vocab_size=cfg["vocab_size"], dim=cfg["hidden_size"],
                       n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
                       n_kv_heads=cfg["num_key_value_heads"], head_dim=W.head_dim(cfg),
                       hidden_dim=cfg["intermediate_size"], rope_base=float(cfg["rope_theta"]),
                       rms_eps=float(cfg["rms_norm_eps"]), max_seq_len=max_seq, dtype=dtype,
                       sliding_window=cfg.get("sliding_window"), **moe)


def program_params(cfg: dict, seed: int, device, weights: str | None = None):
    """The program's tree of the seed's weights; with `weights` ("int8",
    "int4") quantized by the program's own quantize_params a layer at a
    time, so that a model stored in int8 never exists whole in bf16."""
    if weights is None:
        return W.make_model(cfg, seed, device)
    from nnop_tpu_torch.models.quantized import quantize_params

    def q(tree):
        return quantize_params(tree, wbits=WBITS[weights])

    return {
        "embed": W.make_embed(cfg, seed, device),
        "layers": [q({"layers": [W.make_layer(cfg, seed, i, device)]})["layers"][0]
                   for i in range(cfg["num_hidden_layers"])],
        "final_norm": W.make_final_norm(cfg, seed, device),
        "lm_head": q({"lm_head": W.make_head(cfg, seed, device), "layers": []})["lm_head"],
    }


def record_routes(patch, keep, plant: str = "none"):
    """Wrap the program's router (models/moe.py:router_topk) so that each
    call hands its chosen experts, (tokens, k) int64 on the device, to
    keep(idx); nothing is read back to the host. With plant "route" the
    program takes its lowest-logit expert in place of its second choice
    for every fourth token, its weights the softmax of its logits there."""
    from nnop_tpu_torch.models import moe

    orig = moe.router_topk

    def router_topk(h, w_router, k):
        w, idx, probs = orig(h, w_router, k)
        if plant == "route":
            logits = h.float() @ w_router.float()
            idx = idx.clone()
            idx[::4, 1] = logits[::4].argmin(dim=-1)
            w = torch.softmax(logits.gather(1, idx), dim=-1)
        keep(idx)
        return w, idx, probs

    patch.set(moe, "router_topk", router_topk)


class Patch:
    """Set attributes for the length of a `with` block."""

    def __init__(self):
        self._undo = []

    def set(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for obj, name, old in reversed(self._undo):
            setattr(obj, name, old)
        self._undo.clear()
