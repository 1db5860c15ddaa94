"""The program's side of the harness: its configuration built from the
benchmark's files, and attributes patched for the length of a run."""

from __future__ import annotations

import torch

from pbench import weights as W


def port_config(cfg: dict, *, max_seq: int, dtype=torch.bfloat16):
    """The program's LlamaConfig for a configuration file (HF keys)."""
    from nnop_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=cfg["vocab_size"], dim=cfg["hidden_size"],
                       n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
                       n_kv_heads=cfg["num_key_value_heads"], head_dim=W.head_dim(cfg),
                       hidden_dim=cfg["intermediate_size"], rope_base=float(cfg["rope_theta"]),
                       rms_eps=float(cfg["rms_norm_eps"]), max_seq_len=max_seq, dtype=dtype,
                       sliding_window=cfg.get("sliding_window"))


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
