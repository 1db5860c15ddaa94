"""The single-device parts of nnop_tpu/parallel/tp_llama.py: AdamW, global
gradient-norm clipping and the cosine warmup schedule.

Parameter and gradient trees are the JAX package's (dicts and lists of
tensors). The update runs leaf by leaf and in place
(`ops/adamw.py:adamw_update_`: one kernel launch a CUDA leaf, the plain
eager update on the CPU); the JAX package returns new trees instead. The
sharded train step waits for the port of the mesh (torch.distributed).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nnop_tpu_torch.ops.adamw import adamw_update_, clip_scaled


def tree_leaves(tree) -> list:
    """The leaves of a params-like tree, in the order the JAX package's
    tree functions visit them (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2), in f32 (a 0-d tensor)."""
    leaves = tree_leaves(grads)
    sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        sq = sq + torch.sum(torch.square(g.float()))
    return torch.sqrt(sq)


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """Scale grads so their global L2 norm is at most max_norm
    (tp_llama.py:419-434). Returns (clipped grads, global norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: clip_scaled(g, scale), grads), norm


def cosine_warmup_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                           min_lr: float = 0.0):
    """step -> lr: linear warmup, then cosine decay to min_lr
    (tp_llama.py:437-452)."""

    def lr(step):
        step = float(step)
        if step < warmup_steps:
            return base_lr * step / max(1.0, float(warmup_steps))
        t = (step - warmup_steps) / max(1.0, float(total_steps - warmup_steps))
        t = min(max(t, 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(math.pi * t))

    return lr


class AdamW:
    """AdamW with the JAX package's state tree {"mu", "nu", "count"}
    (tp_llama.py:242-286): f32 moments shaped like the params, `count`
    the number of updates so far. lr: a float or a step -> lr callable
    (cosine_warmup_schedule); clip_norm: optional global-norm clipping
    inside update()."""

    def __init__(self, lr=1e-4, b1=0.9, b2=0.999, eps=1e-8, wd=0.0, clip_norm=None):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, wd
        self.clip_norm = clip_norm

    def init(self, params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params), "count": 0}

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step, in place: each param leaf and the moments are
        overwritten. Returns (params, state) like the JAX update."""
        scale = None
        if self.clip_norm is not None:
            scale = _clip_scale(global_norm(grads), self.clip_norm)
        count = state["count"] + 1
        lr = float(self.lr(count) if callable(self.lr) else self.lr)
        # the bias corrections in f32, as the JAX update computes them
        b1c = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        b2c = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        for g, mu, nu, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                                tree_leaves(state["nu"]), tree_leaves(params)):
            adamw_update_(p, g, mu, nu, lr=lr, b1=self.b1, b2=self.b2, b1c=b1c, b2c=b2c,
                          eps=self.eps, wd=self.wd, scale=scale)
        return params, {"mu": state["mu"], "nu": state["nu"], "count": count}
