"""Mixture-of-Experts layer: top-k router, capacity dispatch, and the
expert-sorted grouped path.

Counterpart of nnop_tpu/models/moe.py (Mixtral). Experts are stacked
weight tensors: w_gate / w_up (E, d, hidden), w_down (E, hidden, d),
plain, QTensor (int8, per-(E, N) scales, axis 1) or QTensor4 (packed int4
per expert), and the engine's fused w_gateup (E, d, 2 * hidden).

* `moe_mlp(impl="einsum")`: the GShard one-hot dispatch with capacity C
  (dropless by default), plain torch einsums: the JAX package runs no
  Pallas kernel there either.
* `moe_mlp(impl="grouped")` = `moe_mlp_grouped`: tokens sorted by expert
  into block_m-aligned blocks, three grouped products (kernel I,
  ops/grouped_matmul.py), a weighted scatter-add back. Exact work,
  dropless; the path the engine serves, and the one quantized or fused
  experts always take.

Both paths train with plain (bf16 or f32) experts: the grouped products'
backward runs kernel I for dx and the dw kernel (csrc/gmm_dw.cu), and
the router's weight gets its gradient through the combine weights and
the aux loss. The layer never syncs the host: the padded row count Tp is
a static bound, and the counts, sort and block lookup stay on the device
(scatter-adds rather than `bincount`, whose CUDA version reads its
maximum back). `plain=True` runs the grouped products' plain versions,
forward and backward, on any device (the reference the kernels are held
to on the card).
`moe_mlp_local_experts` (serving tensor parallelism) is not ported yet.
"""

from __future__ import annotations

import torch

from nnop_tpu_torch.ops import naive
from nnop_tpu_torch.ops.grouped_matmul import (
    _grouped_matmul_q4,
    grouped_matmul,
    grouped_matmul_quantized,
    grouped_matmul_w8a8,
)
from nnop_tpu_torch.ops.quantization import QTensor, QTensor4

W8A8_MIN_ROWS = 1024  # grouped products with at least this many padded rows run W8A8


def _one_hot(idx, n: int):
    """(...,) ints -> (..., n) f32 one-hot, with no host sync (F.one_hot
    checks its range on the host); an index outside [0, n) gives zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def router_topk(h, w_router, k: int):
    """Top-k routing, Mixtral convention (softmax over the top-k logits).

    h: (T, d); w_router: (d, E). Returns (weights (T, k) f32, idx (T, k)
    int64, probs (T, E) f32, the full softmax for the aux loss)."""
    logits = h.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(logits, k, dim=-1)
    return torch.softmax(topv, dim=-1), topi, probs


def load_balance_loss(probs, idx, n_experts: int):
    """Switch-Transformer auxiliary load-balancing loss: E * sum_e f_e p_e,
    f_e the fraction of (token, slot) assignments to expert e, p_e its
    mean router probability (1 at uniform routing)."""
    f = _one_hot(idx, n_experts).sum(dim=1).mean(dim=0)
    p = probs.mean(dim=0)
    return n_experts * ((f / idx.shape[1]) * p).sum()


def expert_capacity(n_tokens: int, n_experts: int, k: int,
                    capacity_factor: float | None) -> int:
    """Per-expert capacity C. None = dropless (C = n_tokens). Otherwise
    k*T/E * factor, rounded up to a multiple of 8 and clamped to [8,
    n_tokens] (the JAX package's rule)."""
    if capacity_factor is None:
        return max(8, n_tokens)
    c = int(n_tokens * k / n_experts * capacity_factor)
    c = -(-max(c, 1) // 8) * 8
    return min(max(c, 8), max(8, n_tokens))


def make_dispatch(idx, weights, n_experts: int, capacity: int):
    """Dispatch (T, E, C) 0/1 and combine (T, E, C) f32 tensors from the
    top-k assignments idx, weights (T, k). Positions within an expert go
    token-major then slot-major; assignments past capacity are dropped."""
    T, k = idx.shape
    oh = _one_hot(idx.reshape(T * k), n_experts)  # (T*k, E)
    p = ((torch.cumsum(oh, dim=0) - oh) * oh).sum(dim=-1).long()  # slot within its expert
    keep = (p < capacity).float()
    disp = ((oh * keep[:, None])[:, :, None] * _one_hot(p, capacity)[:, None, :]).reshape(
        T, k, n_experts, capacity)
    combine = (disp * weights.reshape(T, k, 1, 1)).sum(dim=1)
    return disp.sum(dim=1), combine


def moe_mlp(layer, h, cfg, *, act, impl: str | None = None, w8a8: bool = False,
            plain: bool = False):
    """MoE SwiGLU over flattened tokens h (T, d) -> ((T, d), aux loss).

    impl (default cfg.moe_impl): "einsum" (capacity dispatch) or
    "grouped" (moe_mlp_grouped); fused or quantized experts always take
    the grouped path."""
    impl = impl or cfg.moe_impl
    if (impl == "grouped" or "w_gateup" in layer
            or isinstance(layer.get("w_gate"), (QTensor, QTensor4))):
        return moe_mlp_grouped(layer, h, cfg, act=act, w8a8=w8a8, plain=plain)
    T, d = h.shape
    E, k = cfg.n_experts, cfg.n_experts_per_token
    C = expert_capacity(T, E, k, cfg.capacity_factor)
    w, idx, probs = router_topk(h, layer["w_router"], k)
    dispatch, combine = make_dispatch(idx, w, E, C)
    xin = torch.einsum("tec,td->ecd", dispatch.to(h.dtype), h)
    gate = act(torch.einsum("ecd,edh->ech", xin, layer["w_gate"]).float())
    up = torch.einsum("ecd,edh->ech", xin, layer["w_up"]).float()
    xout = torch.einsum("ech,ehd->ecd", (gate * up).to(h.dtype), layer["w_down"])
    out = torch.einsum("tec,ecd->td", combine.to(h.dtype), xout)
    return out.to(h.dtype), load_balance_loss(probs, idx, E)


def sort_tokens_by_expert(idx, n_experts: int, block_m: int):
    """Expert-sorted, block-aligned layout for the grouped products.

    idx: (T, k) expert ids. Returns (src, dest, block_groups, Tp, order,
    block_rows): sorted assignment j is token src[j]'s, placed at row
    dest[j] of the (Tp, d) buffer; every expert's rows start at a
    block_m-aligned offset, so each block belongs to one expert
    (block_groups (Tp/block_m,) int32, non-decreasing; blocks past the
    last expert's are given expert E-1). Tp, the static bound
    ceil((T*k + E*(block_m-1)) / block_m) * block_m, depends on shapes
    alone. order maps sorted rows to flat (token, slot) rows. block_rows
    (Tp/block_m,) int32, the port's addition: the real rows of each block,
    which come first in it."""
    T, k = idx.shape
    E, bm = n_experts, block_m
    dev = idx.device
    flat = idx.reshape(T * k).long()
    order = torch.argsort(flat, stable=True)
    es = flat[order]
    counts = torch.zeros(E, dtype=torch.int64, device=dev).index_add_(
        0, flat, torch.ones_like(flat))
    padded = (counts + bm - 1) // bm * bm
    pad_off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(padded, 0)])
    starts = torch.cumsum(counts, 0) - counts
    dest = pad_off[es] + torch.arange(T * k, device=dev) - starts[es]
    Tp = -(-(T * k + E * (bm - 1)) // bm) * bm
    block_start = torch.arange(Tp // bm, device=dev) * bm
    groups = torch.clamp(torch.searchsorted(pad_off[1:], block_start, right=True), 0, E - 1)
    rows = torch.clamp(pad_off[groups] + counts[groups] - block_start, 0, bm)
    return order // k, dest, groups.to(torch.int32), Tp, order, rows.to(torch.int32)


def _block_m(T: int, k: int, E: int) -> int:
    """The JAX package's block_m policy (nnop_tpu/models/moe.py:209-220):
    32 rows at decode scale (<= 64 assignments per expert), where the
    layer streams weights; else 128-512, growing with the rows per
    expert, so fewer blocks re-stream each expert's slab."""
    per_expert = (T * k) // E
    if per_expert <= 64:
        return 32
    return max(128, min(512, (per_expert // 128) * 128))


def moe_mlp_grouped(layer, h, cfg, *, act, block_m: int | None = None, w8a8: bool = False,
                    plain: bool = False):
    """Exact-work MoE: sort tokens by expert, three grouped products, a
    weighted scatter-add back. Dropless. w8a8: int8 experts run W8A8 when
    the padded rows Tp >= 1024 (prefill), weight-only below (decode), as
    in the JAX package. plain: the products' plain versions."""
    T, d = h.shape
    E, k = cfg.n_experts, cfg.n_experts_per_token
    block_m = block_m or _block_m(T, k, E)
    w, idx, probs = router_topk(h, layer["w_router"], k)
    src, dest, groups, Tp, order, rows = sort_tokens_by_expert(idx, E, block_m)
    xs = h.new_zeros((Tp, d)).index_copy(0, dest, h[src])

    def gmm(x, wts):
        kw = dict(block_m=block_m, block_rows=rows)
        if isinstance(wts, QTensor):
            if w8a8 and wts.values.dtype == torch.int8 and Tp >= W8A8_MIN_ROWS:
                if plain:
                    xv, xsc = naive.quantize_act(x)
                    return naive.naive_grouped_matmul_w8a8(xv, xsc, wts, groups, block_m, x.dtype)
                return grouped_matmul_w8a8(x, wts, groups, **kw)
            if plain:
                return naive.naive_grouped_matmul_quantized(x, wts, groups, block_m)
            return grouped_matmul_quantized(x, wts, groups, **kw)
        if isinstance(wts, QTensor4):
            if plain:
                return naive.naive_grouped_matmul4(x, wts, groups, block_m)
            return _grouped_matmul_q4(x, wts, groups, block_n=2048, **kw)
        return grouped_matmul(x, wts, groups, plain=plain, **kw)

    if "w_gateup" in layer:  # engine-fused experts: one pass for gate|up
        gu = gmm(xs, layer["w_gateup"]).float()
        gate, up = act(gu[:, : cfg.hidden_dim]), gu[:, cfg.hidden_dim:]
    else:
        gate = act(gmm(xs, layer["w_gate"]).float())
        up = gmm(xs, layer["w_up"]).float()
    y = gmm((gate * up).to(h.dtype), layer["w_down"])  # (Tp, d)
    wf = w.reshape(T * k)[order]
    out = torch.zeros((T, d), dtype=torch.float32, device=h.device).index_add(
        0, src, y[dest].float() * wf[:, None])
    return out.to(h.dtype), load_balance_loss(probs, idx, E)


def moe_mlp_naive(layer, h, cfg, *, act):
    """Per-token oracle: out_t = sum_j w_j * SwiGLU_{e_j}(h_t), dropless
    (plain experts; small sizes: it gathers an expert slab per token)."""
    w, idx, _ = router_topk(h, layer["w_router"], cfg.n_experts_per_token)
    out = torch.zeros_like(h)
    for j in range(cfg.n_experts_per_token):
        e = idx[:, j]
        g = act(torch.einsum("td,tdh->th", h, layer["w_gate"][e]).float())
        u = torch.einsum("td,tdh->th", h, layer["w_up"][e]).float()
        o = torch.einsum("th,thd->td", (g * u).to(h.dtype), layer["w_down"][e])
        out = out + o * w[:, j:j + 1].to(o.dtype)
    return out


def init_moe_layer(cfg, dense):
    """Stacked-expert weights for one layer; dense(shape) draws one
    (fan_in, fan_out) matrix (models/llama.py:init_params)."""
    E, d, hd = cfg.n_experts, cfg.dim, cfg.hidden_dim
    return {
        "w_router": dense((d, E)),
        "w_gate": torch.stack([dense((d, hd)) for _ in range(E)]),
        "w_up": torch.stack([dense((d, hd)) for _ in range(E)]),
        "w_down": torch.stack([dense((hd, d)) for _ in range(E)]),
    }
