"""Peaks of one NVIDIA H100 SXM and the operations and bytes of the work
the benchmark measures.

Peaks: NVIDIA's data sheet, dense rates at the 700 W power limit. A
kernel's bound is the larger of its operations over the peak rate of its
precision and its bytes over the memory rate; each input byte is counted
read once and each output byte written once, and attention's operations
count only the visible (causal, window) pairs. A share of a bound or of
a peak is stated with the card's power limit beside it (the result
line's `device.power_limit_w`)."""

from __future__ import annotations

PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, kind: str) -> float:
    """The least time the card could take for this work."""
    return max(ops / PEAK_OPS_PER_S[kind], nbytes / HBM_BYTES_PER_S)


def ops_s(ops: float, kind: str) -> float:
    return ops / PEAK_OPS_PER_S[kind]


# ---- attention ------------------------------------------------------------


def visible_pairs(start: int, n: int, window: int | None) -> int:
    """(query, key) pairs a causal attention computes for the query rows
    at absolute positions [start, start + n): row p sees keys (p - w, p],
    or [0, p] without a window."""
    if n <= 0:
        return 0
    total = (start + n) * (start + n + 1) // 2 - start * (start + 1) // 2  # sum of p + 1
    if window is None:
        return total
    # rows with p + 1 > window see `window` keys instead of p + 1
    lo = max(start, window)
    hi = start + n
    if hi > lo:
        over = (hi * (hi + 1) // 2 - lo * (lo + 1) // 2) - window * (hi - lo)
        total -= over
    return total


def _key_rows(start: int, n: int, window: int | None) -> int:
    """Distinct key rows the query rows [start, start + n) see."""
    first = 0 if window is None else max(0, start - window + 1)
    return start + n - first


def flash_fwd(B, QH, KH, E, start, n, window, elt=2):
    """Kernel C over the query rows [start, start + n) of B sequences:
    (ops, bytes). Reads q and the visible K/V rows, writes o and lse."""
    pairs = visible_pairs(start, n, window)
    ops = 4 * E * QH * B * pairs  # QK^T and PV
    rows = _key_rows(start, n, window)
    nbytes = (B * QH * n * E * elt * 2  # q, o
              + B * KH * rows * E * elt * 2  # k, v
              + B * QH * n * 4)  # lse
    return ops, nbytes


def flash_bwd_dq(B, QH, KH, E, L, window, elt=2):
    """dQ (with delta fused) over a causal sequence of L: three products of
    2E operations a visible pair (S, dP, dQ). Reads q, k, v, o, dout, lse;
    writes dq."""
    pairs = visible_pairs(0, L, window)
    ops = 3 * 2 * E * QH * B * pairs
    nbytes = (B * QH * L * E * elt * 4  # q, o, dout, dq
              + B * KH * L * E * elt * 2  # k, v
              + B * QH * L * 4 * 2)  # lse, delta
    return ops, nbytes


def flash_bwd_dkv(B, QH, KH, E, L, window, elt=2):
    """dK/dV: four products a visible pair (S, dP, dV, dK). Reads q, k, v,
    dout, lse, delta; writes dk, dv."""
    pairs = visible_pairs(0, L, window)
    ops = 4 * 2 * E * QH * B * pairs
    nbytes = (B * QH * L * E * elt * 2  # q, dout
              + B * KH * L * E * elt * 4  # k, v, dk, dv
              + B * QH * L * 4 * 2)
    return ops, nbytes


# ---- grouped expert products -----------------------------------------------
# rows: the real expert-sorted rows, T * k, never the padded Tp; hit: the
# experts that at least one row takes (only their slabs are read or written)


def gmm_fwd(rows, K, N, hit, elt=2, w_elt=2):
    """Kernel I's forward, (rows, K) against each hit expert's (K, N) slab:
    (ops, bytes). Reads the rows and the hit slabs (w_elt bytes a weight:
    1 for int8), writes (rows, N)."""
    return 2 * rows * K * N, rows * K * elt + hit * K * N * w_elt + rows * N * elt


def gmm_dx(rows, K, N, hit, elt=2):
    """dx = dy (rows, N) times each hit expert's slab transposed: reads dy
    and the hit slabs, writes dx (rows, K)."""
    return 2 * rows * K * N, rows * N * elt + hit * K * N * elt + rows * K * elt


def gmm_dw(rows, K, N, hit, elt=2):
    """dw_e = x_e^T dy_e (the dw kernel): reads x (rows, K) and dy (rows,
    N), writes the hit experts' (K, N) gradients."""
    return 2 * rows * K * N, rows * (K + N) * elt + hit * K * N * elt


# ---- whole-model operations (for the shares of the peak) ------------------


def layer_linear_ops_per_token(cfg: dict) -> int:
    """Operations one token needs in one decoder layer's products: the q,
    k, v and o projections and the SwiGLU MLP, or with routed experts the
    router's product and the SwiGLUs of the k experts the token takes."""
    d = cfg["hidden_size"]
    H, KH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    E = head_dim(cfg)
    attn = 2 * d * (H + 2 * KH) * E + 2 * H * E * d
    mlp = 3 * 2 * d * cfg["intermediate_size"]
    if cfg.get("num_local_experts"):
        return attn + cfg["num_experts_per_tok"] * mlp + 2 * d * cfg["num_local_experts"]
    return attn + mlp


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def attention_ops(cfg: dict, start: int, n: int) -> int:
    """Forward attention operations of one layer for rows [start, start+n)
    of one sequence (QK^T and PV over the visible pairs)."""
    return 4 * head_dim(cfg) * cfg["num_attention_heads"] * visible_pairs(
        start, n, cfg.get("sliding_window"))


def train_step_ops(cfg: dict, B: int, L: int) -> float:
    """Operations of one training step (forward and backward, 3x the
    forward) over B rows of L tokens, the loss at every position."""
    lin = layer_linear_ops_per_token(cfg)
    n = cfg["num_hidden_layers"]
    fwd = B * (n * (lin * L + attention_ops(cfg, 0, L)) + 2 * cfg["hidden_size"]
               * cfg["vocab_size"] * L)
    return 3.0 * fwd


def prefill_seconds_at_peak(cfg: dict, start: int, n: int, last: bool) -> float:
    """The least time rows [start, start + n) of one prompt's prefill need
    at the bf16 peak: the products and attention's visible pairs of every
    layer, and the head's product only for the prompt's last position
    (`last`)."""
    ops = (layer_linear_ops_per_token(cfg) * n + attention_ops(cfg, start, n)) * cfg[
        "num_hidden_layers"]
    if last:
        ops += 2 * cfg["hidden_size"] * cfg["vocab_size"]
    return ops_s(ops, "bf16")
