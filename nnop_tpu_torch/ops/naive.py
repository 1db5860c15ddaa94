"""Plain PyTorch versions of the ops: the CPU path and the kernels' oracles.

Counterpart of nnop_tpu/ops/naive.py, plus the plain decode attention
over a stacked cache with staging and the plain staging flush. Each op
module's wrapper runs these for a CPU tensor; `chip_smoke.py` and the
card tests hold each kernel against them on the same inputs.

Layouts are the JAX package's:
  q: (B, QH, QL, E)   k, v: (B, KH, KL, E)   pair: (B, QH, QL, KL)
  kpad_mask: (B, KL) bool, True = valid key position
  stacked cache: (n_layers, B, KH, S, E)   staging: (B, n_layers, KH, W, E)

Masking follows the kernels (MASK_VALUE, not -inf; masked probabilities
are exact zeros; a row with no visible key gives zeros, not NaN or the
uniform average of the JAX oracle).
"""

from __future__ import annotations

import torch

MASK_VALUE = -1e30


def naive_rms_norm(x, w, *, eps: float = 1e-6, offset: float = 0.0):
    """RMS norm over the last axis, fp32 accumulation, (offset + w) scale."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * (offset + w.float())
    return y.to(x.dtype)


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def naive_rope(q, k, cos, sin, sin_sign: float = 1.0):
    """Llama rotary embedding on q (B, QH, L, E) and k (B, KH, L, E) with
    cos/sin (B, L, E) (duplicated halves). sin_sign=-1 is the inverse
    rotation (the backward)."""
    c = cos[:, None].float()
    s = sin_sign * sin[:, None].float()

    def rot(x):
        xf = x.float()
        return (xf * c + rotate_half(xf) * s).to(x.dtype)

    return rot(q), rot(k)


def _masked_softmax_stats(s, mask):
    """Kernel semantics of a masked row softmax: returns (p unnormalized,
    m, l_safe) with masked entries exact zeros and l == 0 guarded."""
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=MASK_VALUE)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    return p, m, torch.where(l == 0, torch.ones_like(l), l)


def naive_attention(
    q,
    k,
    v,
    pair=None,
    *,
    causal: bool = False,
    causal_offset: int = 0,
    kpad_mask=None,
    segment_ids=None,
    scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
    return_lse: bool = False,
):
    """Reference attention (GQA by head repeat). Row i of q sits at global
    position causal_offset + i; with `causal` it sees keys at positions
    <= its own (and, with `window`, > its own - window). Returns o in
    q.dtype, and the row log-sum-exp in nats (B, QH, QL) f32 when
    `return_lse`. Probabilities are rounded to v.dtype before the PV
    product, as the kernels do."""
    B, QH, QL, E = q.shape
    _, KH, KL, _ = k.shape
    if QH % KH != 0:
        raise ValueError(f"q heads {QH} not a multiple of kv heads {KH}")
    if scale is None:
        scale = 1.0 / (E**0.5)
    rep = QH // KH
    kf = k.float().repeat_interleave(rep, dim=1)
    vr = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqe,bhke->bhqk", q.float(), kf) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if pair is not None:
        s = s + pair.float()
    mask = torch.ones((1, 1, QL, KL), dtype=torch.bool, device=q.device)
    if causal:
        rows = causal_offset + torch.arange(QL, device=q.device)[:, None]
        cols = torch.arange(KL, device=q.device)[None, :]
        cm = rows >= cols
        if window is not None:
            cm = cm & (rows - cols < window)
        mask = mask & cm
    if kpad_mask is not None:
        mask = mask & kpad_mask[:, None, None, :].bool()
    if segment_ids is not None:
        q_seg, kv_seg = segment_ids
        mask = mask & (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    mask = mask.expand(B, QH, QL, KL)
    p, m, l = _masked_softmax_stats(s, mask)
    o = torch.einsum("bhqk,bhke->bhqe", p.to(v.dtype).float(), vr.float()) / l
    if return_lse:
        return o.to(q.dtype), (m + torch.log(l))[..., 0]
    return o.to(q.dtype)


def naive_decode_attention(
    q,
    k_cache,
    v_cache,
    lengths,
    *,
    scale: float | None = None,
    k_stage=None,
    v_stage=None,
    staged_n: int = 0,
    layer: int | None = None,
    window: int | None = None,
    softcap: float | None = None,
):
    """One query token per sequence over a floating-point cache plus the
    bf16 staging buffer (nnop_tpu/ops/attention_decode.py semantics).

    q: (B, QH, 1, E). Caches (B, KH, S, E), or stacked
    (n_layers, B, KH, S, E) with `layer`. lengths (B,) counts FLUSHED
    tokens: cache rows < lengths[b] are live. Staging (B, KH, W, E) (or
    (B, n_layers, KH, W, E) with `layer`) holds the `staged_n` newest
    tokens, at positions lengths[b] + j; it is masked for a slot with
    lengths[b] == 0. The staging part runs with q and P rounded to bf16;
    the cache part rounds P to the cache dtype. Returns (B, QH, 1, E).
    """
    B, QH, T, E = q.shape
    if T != 1:
        raise NotImplementedError("multi-token (speculative) decode not ported yet")
    kc = k_cache[layer] if layer is not None else k_cache
    vc = v_cache[layer] if layer is not None else v_cache
    KH, S = kc.shape[1], kc.shape[2]
    G = QH // KH
    if scale is None:
        scale = 1.0 / (E**0.5)
    lens = lengths.to(q.device).long()
    qg = q.reshape(B, KH, G, E)
    pos = torch.arange(S, device=q.device)
    s_c = torch.einsum("bkge,bkse->bkgs", qg.float(), kc.float()) * scale
    m_c = (pos[None] < lens[:, None])[:, None, None, :]
    if window is not None:
        # the query sits at position lengths + staged_n - 1
        m_c = m_c & (pos[None] >= (lens + staged_n - window)[:, None])[:, None, None, :]
    scores, masks = [s_c], [m_c.expand(B, KH, G, S)]
    if k_stage is not None:
        ks = k_stage[:, layer] if layer is not None else k_stage
        vs = v_stage[:, layer] if layer is not None else v_stage
        W = ks.shape[2]
        q16 = qg.to(torch.bfloat16).float()
        s_st = torch.einsum("bkge,bkwe->bkgw", q16, ks.float()) * scale
        w = torch.arange(W, device=q.device)
        m_st = (w[None] < staged_n) & (lens[:, None] > 0)
        if window is not None:
            m_st = m_st & (w[None] >= staged_n - window)
        scores.append(s_st)
        masks.append(m_st[:, None, None, :].expand(B, KH, G, W))
    s = torch.cat(scores, dim=-1)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    p, _, l = _masked_softmax_stats(s, torch.cat(masks, dim=-1))
    o = torch.einsum("bkgs,bkse->bkge", p[..., :S].to(vc.dtype).float(), vc.float())
    if k_stage is not None:
        p_st = p[..., S:].to(torch.bfloat16).float()
        o = o + torch.einsum("bkgw,bkwe->bkge", p_st, vs.float())
    return (o / l).to(q.dtype).reshape(B, QH, 1, E)


def naive_flush_staging(k_cache, v_cache, k_stage, v_stage, lengths):
    """In place: cache[l, b, :, lengths[b] : lengths[b] + W] = stage[b, l]
    for every slot and layer, cast to the cache dtype (all W rows, as the
    TPU flush writes them)."""
    W = k_stage.shape[3]
    for b, base in enumerate(lengths.tolist()):
        for cache, stage in ((k_cache, k_stage), (v_cache, v_stage)):
            rows = min(W, cache.shape[3] - base)
            cache[:, b, :, base : base + rows] = stage[b, :, :, :rows].to(cache.dtype)
