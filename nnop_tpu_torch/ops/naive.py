"""Plain PyTorch versions of the ops: the CPU path and the kernels' oracles.

Counterpart of nnop_tpu/ops/naive.py, plus the plain decode attention
over a stacked cache or a page pool with staging, the plain staging
flushes (linear and paged), the one-token cache write and the plain
quantized products (nnop_tpu/ops/quantized_matmul.py). Each op
module's wrapper runs these for a CPU tensor; `chip_smoke.py` and the
card tests hold each kernel against them on the same inputs.

Layouts are the JAX package's:
  q: (B, QH, QL, E)   k, v: (B, KH, KL, E)   pair: (B, QH, QL, KL)
  kpad_mask: (B, KL) bool, True = valid key position
  stacked cache: (n_layers, B, KH, S, E)   staging: (B, n_layers, KH, W, E)
  stacked page pool: (n_layers, n_pages, KH, page, E)   page table: (B, max_pages)

Masking follows the kernels (MASK_VALUE, not -inf; masked probabilities
are exact zeros; a row with no visible key gives zeros, not NaN or the
uniform average of the JAX oracle).
"""

from __future__ import annotations

import torch

from nnop_tpu_torch.ops.quantization import INT8_MAX, QTensor, QTensor4, div_exact, unpack4

MASK_VALUE = -1e30


def naive_rms_norm_fwd(x, w, *, eps: float = 1e-6, offset: float = 0.0):
    """RMS norm over the last axis, fp32 accumulation, (offset + w) scale.
    Returns (y in x.dtype, rstd (..., 1) f32), rstd = rsqrt(mean x^2 + eps)."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    rstd = torch.rsqrt(ms + eps)
    return (xf * rstd * (offset + w.float())).to(x.dtype), rstd


def naive_rms_norm(x, w, *, eps: float = 1e-6, offset: float = 0.0):
    """RMS norm over the last axis, fp32 accumulation, (offset + w) scale."""
    return naive_rms_norm_fwd(x, w, eps=eps, offset=offset)[0]


def naive_rms_norm_bwd(x, w, rstd, dy, offset: float = 0.0):
    """The RMS norm backward (nnop_tpu/ops/rms_norm.py:52-93), f32
    throughout: x, dy (n, e), rstd (n, 1) from the forward. With
    x_hat = x * rstd and g = offset + w:
      dx = rstd * (g * dy - x_hat * mean(g * dy * x_hat))   (in x.dtype)
      dw = sum over rows of dy * x_hat                      (f32)"""
    xhat = x.float() * rstd
    dyf = dy.float()
    gdy = (offset + w.float()) * dyf
    c = torch.mean(gdy * xhat, dim=-1, keepdim=True)
    return (rstd * (gdy - xhat * c)).to(x.dtype), (dyf * xhat).sum(dim=0)


def naive_softmax(x):
    """Softmax over the last axis in f32, output in x.dtype, with the TPU
    kernel's guard (nnop_tpu/ops/softmax.py:45-47): a row maximum that is
    NaN or -inf becomes 0 (so a row of -inf gives 0 / 0 = NaN there)."""
    xf = x.float()
    m = xf.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isnan(m) | (m == float("-inf")), torch.zeros_like(m), m)
    e = torch.exp(xf - m)
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def naive_softmax_bwd(y, dy):
    """The softmax backward from its output, f32 math:
    dx = (dy - sum(dy * y)) * y, in y.dtype."""
    yf, dyf = y.float(), dy.float()
    return ((dyf - (dyf * yf).sum(dim=-1, keepdim=True)) * yf).to(y.dtype)


def naive_layer_norm_fwd(x, w, b, *, eps: float = 1e-6):
    """Layer norm over the last axis, f32 math (nnop_tpu/ops/layer_norm.py
    :36-47). Returns (y in x.dtype, mu (..., 1) f32, sigma (..., 1) f32),
    sigma = rsqrt(var + eps) with var the mean of (x - mu)^2."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    sigma = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return (xc * sigma * w.float() + b.float()).to(x.dtype), mu, sigma


def naive_layer_norm_bwd(x, w, mu, sigma, dy):
    """The layer-norm backward (nnop_tpu/ops/layer_norm.py:11-15), f32
    throughout: x, dy (n, e), mu and sigma (n, 1) from the forward. With
    x_hat = (x - mu) * sigma:
      dx = sigma * (w dy - mean(w dy) - x_hat * mean(w dy x_hat))  (x.dtype)
      dw = sum over rows of dy * x_hat,  db = sum over rows of dy  (f32)"""
    xhat = (x.float() - mu) * sigma
    dyf = dy.float()
    wdy = w.float() * dyf
    c1 = (wdy * xhat).mean(dim=-1, keepdim=True)
    c2 = wdy.mean(dim=-1, keepdim=True)
    dx = sigma * (wdy - c2 - xhat * c1)
    return dx.to(x.dtype), (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


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


def naive_attention_bwd(q, k, v, o, lse, do, *, causal: bool, scale: float, kpad_mask=None,
                        pair=None, segment_ids=None, window: int | None = None,
                        softcap: float | None = None):
    """The attention backward as explicit formulas
    (nnop_tpu/ops/flash_attention_bwd.py:40-130 and :1067-1071), from the
    forward's o and lse (B, QH, QL) in nats; layouts as naive_attention,
    causal from row 0. With s = scale * q k^T, then with a softcap c
    t = tanh(s / c) and s = c * t, then + pair, recomputed under the
    forward's mask (causal, with a window w also i - j < w; kpad;
    q_seg[i] == kv_seg[j]):
      delta = sum_e do * o;  P = exp(s - lse);  dP = do v^T
      dS = P * (dP - delta), times 1 - t^2 with a softcap (:125-129)
      dq = scale * dS k;  dk = scale * dS^T q;  dv = P^T do
      dpair = dS (before the scale, :218-220)
    masked entries of P and dS exact zeros (a row with no visible key
    gets zero gradients); P and dS rounded to the operand dtype before
    their products, as the kernels do; dk and dv summed over each KV
    head's group of query heads. Returns (dq, dk, dv) in q/k/v dtypes,
    and dpair in pair's dtype after them when pair is given."""
    B, QH, QL, E = q.shape
    _, KH, KL, _ = k.shape
    rep = QH // KH
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    qf, dof = q.float(), do.float()
    s = torch.einsum("bhqe,bhke->bhqk", qf, kf) * scale
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    if pair is not None:
        s = s + pair.float()
    mask = torch.ones((1, 1, QL, KL), dtype=torch.bool, device=q.device)
    if causal:
        rows = torch.arange(QL, device=q.device)[:, None]
        cols = torch.arange(KL, device=q.device)[None, :]
        mask = mask & (rows >= cols)
        if window is not None:
            mask = mask & (rows - cols < window)
    if kpad_mask is not None:
        mask = mask & kpad_mask[:, None, None, :].bool()
    if segment_ids is not None:
        q_seg, kv_seg = segment_ids
        mask = mask & (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bhqe,bhke->bhqk", dof, vf)
    ds = torch.where(mask, p * (dp - delta), torch.zeros_like(s))
    if softcap is not None:
        ds = ds * (1.0 - t * t)
    p_r, ds_r = p.to(v.dtype).float(), ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bhke->bhqe", ds_r, kf) * scale
    dk = torch.einsum("bhqk,bhqe->bhke", ds_r, qf) * scale
    dv = torch.einsum("bhqk,bhqe->bhke", p_r, dof)

    def group_sum(x):
        return x.reshape(B, KH, rep, KL, E).sum(dim=2)

    grads = (dq.to(q.dtype), group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype))
    return grads + ((ds.to(pair.dtype),) if pair is not None else ())


def naive_decode_attention(
    q,
    k_cache,
    v_cache,
    lengths,
    k_scale=None,
    v_scale=None,
    *,
    scale: float | None = None,
    k_stage=None,
    v_stage=None,
    staged_n: int = 0,
    layer: int | None = None,
    window: int | None = None,
    softcap: float | None = None,
):
    """T query tokens per sequence over a floating-point or int8 cache
    plus the bf16 staging buffer (nnop_tpu/ops/attention_decode.py
    semantics).

    q: (B, QH, T, E). Caches (B, KH, S, E), or stacked
    (n_layers, B, KH, S, E) with `layer`. lengths (B,) counts FLUSHED
    tokens: cache rows < lengths[b] are live. Staging (B, KH, W, E) (or
    (B, n_layers, KH, W, E) with `layer`) holds the `staged_n` newest
    tokens, at positions lengths[b] + j; it is masked for a slot with
    lengths[b] == 0. Returns (B, QH, T, E).

    T > 1 is the speculative-verify mode: the T query tokens are the last
    T staged ones, so query t sits at position lengths[b] + staged_n - T
    + t. Every query sees the live cache rows (cut per query by the
    window); staged row w is visible to query t iff w <= staged_n - T + t
    (the intra-draft causal mask). It needs the staging and T <= staged_n.

    A linear cache is a pool whose page is a slot's whole row, so this is
    naive_paged_decode_attention with slot b's one page b: the cache part
    and the staging part run as two online-softmax steps, as the TPU
    kernel runs them. The cache part's P is rounded against the cache
    part's own maximum (rounding against the joint maximum instead would
    differ from the TPU kernel by up to a bf16 ulp of P wherever the
    staging part raises the maximum). An int8 cache follows the engine's
    TPU path (attention_decode.py:_decode_step_b_flat), as the paged
    version describes.
    """
    table = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)[:, None]
    return naive_paged_decode_attention(
        q, k_cache, v_cache, table, lengths, k_scale, v_scale, scale=scale, k_stage=k_stage,
        v_stage=v_stage, staged_n=staged_n, layer=layer, window=window, softcap=softcap)


def naive_paged_decode_attention(
    q,
    pool_k,
    pool_v,
    page_table,
    lengths,
    k_scale=None,
    v_scale=None,
    *,
    scale: float | None = None,
    k_stage=None,
    v_stage=None,
    staged_n: int = 0,
    layer: int | None = None,
    window: int | None = None,
    softcap: float | None = None,
):
    """Decode attention over a page pool plus the bf16 staging buffer
    (nnop_tpu/ops/attention_decode_paged.py semantics; with T > 1 the
    verify mode of nnop_tpu/ops/attention_decode.py, which
    naive_decode_attention reaches through a one-page-per-slot table).

    q: (B, QH, T, E). Pools (n_pages, KH, page, E), or stacked
    (n_layers, n_pages, KH, page, E) with `layer`; page_table (B,
    max_pages) holds each slot's page ids in order, and only the entries
    below ceil(lengths[b] / page) are read. lengths and staging are as in
    naive_decode_attention, and so is the mask of the T query tokens; an
    int8 pool comes with per-token f32 scales of the pool's shape without
    E.

    The steps are the TPU kernel's: one online-softmax step per page, then
    one for the staging rows. An fp pool keeps q and P unrounded in the
    cache part and rounds P to the pool dtype; an int8 pool rounds q and
    k to bf16, puts scale * k_scale on the scores, sums P before the V
    scale and rounds P * v_scale to bf16. The staging step runs with q and
    P in bf16 and is masked for a slot with lengths[b] == 0. A slot that
    sees no key gets zeros.
    """
    o, m, l = _decode_parts(q, pool_k, pool_v, page_table, lengths, k_scale, v_scale,
                            scale=scale, k_stage=k_stage, v_stage=v_stage, staged_n=staged_n,
                            layer=layer, window=window, softcap=softcap)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (o / l).to(q.dtype).reshape(q.shape)


def naive_decode_partials(q, k_cache, v_cache, lengths, k_scale=None, v_scale=None, *, ranges,
                          stage_split: int, scale: float | None = None, k_stage=None,
                          v_stage=None, staged_n: int = 0, layer: int | None = None,
                          window: int | None = None, softcap: float | None = None):
    """The plain form of kernel D's split-KV: naive_decode_attention's
    function as one partial per split, to be merged with
    ops/flash_attention.py:lse_merge. ranges[s] = (lo, hi), (B,) ints:
    split s attends slot b's cache rows [lo[b], hi[b]) (as
    naive_decode_attention attends them, masks and rounding included);
    split `stage_split` also attends the staged rows. Returns [(o_s (B,
    QH, T, E) f32, normalised within the split, lse_s (B, QH, T, 1) f32)];
    a split that sees no key gives o 0 and lse MASK_VALUE (finite, so that
    merging two of them stays finite; the kernel keeps (max, sum) and
    guards a zero sum). The staging part rounds P against its split's
    running maximum, the whole call against the cache part's, so the two
    agree exactly where every row's maximum is a staged score."""
    table = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)[:, None]
    parts = []
    for s, rows in enumerate(ranges):
        o, m, l = _decode_parts(
            q, k_cache, v_cache, table, lengths, k_scale, v_scale, scale=scale,
            k_stage=k_stage if s == stage_split else None,
            v_stage=v_stage if s == stage_split else None, staged_n=staged_n, layer=layer,
            window=window, softcap=softcap, rows=rows)
        empty = l == 0
        lse = torch.where(empty, torch.full_like(m, MASK_VALUE),
                          m + torch.log(torch.where(empty, torch.ones_like(l), l)))
        o = torch.where(empty, torch.zeros_like(o), o / torch.where(empty, torch.ones_like(l), l))
        parts.append((o.reshape(q.shape), lse.reshape(*q.shape[:3], 1)))
    return parts


def _decode_parts(q, pool_k, pool_v, page_table, lengths, k_scale=None, v_scale=None, *,
                  scale=None, k_stage=None, v_stage=None, staged_n: int = 0, layer=None,
                  window=None, softcap=None, rows=None):
    """naive_paged_decode_attention's online softmax -> its state (o
    unnormalised (B, KH, G * T, E), m, l (B, KH, G * T, 1)). rows: (lo,
    hi), (B,) ints, keeps only slot b's cache rows [lo[b], hi[b]); with
    it and no staging, staged_n still places the queries (a split that
    does not hold the staged rows)."""
    B, QH, T, E = q.shape
    if rows is None or k_stage is not None:
        staged_n = check_draft_rows(T, k_stage, staged_n)
    pk = pool_k[layer] if layer is not None else pool_k
    pv = pool_v[layer] if layer is not None else pool_v
    quantized = pk.dtype == torch.int8
    n_pages, KH, P, _ = pk.shape
    G = QH // KH
    if scale is None:
        scale = 1.0 / (E**0.5)
    if quantized:
        ksc = k_scale[layer] if layer is not None else k_scale
        vsc = v_scale[layer] if layer is not None else v_scale
    lens = lengths.to(q.device).long()
    table = page_table.to(q.device).long()
    R = G * T  # query rows per KV head, row r = g * T + t
    qg = q.reshape(B, KH, R, E)
    q_c = qg.to(torch.bfloat16).float() if quantized else qg.float()
    # each row's draft index t, and the staged row of its own position
    row_t = torch.arange(T, device=q.device).repeat(G)
    own = staged_n - T + row_t  # (R,)

    def softcapped(s):
        return s if softcap is None else softcap * torch.tanh(s / softcap)

    m = torch.full((B, KH, R, 1), MASK_VALUE, device=q.device)
    l = torch.zeros((B, KH, R, 1), device=q.device)
    o = torch.zeros((B, KH, R, E), device=q.device)

    def online_step(s, mask, p_of, v):
        """One online-softmax step: s, mask (B, KH, R, C); p_of(p) is P as
        it enters the PV product; v (B, KH, C, E)."""
        nonlocal m, l, o
        s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.einsum("bkgc,bkce->bkge", p_of(p), v.float())
        m = m_new

    n_live = -(-int(lens.max()) // P) if B else 0
    for j in range(n_live):
        # a slot past its last live page reads page 0, all of it masked
        ids = torch.where(j * P < lens, table[:, j], torch.zeros_like(lens))
        kj = pk[ids]  # (B, KH, P, E)
        s = torch.einsum("bkge,bkpe->bkgp", q_c, kj.float()) * scale
        if quantized:
            s = s * ksc[ids].float()[:, :, None, :]
        pos = j * P + torch.arange(P, device=q.device)
        mask = (pos[None] < lens[:, None])[:, None]  # (B, 1, P)
        if window is not None:
            # query t sits at position lengths + staged_n - T + t
            lo = lens[:, None] + own[None] + 1 - window  # (B, R)
            mask = mask & (pos[None, None] >= lo[:, :, None])
        if rows is not None:  # this split's rows
            lo_b, hi_b = (torch.as_tensor(x, device=q.device).long() for x in rows)
            mask = mask & ((pos[None] >= lo_b[:, None]) & (pos[None] < hi_b[:, None]))[:, None]
        if quantized:
            vj = vsc[ids].float()[:, :, None, :]

            def p_of(p, vj=vj):
                return (p * vj).to(torch.bfloat16).float()
        else:

            def p_of(p):
                return p.to(pk.dtype).float()

        online_step(softcapped(s), mask[:, None].expand(B, KH, R, P), p_of, pv[ids])
    if k_stage is not None:
        ks = k_stage[:, layer] if layer is not None else k_stage
        vs = v_stage[:, layer] if layer is not None else v_stage
        W = ks.shape[2]
        s = torch.einsum("bkge,bkwe->bkgw", qg.to(torch.bfloat16).float(), ks.float()) * scale
        w = torch.arange(W, device=q.device)
        # staged row w is at position lengths + w: causal within the drafts
        mask = w[None] <= own[:, None]  # (R, W)
        if window is not None:
            mask = mask & (w[None] >= own[:, None] + 1 - window)
        mask = mask[None] & (lens > 0)[:, None, None]  # (B, R, W)
        online_step(softcapped(s), mask[:, None].expand(B, KH, R, W),
                    lambda p: p.to(torch.bfloat16).float(), vs)
    return o, m, l


def check_draft_rows(T: int, k_stage, staged_n) -> int:
    """The staged_n that decode attention runs with (0 without staging),
    after checking T query tokens against it: T > 1 (the speculative
    verify) needs the staging and T <= staged_n, as the queries are the
    last T staged tokens."""
    staged_n = int(staged_n or 0) if k_stage is not None else 0
    if T > 1 and (k_stage is None or not T <= staged_n):
        have = f"staged_n {staged_n}" if k_stage is not None else "no staging"
        raise ValueError(f"multi-token decode (speculative verify) needs the {T} draft tokens' "
                         f"K/V as the last staged rows (staged_n >= T); got {have}")
    return staged_n


def _quantize_rows(x):
    """The staging flush's per-row int8 quantizer (kv_write.py:227-231,
    :155-162): s = max(amax, 1e-8) / 127 and values clip(round(x /
    max(s, 1e-8)), ±127). x (..., E) float -> (int8 values, f32 s (...))."""
    s = div_exact(torch.clamp(x.abs().amax(dim=-1), min=1e-8), INT8_MAX)
    q = torch.round(x / torch.clamp(s, min=1e-8)[..., None])
    return torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8), s


def naive_flush_staging(k_cache, v_cache, k_stage, v_stage, lengths, k_scale=None,
                        v_scale=None):
    """In place: cache[l, b, :, lengths[b] : lengths[b] + W] = stage[b, l]
    for every slot and layer, cast to the cache dtype (all W rows, as the
    TPU flush writes them).

    An int8 cache quantizes each staged row as the TPU flush does
    (`_quantize_rows`): the scale goes to the scale cache."""
    W = k_stage.shape[3]
    for b, base in enumerate(lengths.tolist()):
        for cache, scales, stage in ((k_cache, k_scale, k_stage), (v_cache, v_scale, v_stage)):
            rows = min(W, cache.shape[3] - base)
            x = stage[b, :, :, :rows].float()
            if cache.dtype == torch.int8:
                cache[:, b, :, base : base + rows], scales[:, b, :, base : base + rows] = (
                    _quantize_rows(x))
            else:
                cache[:, b, :, base : base + rows] = stage[b, :, :, :rows].to(cache.dtype)


def naive_flush_staging_paged(pool_k, pool_v, k_stage, v_stage, base_lens, page_table,
                              k_scale=None, v_scale=None):
    """In place, through the page table: staged row w of slot b and layer
    l goes to pool[l, table[b, g // page], :, g % page] with g =
    base_lens[b] + w, for all W rows (as the TPU flush writes them); rows
    past the table's last page are dropped. A slot with base_lens[b] == 0
    holds no request and is skipped: its table row may be stale and point
    at pages another slot or the prefix cache owns (the TPU flush writes
    it all the same; ROADMAP Queue 3). int8 pools quantize as
    naive_flush_staging does."""
    B, _, _, W, _ = k_stage.shape
    page = pool_k.shape[3]
    max_pages = page_table.shape[1]
    bases = base_lens.to(torch.int64).tolist()
    pairs = [(b, w) for b, base in enumerate(bases) if base > 0 for w in range(W)
             if (base + w) // page < max_pages]
    if not pairs:
        return
    dev = pool_k.device
    bi, wi = (torch.tensor(c, dtype=torch.int64, device=dev) for c in zip(*pairs))
    g = torch.tensor(bases, dtype=torch.int64, device=dev)[bi] + wi
    pid = page_table.to(dev).long()[bi, g // page]
    row = g % page
    for pool, scales, stage in ((pool_k, k_scale, k_stage), (pool_v, v_scale, v_stage)):
        x = stage[bi, :, :, wi]  # (N, nl, KH, E)
        if pool.dtype == torch.int8:
            pool[:, pid, :, row], scales[:, pid, :, row] = _quantize_rows(x.float())
        else:
            pool[:, pid, :, row] = x.to(pool.dtype)


def naive_write_kv_token(cache, new, positions):
    """In place: cache[b, :, positions[b]] = new[b, :, 0] for every b.
    cache (B, KH, S, D) (a scale cache has D = 1), new (B, KH, 1, D)."""
    B = cache.shape[0]
    idx = torch.arange(B, device=cache.device)
    cache[idx, :, positions.to(cache.device).long()] = new[:, :, 0].to(cache.dtype)


# ---- quantized products (nnop_tpu/ops/quantized_matmul.py) ---------------


def _compute_dtype(x):
    """bf16 products for 16-bit activations, f32 for f32 activations, as
    the TPU kernels pick (quantized_matmul.py:95)."""
    return torch.float32 if x.dtype == torch.float32 else torch.bfloat16


def naive_quantized_matmul(x, w: QTensor, out_dtype=None):
    """x (..., K) @ w (K, N) int8/fp8 with per-N scales: both operands in
    the compute dtype, fp32 accumulation, the scale applied once to the
    fp32 sum. Returns (..., N) in out_dtype (default x.dtype)."""
    ct = _compute_dtype(x)
    acc = x.to(ct).float() @ w.values.float().to(ct).float()
    return (acc * w.scale).to(out_dtype or x.dtype)


def naive_quantized_matmul4(x, w: QTensor4, out_dtype=None):
    """x (..., K) @ packed int4 w: each group scale folded into its
    weights in f32 and the result rounded to the compute dtype, then an
    fp32-accumulated product. K of x is zero-padded to the packed K."""
    ct = _compute_dtype(x)
    xp = torch.nn.functional.pad(x, (0, w.k_dim - x.shape[-1]))
    wd = (unpack4(w).float() * w.scale.repeat_interleave(w.group, dim=0)).to(ct)
    return (xp.to(ct).float() @ wd.float()).to(out_dtype or x.dtype)


def quantize_act(x):
    """Per-row symmetric int8 activation quantization (plain in the JAX
    package too): x (..., K) -> (values int8 (..., K), scale (..., 1) f32)."""
    xf = x.float()
    scale = div_exact(torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8), INT8_MAX)
    values = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    return values, scale


def naive_quantized_matmul_w8a8(xv, xs, w: QTensor, out_dtype=torch.bfloat16):
    """int8 activations xv (..., K) with per-row scales xs (..., 1) times
    int8 weights: the integer product exactly (in float64: K * 127^2 is
    far beyond f32's 2^24 but inside f64's 2^53), rounded to f32 as an
    int32 sum is, then (acc * xs) * ws in f32."""
    acc = (xv.double() @ w.values.double()).float()
    return (acc * xs.float() * w.scale).to(out_dtype)


# ---- grouped (MoE) products (nnop_tpu/ops/grouped_matmul.py) -------------


def _per_expert(block_groups, block_m: int, shape, out_dtype, device, product):
    """An (Tp, N) output whose rows of block b are product(sel, e) for e =
    block_groups[b], with sel the boolean mask of all expert e's rows: one
    product per expert. Selecting the rows syncs the host (a plain version
    may)."""
    row_expert = block_groups.to(device).long().repeat_interleave(block_m)
    out = torch.zeros(shape, dtype=out_dtype, device=device)
    for e in torch.unique(row_expert).tolist():
        sel = row_expert == e
        out[sel] = product(sel, e).to(out_dtype)
    return out


def naive_grouped_matmul(x, w, block_groups, block_m: int):
    """x (Tp, K) expert-sorted rows @ w (E, K, N) per block: both operands
    in the compute dtype, fp32 accumulation. Returns (Tp, N) in x.dtype."""
    ct = _compute_dtype(x)
    return _per_expert(block_groups, block_m, (x.shape[0], w.shape[2]), x.dtype, x.device,
                       lambda sel, e: x[sel].to(ct).float() @ w[e].to(ct).float())


def naive_grouped_matmul_dw(x, dy, block_groups, block_m: int, n_experts: int,
                            block_rows=None):
    """The grouped product's weight gradient: dw[e] = the sum over expert
    e's blocks of x_b^T dy_b, x (Tp, K) and dy (Tp, N) in the compute
    dtype, fp32 sums; (E, K, N) in x.dtype, exact zeros for an expert with
    no row. block_rows: the real rows of each block (rows past them count
    as zero)."""
    ct = _compute_dtype(x)
    Tp, K = x.shape
    row_expert = block_groups.to(x.device).long().repeat_interleave(block_m)
    if block_rows is not None:
        real = torch.arange(block_m, device=x.device)[None] < block_rows.to(x.device)[:, None]
        row_expert = torch.where(real.reshape(-1), row_expert, -1)
    dw = torch.zeros((n_experts, K, dy.shape[1]), dtype=x.dtype, device=x.device)
    for e in range(n_experts):
        sel = row_expert == e
        dw[e] = (x[sel].to(ct).float().T @ dy[sel].to(ct).float()).to(x.dtype)
    return dw


def naive_grouped_matmul_quantized(x, w: QTensor, block_groups, block_m: int, out_dtype=None):
    """Grouped naive_quantized_matmul: w values (E, K, N) int8 with scale
    (E, N) (axis 1)."""
    out_dtype = out_dtype or x.dtype
    return _per_expert(block_groups, block_m, (x.shape[0], w.values.shape[2]), out_dtype,
                       x.device, lambda sel, e: naive_quantized_matmul(
                           x[sel], QTensor(w.values[e], w.scale[e], 0), out_dtype))


def naive_grouped_matmul_w8a8(xv, xs, w: QTensor, block_groups, block_m: int,
                              out_dtype=torch.bfloat16):
    """Grouped naive_quantized_matmul_w8a8: int8 rows xv (Tp, K) with
    scales xs (Tp, 1), w values (E, K, N) int8 with scale (E, N)."""
    return _per_expert(block_groups, block_m, (xv.shape[0], w.values.shape[2]), out_dtype,
                       xv.device, lambda sel, e: naive_quantized_matmul_w8a8(
                           xv[sel], xs[sel], QTensor(w.values[e], w.scale[e], 0), out_dtype))


def naive_grouped_matmul4(x, w: QTensor4, block_groups, block_m: int, out_dtype=None):
    """Grouped naive_quantized_matmul4: w packed (E, Kp/2, N), scale (E,
    Kp/group, N)."""
    out_dtype = out_dtype or x.dtype
    return _per_expert(block_groups, block_m, (x.shape[0], w.packed.shape[2]), out_dtype,
                       x.device, lambda sel, e: naive_quantized_matmul4(
                           x[sel], QTensor4(w.packed[e], w.scale[e], w.group, w.pack_block),
                           out_dtype))
