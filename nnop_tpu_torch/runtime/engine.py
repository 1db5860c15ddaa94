"""Inference engine: chunked staged decode + continuous batching, linear
or paged KV.

Counterpart of nnop_tpu/runtime/engine.py for floating-point or quantized
weights (int8/fp8 and packed int4, models/quantized.py), dense or
mixture-of-experts (Mixtral: every MoE layer takes the grouped expert
path, models/moe.py, on kernel I) layers, and a floating-point or int8 KV
cache, held per slot (linear) or in a shared page pool (`paged`). The
design is the JAX engine's, so greedy token streams match it token for
token:

* `make_decode_chunk` runs `chunk_size` decode steps per dispatch. Each
  step writes its K/V token into a bf16 STAGING buffer (in place), and
  the decode kernel attends cache + staging; at chunk end one
  `flush_staging` writes the staged rows into the stacked cache.
* The KV cache holds all layers as stacked tensors (n_layers, B, KH, S, E);
  the decode kernel takes the layer index, so no layer slice is copied.
* Continuous batching over fixed B slots. Short prompts prefill at a
  power-of-two bucket; prompts longer than `prefill_chunk` admit in
  chunks through the offset-aware causal kernel into a live K/V buffer,
  `prefill_chunks_per_step` chunks per engine step, while other slots
  keep decoding.
* Pipelined collection: PyTorch launches are asynchronous, so the host
  enqueues the next chunk while the card runs the previous one, and
  `_collect` reads tokens one chunk late (`pipeline_depth=2`).
* Quantized weights run through the fused-dequant products (`qmatmul`):
  weight-only at decode, and W8A8 (per-row int8 activations) for the
  prefill products of at least 256 rows when `w8a8` (the default); the
  lm_head stays weight-only. `quantized_kv` keeps int8 caches with one
  f32 scale per token: admission quantizes the prefilled rows, the flush
  quantizes the staged ones, and decode attention dequantizes.
* `paged`: the KV lives in pools (n_layers, n_pages, KH, page, E) shared
  by all slots; a host allocator hands each slot pages for its length
  plus the flush's slack, and a page table (B, max_pages) on the device
  leads the paged decode attention and the paged flush to them. The
  host mirrors the lengths, so page growth needs no device read, and
  rewrites a slot's table row only when the slot's page list changes.
  `prefix_cache` shares the pages of a page-aligned prompt prefix between
  requests (refcounted): a hit reads the shared K/V back and prefills only
  the remainder.

* `spec_k` (linear caches): speculative decoding. `make_spec_chunk` runs
  `chunk_size` verify steps per dispatch; each drafts `spec_k` tokens by
  prompt lookup (`ngram_draft`) from a token history on the device, runs
  ONE forward over T = spec_k + 1 tokens whose K/V go to staging rows [0,
  T) (decode attention's verify mode, kernel D with T > 1), accepts the
  longest argmax-matching prefix (greedy) or rejection-samples
  (`spec_accept`), and flushes; the staging is the rollback, as rejected
  rows land past the new length. Greedy streams equal plain decoding's.
* `logprobs`: each emitted token's log-probability under the f32 logits,
  in `Request.logprobs` and the server's answer (not with `spec_k`, as
  in the JAX engine).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from nnop_tpu_torch.models.llama import LlamaConfig, _merge_heads, _split_heads, act_fn
from nnop_tpu_torch.models.moe import moe_mlp
from nnop_tpu_torch.models.quantized import qmatmul
from nnop_tpu_torch.ops.attention_decode import decode_attention
from nnop_tpu_torch.ops.attention_decode_paged import paged_decode_attention
from nnop_tpu_torch.ops.flash_attention import flash_attention, flash_attention_chunked
from nnop_tpu_torch.ops.kv_write import flush_staging, flush_staging_paged
from nnop_tpu_torch.ops.quantization import INT8_MAX, QTensor, QTensor4, div_exact
from nnop_tpu_torch.ops.rms_norm import rms_norm
from nnop_tpu_torch.ops.rope import RotaryEmbedding, llama_rope

STAGE_W = 32  # staging capacity (rows per slot and layer); chunk_size may be less
PAGE_SLACK = STAGE_W + 128  # pages a paged slot holds past its length (the JAX engine's)


# ---- family-aware building blocks (shared by every engine path) --------
# Products go through models.quantized.qmatmul: QTensor / QTensor4 weights
# to the fused-dequant kernels, plain weights to x @ w. w8a8 is the
# prefill builders' explicit flag (the JAX engine's _W8A8 context
# variable): int8 products of >= 256 rows run W8A8.


def _embed_tokens(params, cfg: LlamaConfig, tokens):
    x = params["embed"][tokens]
    if cfg.embed_scale is not None:
        x = (x.float() * cfg.embed_scale).to(x.dtype)
    return x


def _lm_logits(params, cfg: LlamaConfig, x):
    if cfg.tie_embeddings:
        logits = (x @ params["embed"].T).float()
    else:
        # weight-only even under w8a8: the logits are the most
        # argmax-sensitive product
        logits = qmatmul(x, params["lm_head"]).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _layer_qkv(layer, h, cfg: LlamaConfig, w8a8: bool = False):
    """Q/K/V projections through the fused wqkv (+ the Qwen2 bias)."""
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    qkv = qmatmul(h, layer["wqkv"], w8a8=w8a8)
    if "bqkv" in layer:
        qkv = qkv + layer["bqkv"]
    xq, xk, xv = qkv[..., :qd], qkv[..., qd : qd + kvd], qkv[..., qd + kvd :]
    q = _split_heads(xq, cfg.n_heads, cfg.head_dim)
    k = _split_heads(xk, cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(xv, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _post_norm(layer, out, cfg: LlamaConfig, key: str):
    """Gemma-2 post-norm on the sublayer OUTPUT, pre-residual."""
    if cfg.post_norms:
        return rms_norm(out, layer[key], cfg.rms_eps, offset=cfg.rms_offset)
    return out


def _attn_out(layer, o, x, cfg: LlamaConfig, w8a8: bool = False):
    """Output projection + optional post-norm + residual add."""
    out = qmatmul(_merge_heads(o.to(x.dtype)), layer["wo"], w8a8=w8a8)
    return x + _post_norm(layer, out, cfg, "attn_post_norm")


def _layer_mlp(layer, x, cfg: LlamaConfig, w8a8: bool = False):
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_eps, offset=cfg.rms_offset)
    if "w_router" in layer:  # MoE (Mixtral): the grouped expert path, kernel I
        B, L, d = h.shape
        out, _ = moe_mlp(layer, h.reshape(B * L, d), cfg, act=lambda g: act_fn(cfg, g),
                         impl="grouped", w8a8=w8a8)
        return x + _post_norm(layer, out.reshape(B, L, d).to(x.dtype), cfg, "mlp_post_norm")
    gu = qmatmul(h, layer["w_gateup"], w8a8=w8a8).float()
    gate = act_fn(cfg, gu[..., : cfg.hidden_dim])
    up = gu[..., cfg.hidden_dim :]
    out = qmatmul((gate * up).to(x.dtype), layer["w_down"], w8a8=w8a8)
    return x + _post_norm(layer, out, cfg, "mlp_post_norm")


def _forward_layers(params, cfg: LlamaConfig, x, cos, sin, attend, w8a8: bool = False):
    """The decoder stack + final norm + logits, shared by prefill, chunked
    prefill and decode. attend(li, q, k, v) -> o runs layer li's attention
    with whatever K/V bookkeeping the caller's path needs."""
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.rms_eps, offset=cfg.rms_offset)
        q, k, v = _layer_qkv(layer, h, cfg, w8a8)
        q, k = llama_rope(q, k, cos, sin)
        x = _attn_out(layer, attend(li, q, k, v), x, cfg, w8a8)
        x = _layer_mlp(layer, x, cfg, w8a8)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, offset=cfg.rms_offset)
    return _lm_logits(params, cfg, x)


@dataclasses.dataclass
class EngineState:
    """Device-side state, updated in place.

    `lengths` counts FLUSHED tokens (the valid cache prefix); tokens
    generated inside the current decode chunk live in the bf16 staging
    buffers until `flush_staging` moves them into the caches at chunk end.
    An int8 cache carries one f32 scale per token in k_scale / v_scale.
    In paged mode k / v (and the scales) are POOLS (n_layers, n_pages, KH,
    page, E) and `page_table` holds each slot's page ids.
    """

    k: torch.Tensor  # (n_layers, B, KH, S, E) cfg.dtype or int8
    v: torch.Tensor
    lengths: torch.Tensor  # (B,) int32
    last_token: torch.Tensor  # (B,) int64
    k_stage: torch.Tensor  # (B, n_layers, KH, STAGE_W, E) bf16
    v_stage: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # (n_layers, B, KH, S) f32, int8 cache only
    v_scale: Optional[torch.Tensor] = None
    page_table: Optional[torch.Tensor] = None  # (B, max_pages) int32, paged only


def init_state(cfg: LlamaConfig, batch: int, max_seq: int, device,
               quantized: bool = False) -> EngineState:
    """Linear caches: (n_layers, batch, KH, max_seq, E) per slot."""
    return _init_state(cfg, batch, (batch, max_seq), device, quantized)


def init_state_paged(cfg: LlamaConfig, batch: int, n_pages: int, page_size: int,
                     max_pages: int, device, quantized: bool = False) -> EngineState:
    """Paged: pools (n_layers, n_pages, KH, page_size, E) and a zero page
    table (batch, max_pages)."""
    state = _init_state(cfg, batch, (n_pages, page_size), device, quantized)
    state.page_table = torch.zeros((batch, max_pages), dtype=torch.int32, device=device)
    return state


def _init_state(cfg: LlamaConfig, batch: int, blocks: tuple[int, int], device,
                quantized: bool) -> EngineState:
    """blocks = (n_blocks, rows): the caches are (n_layers, n_blocks, KH,
    rows, E), one block per slot (linear) or per page (paged)."""
    nl, kh, e = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    n_blocks, rows = blocks

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache_dtype = torch.int8 if quantized else cfg.dtype
    return EngineState(
        k=zeros((nl, n_blocks, kh, rows, e), cache_dtype),
        v=zeros((nl, n_blocks, kh, rows, e), cache_dtype),
        lengths=zeros((batch,), torch.int32),
        last_token=zeros((batch,), torch.int64),
        k_stage=zeros((batch, nl, kh, STAGE_W, e), torch.bfloat16),
        v_stage=zeros((batch, nl, kh, STAGE_W, e), torch.bfloat16),
        k_scale=zeros((nl, n_blocks, kh, rows), torch.float32) if quantized else None,
        v_scale=zeros((nl, n_blocks, kh, rows), torch.float32) if quantized else None,
    )


def _quant_token(x):
    """Per-token symmetric int8 over the last axis (the JAX engine's
    admission quantizer): x (..., L, E) -> (int8 values, f32 scales
    (..., L))."""
    xf = x.float()
    scale = div_exact(torch.clamp(xf.abs().amax(dim=-1), min=1e-8), INT8_MAX)
    q = torch.clamp(torch.round(xf / scale[..., None]), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def filtered_logits(logits, temperature: float, top_k: int = 0,
                    top_p: float = 1.0, min_p: float = 0.0):
    """Temperature/top-k/top-p/min-p filtered logits (B, V): softmax of the
    result is the sampling distribution. top_p keeps the smallest prefix
    of the descending-probability order with mass >= top_p (the top-1
    token always survives); min_p drops tokens whose probability is below
    min_p * max-probability."""
    scaled = logits / temperature
    neg = torch.full_like(scaled, -math.inf)
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= kth, scaled, neg)
    if min_p > 0.0:
        # p >= min_p * pmax  <=>  logit >= max_logit + log(min_p)
        cut = scaled.amax(dim=-1, keepdim=True) + math.log(min_p)
        scaled = torch.where(scaled >= cut, scaled, neg)
    if top_p < 1.0:
        desc = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        exclusive = torch.cumsum(probs, dim=-1) - probs
        kept = torch.where(exclusive < top_p, desc, torch.full_like(desc, math.inf))
        cutoff = kept.amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled >= cutoff, scaled, neg)
    return scaled


def sample_tokens(logits, generator: Optional[torch.Generator], temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0):
    """Greedy (temperature 0) or filtered sampling; logits (B, V) -> (B,)
    int64. Sampling draws from `generator` (exponential race: argmax of
    p / Exp(1) is a draw from p), with no host sync."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(filtered_logits(logits, temperature, top_k, top_p, min_p), dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return (probs / race).argmax(dim=-1)


def spec_accept(fl, drafts, generator: Optional[torch.Generator]):
    """Leviathan-style rejection-sampling verify for deterministic drafts
    (nnop_tpu/runtime/engine.py:spec_accept).

    fl: (B, T, V) filtered logits at each of the T = k + 1 positions
    (softmax(fl[:, i]) is the target distribution of the token after input
    i); drafts: (B, k) int64. Draft i is accepted with probability
    p_i(d_i); on the first rejection the replacement is drawn from p_c
    with d_c removed, and when all k are accepted the bonus token from
    p_k. The emitted tokens follow sequential sampling from p exactly;
    the drafts change only how many come per step. Draws from `generator`
    on the device, with no host sync.

    Returns (c (B,) int64 accepted-draft counts, final (B,) int64 the
    replacement or bonus token).
    """
    B, T, V = fl.shape
    k = T - 1
    p = torch.softmax(fl, dim=-1)
    u = torch.rand((B, k), generator=generator, device=fl.device)
    p_draft = p[:, :k].gather(2, drafts[..., None])[..., 0]  # (B, k)
    c = (u < p_draft).long().cumprod(dim=1).sum(dim=1)  # the first rejection
    fl_c = fl.gather(1, c[:, None, None].expand(B, 1, V))[:, 0]  # (B, V)
    d_c = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1).gather(1, c[:, None])
    # the residual: the rejected draft's mass removed (only when c < k)
    rejected = torch.zeros_like(fl_c, dtype=torch.bool).scatter_(1, d_c, True) & (c < k)[:, None]
    probs = torch.softmax(fl_c.masked_fill(rejected, -math.inf), dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return c, (probs / race).argmax(dim=-1)


def _cat_columns(ws):
    """Concatenate weights along N, their last axis: (K, N_i) projections
    or stacked (E, K, N_i) experts, as plain tensors, QTensors (values and
    scales, whose last axis is N too) or QTensor4s (packed planes and
    group scales; the same K packing for all)."""
    if isinstance(ws[0], QTensor):
        return QTensor(torch.cat([w.values for w in ws], dim=-1),
                       torch.cat([w.scale for w in ws], dim=-1), ws[0].axis)
    if isinstance(ws[0], QTensor4):
        return QTensor4(torch.cat([w.packed for w in ws], dim=-1),
                        torch.cat([w.scale for w in ws], dim=-1), ws[0].group, ws[0].pack_block)
    return torch.cat(ws, dim=-1)


def _fuse_layer(layer):
    if "wqkv" in layer:  # fused already
        return layer
    fused = {k: v for k, v in layer.items()
             if k not in ("wq", "wk", "wv", "w_gate", "w_up", "bq", "bk", "bv")}
    fused["wqkv"] = _cat_columns([layer["wq"], layer["wk"], layer["wv"]])
    fused["w_gateup"] = _cat_columns([layer["w_gate"], layer["w_up"]])
    if "bq" in layer:
        fused["bqkv"] = torch.cat([layer["bq"], layer["bk"], layer["bv"]])
    return fused


def fuse_decode_weights(params, *, in_place: bool = False):
    """Concatenate per-layer projections for fewer launches in decode:
    wq|wk|wv -> wqkv and w_gate|w_up -> w_gateup (biases too; a MoE
    layer's stacked experts fuse along N, as the JAX engine's
    cat_experts does). Layers fused already pass through, so fusing
    twice changes nothing.

    in_place: replace the layers of `params` one at a time, so that each
    layer's unfused weights are freed once it is fused (when nothing else
    holds them): the copies cost one layer of memory, not the model's
    gate and up weights again (30 GB for int8 Mixtral-8x7B)."""
    if in_place:
        layers = params["layers"]
        for i in range(len(layers)):
            layers[i] = _fuse_layer(layers[i])
        return params
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [_fuse_layer(layer) for layer in params["layers"]]
    return out


def make_decode_chunk(cfg: LlamaConfig, chunk: int, temperature: float = 0.0,
                      top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
                      paged: bool = False, page_size: int = 0, logprobs: bool = False):
    """The engine fast path: `chunk` decode steps per call.

    Returns chunk_fn(params, state, generator) -> tokens (chunk, B) int64,
    or with `logprobs` (tokens, lps (chunk, B) f32), each sampled token's
    log_softmax of its step's f32 logits; updating `state` in place:
    staging rows, the flushed caches (pools through `state.page_table`
    when `paged`), lengths (+chunk for live slots) and last_token. Takes
    fused params (fuse_decode_weights).
    """
    rope = RotaryEmbedding(cfg.head_dim, cfg.rope_base, scaling=cfg.rope_scaling)

    @torch.no_grad()
    def chunk_fn(params, state: EngineState, generator):
        toks = torch.empty((chunk, state.lengths.shape[0]), dtype=torch.int64,
                           device=state.lengths.device)
        lps = torch.empty(toks.shape, dtype=torch.float32, device=toks.device) if logprobs else None
        last = state.last_token
        for i in range(chunk):

            def attend(li, q, k, v):
                # (B, KH, 1, E) -> staging row i of layer li, in place
                state.k_stage[:, li, :, i] = k[:, :, 0]
                state.v_stage[:, li, :, i] = v[:, :, 0]
                kw = dict(k_stage=state.k_stage, v_stage=state.v_stage, staged_n=i + 1,
                          layer=li, window=cfg.layer_window(li), softcap=cfg.attn_softcap,
                          scale=cfg.attn_scale)
                if paged:
                    return paged_decode_attention(q, state.k, state.v, state.page_table,
                                                  state.lengths, state.k_scale, state.v_scale,
                                                  **kw)
                return decode_attention(q, state.k, state.v, state.lengths, state.k_scale,
                                        state.v_scale, **kw)

            cos, sin = rope((state.lengths + i)[:, None])
            x = _embed_tokens(params, cfg, last[:, None])
            logits = _forward_layers(params, cfg, x, cos, sin, attend)[:, 0]
            last = sample_tokens(logits, generator, temperature, top_k, top_p, min_p)
            toks[i] = last
            if logprobs:
                lps[i] = torch.log_softmax(logits, dim=-1).gather(1, last[:, None])[:, 0]
        if paged:
            flush_staging_paged(state.k, state.v, state.k_scale, state.v_scale, state.k_stage,
                                state.v_stage, state.lengths, state.page_table, page_size)
        else:
            flush_staging(state.k, state.v, state.k_scale, state.v_scale, state.k_stage,
                          state.v_stage, state.lengths)
        state.lengths += (state.lengths > 0).to(torch.int32) * chunk
        state.last_token = last
        return (toks, lps) if logprobs else toks

    return chunk_fn


def ngram_draft(history, vlen, k: int):
    """Prompt-lookup drafting (nnop_tpu/runtime/engine.py:ngram_draft):
    continue the most recent earlier occurrence of the trailing bigram.

    history: (B, S) int32 tokens, positions [0, vlen) valid; vlen: (B,)
    int32. Returns (B, k) int64 drafts; where no earlier occurrence exists,
    or its continuation runs past vlen, the last token repeated (the verify
    then rejects: drafts change only how many tokens come per step). Torch
    ops on the device, no host read.
    """
    B, S = history.shape
    h = history.long()
    vlen = vlen.long()[:, None]
    pos = torch.arange(S, device=h.device)[None]
    a = h.gather(1, (vlen - 2).clamp(min=0))
    b = h.gather(1, (vlen - 1).clamp(min=0))
    prev = torch.roll(h, 1, dims=1)  # prev[:, p] = h[:, p - 1]
    match = (prev == a) & (h == b) & (pos >= 1) & (pos < vlen - 1)
    idx = torch.where(match, pos, -1).amax(dim=1, keepdim=True)  # the most recent match
    dpos = (idx + 1).clamp(0, S - k) + torch.arange(k, device=h.device)[None]
    ok = (idx >= 0) & (dpos < vlen)
    return torch.where(ok, h.gather(1, dpos), b)


def make_spec_chunk(cfg: LlamaConfig, n_steps: int, spec_k: int, temperature: float = 0.0,
                    top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
                    with_logits: bool = False):
    """Speculative decode chunk (nnop_tpu/runtime/engine.py:make_spec_chunk):
    `n_steps` verify steps per call on a linear cache. Each step drafts
    `spec_k` tokens (ngram_draft over the history), writes [last, d_1..d_k]
    to the history and runs ONE forward over those T = spec_k + 1 tokens:
    each layer writes their K/V to staging rows [0, T) and decode attention
    runs its verify mode (staged_n = T, the intra-draft causal mask).
    Greedy accepts the longest argmax-matching prefix; sampling goes
    through spec_accept on the filtered logits. The staging then flushes
    at the old lengths, which advance by (c + 1) for live slots: rejected
    rows land past the new length and the next flush overwrites them.

    Returns chunk_fn(params, state, history, generator) -> (emitted
    (n_steps, B, T) int64, counts (n_steps, B) int32) on the device, with
    `state` and `history` ((B, S) int32) updated in place; with_logits
    adds each step's verify logits (n_steps, B, T, V) f32 as a third
    output (the engine never asks for them). Raises ValueError when T
    exceeds the staging (STAGE_W rows).
    """
    T = spec_k + 1
    if T > STAGE_W:
        raise ValueError(f"spec_k + 1 must be <= STAGE_W ({STAGE_W})")
    rope = RotaryEmbedding(cfg.head_dim, cfg.rope_base, scaling=cfg.rope_scaling)

    @torch.no_grad()
    def chunk_fn(params, state: EngineState, history, generator):
        B = state.lengths.shape[0]
        dev = state.lengths.device
        jT = torch.arange(T, device=dev)
        out_toks = torch.empty((n_steps, B, T), dtype=torch.int64, device=dev)
        out_counts = torch.empty((n_steps, B), dtype=torch.int32, device=dev)
        out_logits = []
        for i in range(n_steps):
            lens = state.lengths.long()
            active = lens > 0
            history.scatter_(1, lens[:, None], state.last_token[:, None].to(history.dtype))
            drafts = ngram_draft(history, state.lengths + 1, spec_k)
            tokens_in = torch.cat([state.last_token[:, None], drafts], dim=1)  # (B, T)
            history.scatter_(1, lens[:, None] + jT[None], tokens_in.to(history.dtype))

            def attend(li, q, k, v):
                # the T tokens' K/V (B, KH, T, E) -> staging rows [0, T) of layer li
                state.k_stage[:, li, :, :T] = k
                state.v_stage[:, li, :, :T] = v
                return decode_attention(q, state.k, state.v, state.lengths, state.k_scale,
                                        state.v_scale, k_stage=state.k_stage,
                                        v_stage=state.v_stage, staged_n=T, layer=li,
                                        window=cfg.layer_window(li), softcap=cfg.attn_softcap,
                                        scale=cfg.attn_scale)

            cos, sin = rope(lens[:, None] + jT[None])
            logits = _forward_layers(params, cfg, _embed_tokens(params, cfg, tokens_in), cos,
                                     sin, attend)  # (B, T, V)
            if with_logits:
                out_logits.append(logits.float())
            if temperature <= 0.0:
                m = logits.argmax(dim=-1)
                c = (drafts == m[:, :spec_k]).long().cumprod(dim=1).sum(dim=1)
                m_at_c = m.gather(1, c[:, None])[:, 0]
            else:
                V = logits.shape[-1]
                fl = filtered_logits(logits.reshape(-1, V), temperature, top_k, top_p,
                                     min_p).reshape(B, T, V)
                c, m_at_c = spec_accept(fl, drafts, generator)
            drafts_ext = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
            cc = c[:, None]
            out_toks[i] = torch.where(jT[None] < cc, drafts_ext,
                                      torch.where(jT[None] == cc, m_at_c[:, None], 0))
            n_emit = ((c + 1) * active).to(torch.int32)
            out_counts[i] = n_emit
            flush_staging(state.k, state.v, state.k_scale, state.v_scale, state.k_stage,
                          state.v_stage, state.lengths)
            state.lengths += n_emit
            state.last_token = torch.where(active, m_at_c, state.last_token)
        if with_logits:
            return out_toks, out_counts, torch.stack(out_logits)
        return out_toks, out_counts

    return chunk_fn


def make_prefill_unrolled(cfg: LlamaConfig, *, w8a8: bool = False):
    """Prefill over the fused params the decode uses, so the engine holds
    one copy of the weights. Returns
    prefill(params, tokens (B, L)) -> (logits (B, L, V),
    k (nl, B, KH, L, E), v). w8a8: int8 products of >= 256 rows run W8A8."""
    rope = RotaryEmbedding(cfg.head_dim, cfg.rope_base, scaling=cfg.rope_scaling)

    @torch.no_grad()
    def prefill(params, tokens):
        B, L = tokens.shape
        ks, vs = [], []

        def attend(li, q, k, v):
            ks.append(k)
            vs.append(v)
            return flash_attention(q, k, v, causal=True, window=cfg.layer_window(li),
                                   softcap=cfg.attn_softcap, scale=cfg.attn_scale)

        cos, sin = rope(torch.arange(L, device=tokens.device).expand(B, L))
        logits = _forward_layers(params, cfg, _embed_tokens(params, cfg, tokens), cos, sin,
                                 attend, w8a8)
        return logits, torch.stack(ks), torch.stack(vs)

    return prefill


def make_prefill_chunk_step(cfg: LlamaConfig, *, w8a8: bool = False):
    """CHUNKED prefill into a live K/V buffer: one chunk of the prompt
    whose rows start at `offset`, attending the K/V of all previous
    chunks through the offset-aware causal kernel (row i sees buffer
    cols <= offset + i).

    step(params, tokens_c (1, C), ks_buf, vs_buf (nl, 1, KH, S, E) bf16,
         offset) -> (chunk logits (1, C, V), ks_buf, vs_buf); the buffers
    are written in place. w8a8: int8 products of >= 256 rows run W8A8.
    """
    rope = RotaryEmbedding(cfg.head_dim, cfg.rope_base, scaling=cfg.rope_scaling)

    @torch.no_grad()
    def step(params, tokens_c, ks_buf, vs_buf, offset: int):
        B, C = tokens_c.shape
        dev = tokens_c.device
        valid = (torch.arange(ks_buf.shape[3], device=dev) < offset + C)[None]  # (1, S)

        def attend(li, q, k, v):
            # the chunk's K/V rows of layer li, in place, as bf16
            ks_buf[li, :, :, offset : offset + C] = k
            vs_buf[li, :, :, offset : offset + C] = v
            return flash_attention_chunked(
                q, ks_buf[li].to(q.dtype), vs_buf[li].to(q.dtype),
                causal_offset=offset, kpad_mask=valid, window=cfg.layer_window(li),
                softcap=cfg.attn_softcap, scale=cfg.attn_scale,
            )

        cos, sin = rope(offset + torch.arange(C, device=dev).expand(B, C))
        logits = _forward_layers(params, cfg, _embed_tokens(params, cfg, tokens_c), cos, sin,
                                 attend, w8a8)
        return logits, ks_buf, vs_buf

    return step


class QueueFullError(Exception):
    """Raised by Engine.submit when the pending queue is at max_queue —
    the serving front-end maps this to HTTP 429."""


@dataclasses.dataclass(eq=False)  # identity semantics: two requests with
# equal payloads are still distinct queue entries (cancel uses `in`/`is`)
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    out: list[int] = dataclasses.field(default_factory=list)
    # each token of `out`'s log-probability (Engine(logprobs=True) only)
    logprobs: list[float] = dataclasses.field(default_factory=list)
    done: bool = False
    # stop sequences (token-id lists): generation ends when the output
    # tail matches one; the matched tokens are removed from `out`
    stop: list[list[int]] = dataclasses.field(default_factory=list)
    # stop STRINGS, matched on decoded text (BPE is context-dependent, so
    # the same text can arrive under different token ids). Requires a
    # tokenizer.
    stop_texts: list[str] = dataclasses.field(default_factory=list)
    # incremental stop-string matcher state: decoded bytes of `out` so far
    # and each token's decoded byte length (both tokenizers decode by
    # per-token byte concatenation, so byte-level matching is exact)
    _dec_bytes: bytearray = dataclasses.field(default_factory=bytearray, repr=False)
    _piece_lens: list[int] = dataclasses.field(default_factory=list, repr=False)
    cancelled: bool = False


def _check_params(params):
    """Floating-point tensors, or QTensor / QTensor4 projections."""
    leaves = [v for k, v in params.items() if k != "layers"]
    leaves += [v for layer in params["layers"] for v in layer.values()]
    for t in leaves:
        if not (isinstance(t, (QTensor, QTensor4))
                or (isinstance(t, torch.Tensor) and t.is_floating_point())):
            raise TypeError(f"unsupported parameter leaf {type(t).__name__}")


class Engine:
    """Continuous-batching inference engine (host scheduler, device state).

    Weight-fused unrolled layers, staged KV appends, and `chunk_size`
    tokens per dispatch (one host round-trip and one staging flush per
    chunk). The device is the one the params live on. `quantized_kv`:
    int8 KV caches with per-token scales; `w8a8`: W8A8 prefill products
    for int8 weights; `paged`: KV in shared page pools of `page_size`
    tokens (`n_pages` of them; both sized from max_seq and max_batch by
    default); `prefix_cache` (paged only): share prompt-prefix pages.
    `fuse_weights=False` takes params that are already fused;
    `interleave_prefill=False` admits a long prompt in one step instead of
    `prefill_chunks_per_step` chunks per step. `spec_k` > 0: speculative
    decoding with spec_k prompt-lookup drafts per verify step (linear
    caches; `spec_emitted` / `spec_verify_slots` is the measured tokens
    per verify step); `logprobs`: every token's log-probability in
    `Request.logprobs`. Neither goes with the other, nor spec_k with
    `paged` (ValueError, as in the JAX engine).
    """

    def __init__(self, params, cfg: LlamaConfig, *, max_batch=8, max_seq=2048,
                 quantized_kv=False, eos_id=None, tokenizer=None,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 min_p: float = 0.0, seed: int = 0, chunk_size: int = 8,
                 fuse_weights: bool = True, logprobs: bool = False, paged: bool = False,
                 page_size: Optional[int] = None, n_pages: Optional[int] = None,
                 prefill_chunk: int = 512, prefill_chunks_per_step: int = 4,
                 pipeline_depth: int = 2, spec_k: int = 0, prefix_cache: bool = False,
                 max_queue: int = 256, w8a8: bool = True, interleave_prefill: bool = True):
        if spec_k and paged:
            raise ValueError("spec decoding not supported with paged")
        if spec_k and logprobs:
            raise ValueError("logprobs not supported with spec decoding (the verify step keeps "
                             "only accepted-token ids)")
        if prefix_cache and not paged:
            raise ValueError("prefix_cache requires paged=True")
        _check_params(params)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.quantized = quantized_kv
        self.eos_id = eos_id
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.min_p = min_p
        self.logprobs = logprobs
        # speculative decoding: tokens emitted and verify steps metered per
        # slot (their ratio is the measured tokens per verify step)
        self.spec_k = spec_k
        self.spec_emitted = 0
        self.spec_verify_slots = 0
        if not 1 <= chunk_size <= STAGE_W:
            raise ValueError(f"chunk_size must be in [1, {STAGE_W}]")
        self.chunk_size = chunk_size
        self.device = params["embed"].device
        self.params = fuse_decode_weights(params) if fuse_weights else params
        # chunk-dispatch pipelining: keep (depth-1) chunks in flight and
        # collect their tokens one step late; EOS detection lags a chunk,
        # so a finishing slot wastes at most (depth-1) extra chunks. The
        # paged path allocates pages from host-tracked lengths, which
        # count on every chunk being collected: it stays unpipelined.
        self.paged = paged
        self.pipeline_depth = 1 if paged else max(1, pipeline_depth)
        self._inflight: list[tuple] = []
        # incremental admission: slot -> in-progress chunked-prefill state
        self.prefill_chunks_per_step = max(1, int(prefill_chunks_per_step))
        self.interleave_prefill = interleave_prefill
        self._admitting: dict[int, dict] = {}
        self._admit_rr = -1
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.max_queue = max_queue
        # paged-only prompt prefix cache: page-aligned token prefix ->
        # page ids, kept alive by a refcount per page
        self.prefix_cache = prefix_cache
        self._prefix_cache: dict[tuple, list[int]] = {}
        self._page_refs: dict[int, int] = {}
        self.prefix_hits = 0  # prompt tokens served from the cache
        if paged:
            if page_size is None:  # ~8 pages per max-length sequence
                page_size = min(512, max(128, -(-max_seq // 8 // 128) * 128))
            if page_size % 128 != 0:
                raise ValueError("page_size must be a multiple of 128")
            self.page_size = page_size
            self.max_pages = -(-(max_seq + PAGE_SLACK) // page_size) + 1
            self.n_pages = n_pages or max_batch * self.max_pages
            self.state = init_state_paged(cfg, max_batch, self.n_pages, page_size,
                                          self.max_pages, self.device, quantized_kv)
            self._free_pages = list(range(self.n_pages))
            self._slot_pages: list[list[int]] = [[] for _ in range(max_batch)]
            # host mirror of state.lengths: admission sets L, every
            # dispatched chunk adds chunk_size to slots with length > 0,
            # retire and cancel zero it; page growth reads it, not the card
            self._host_lens = [0] * max_batch
            # slots whose page list changed since the table was pushed
            self._dirty_table: set[int] = set()
        else:
            # the flush writes STAGE_W rows at each slot's length, and
            # inflight chunks can advance a finished slot (depth-1) chunks
            # past max_seq before collection zeroes it: pad for both. A
            # spec chunk advances a slot by up to chunk_size * (spec_k + 1)
            # tokens, and a finished slot runs to the end of its own chunk
            # too: pad spec decoding for depth such chunks.
            pad = STAGE_W + 32 + (self.pipeline_depth - 1) * chunk_size
            if spec_k:
                pad = STAGE_W + 32 + self.pipeline_depth * chunk_size * (spec_k + 1)
            alloc = -(-(max_seq + pad) // 32) * 32
            self.state = init_state(cfg, max_batch, alloc, self.device, quantized_kv)
            # the drafting history: each slot's tokens at their positions
            self._history = (torch.zeros((max_batch, alloc), dtype=torch.int32,
                                         device=self.device) if spec_k else None)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        if spec_k:
            self._chunk = make_spec_chunk(cfg, chunk_size, spec_k, temperature, top_k, top_p,
                                          min_p)
        else:
            self._chunk = make_decode_chunk(cfg, chunk_size, temperature, top_k, top_p, min_p,
                                            paged=paged, page_size=page_size if paged else 0,
                                            logprobs=logprobs)
        self._prefill = make_prefill_unrolled(cfg, w8a8=w8a8)
        self.prefill_chunk = prefill_chunk
        self._prefill_chunk_fn = make_prefill_chunk_step(cfg, w8a8=w8a8)
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.queue: list[Request] = []
        self._rid = 0

    def warmup(self, prompt_lengths=(512,)):
        """Run one dummy request per prompt length plus a decode chunk
        before taking traffic (builds the kernels, JIT-compiles the Triton
        kernels, warms the allocator), then reset the device state."""
        for L in sorted({int(x) for x in prompt_lengths}):
            # max_new_tokens must exceed the chunk size so a decode chunk
            # dispatches; keep the requested prefill length near max_seq
            L = max(1, min(L, self.max_seq - 2))
            mnt = max(1, min(self.chunk_size + 1, self.max_seq - L))
            self.submit([0] * L, max_new_tokens=mnt)
        while (self.queue or self._admitting or self._inflight
               or any(s is not None for s in self.slots)):
            self.step()
        self.state.lengths.zero_()
        self.state.k_stage.zero_()
        self.state.v_stage.zero_()
        if self.spec_k:
            self._history.zero_()
        if self.paged:
            # drop the dummy prompts' cached prefixes: their refs would pin
            # those pages out of the free list for the server's life
            self._evict_prefixes(self.n_pages)
            self._host_lens = [0] * self.max_batch
            for slot in range(self.max_batch):
                self._release_pages(slot)
        return self

    def submit(self, prompt: list[int], max_new_tokens: int = 32,
               stop: Optional[list[list[int]]] = None,
               stop_texts: Optional[list[str]] = None) -> Request:
        # validate BEFORE the queue-full check: a terminally-invalid
        # request must get its 400, not a retryable 429
        if len(prompt) + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_seq {self.max_seq}"
            )
        if stop_texts and not hasattr(self.tokenizer, "decode_bytes"):
            raise ValueError("stop_texts requires a tokenizer with decode_bytes")
        if len(self.queue) >= self.max_queue:
            raise QueueFullError(f"engine queue full ({len(self.queue)}/{self.max_queue})")
        req = Request(self._rid, prompt, max_new_tokens,
                      stop=[list(s) for s in (stop or []) if s],
                      stop_texts=[t for t in (stop_texts or []) if t])
        self._rid += 1
        self.queue.append(req)
        return req

    def submit_text(self, text: str, max_new_tokens: int = 32,
                    stop: Optional[list[str]] = None) -> Request:
        if self.tokenizer is None:
            raise ValueError("Engine was built without a tokenizer")
        # stops are matched on DECODED text, not token ids
        return self.submit(self.tokenizer.encode(text), max_new_tokens, stop_texts=stop)

    def decode_text(self, req: Request) -> str:
        if self.tokenizer is None:
            raise ValueError("Engine was built without a tokenizer")
        return self.tokenizer.decode(req.out)

    def cancel(self, req) -> bool:
        """Cancel a request by object or rid. Queued requests are dropped;
        active requests free their slot immediately (tokens already in
        `req.out` are kept). Tokens for the slot in inflight chunks are
        discarded by `_collect`. Returns True if the request was live."""
        if isinstance(req, int):
            rid = req
            req = next(
                (r for r in self.queue if r.rid == rid),
                next((r for r in self.slots if r is not None and r.rid == rid), None),
            )
            if req is None:
                return False
        if req.done:
            return False
        if req in self.queue:
            self.queue.remove(req)
            req.done = req.cancelled = True
            return True
        for slot, r in enumerate(self.slots):
            if r is req:
                req.done = req.cancelled = True
                self.slots[slot] = None
                self._admitting.pop(slot, None)
                self._retire_slot(slot)
                return True
        return False

    def _retire_slot(self, slot: int):
        """Zero a freed slot's length; in paged mode also its host length,
        and give its pages back."""
        self.state.lengths[slot] = 0
        if self.paged:
            self._host_lens[slot] = 0
            self._release_pages(slot)

    # ---- page bookkeeping (paged mode) -----------------------------------

    def _ensure_pages(self, slot: int, tokens_needed: int):
        """Give `slot` pages for `tokens_needed` tokens; mark its table row
        dirty only when a page was appended."""
        pages = self._slot_pages[slot]
        need = -(-tokens_needed // self.page_size)
        if len(pages) >= need:
            return
        while len(pages) < need:
            if not self._free_pages:
                self._evict_prefixes(1)
            if not self._free_pages:
                raise RuntimeError("page pool exhausted: raise n_pages or lower load")
            pid = self._free_pages.pop()
            self._page_refs[pid] = self._page_refs.get(pid, 0) + 1
            pages.append(pid)
        self._dirty_table.add(slot)

    def _flush_page_table(self):
        """Push the dirty slots' table rows to the device in one indexed
        copy, queued on the stream before the chunk that reads them (no
        host sync: the rows leave from pinned memory)."""
        if not self._dirty_table:
            return
        slots = sorted(self._dirty_table)
        self._dirty_table.clear()
        rows = torch.zeros((len(slots), 1 + self.max_pages), dtype=torch.int32)
        for i, s in enumerate(slots):
            rows[i, 0] = s
            rows[i, 1 : 1 + len(self._slot_pages[s])] = torch.tensor(self._slot_pages[s])
        if self.device.type == "cuda":
            rows = rows.pin_memory().to(self.device, non_blocking=True)
        self.state.page_table[rows[:, 0].long()] = rows[:, 1:]

    def _release_pages(self, slot: int):
        for pid in self._slot_pages[slot]:
            self._page_refs[pid] = self._page_refs.get(pid, 1) - 1
            if self._page_refs[pid] <= 0:
                self._free_pages.append(pid)
        self._slot_pages[slot] = []

    def _evict_prefixes(self, n_needed: int):
        """Drop the oldest cached prefixes until n_needed pages are free."""
        for key in list(self._prefix_cache):
            if len(self._free_pages) >= n_needed:
                break
            for pid in self._prefix_cache.pop(key):
                self._page_refs[pid] = self._page_refs.get(pid, 1) - 1
                if self._page_refs[pid] <= 0:
                    self._free_pages.append(pid)

    # ---- prompt prefix cache (paged mode) --------------------------------

    def _match_prefix(self, prompt: list[int]):
        """Longest cached page-aligned prefix of `prompt` that leaves >= 32
        tokens to prefill (the JAX engine's rule: its flush writes 32-row
        aligned windows around the length, so a shorter remainder would
        let the first flush write into the last SHARED page). Takes a ref
        on the matched pages. Returns (n tokens, page ids)."""
        pg = self.page_size
        for n in range(((len(prompt) - 32) // pg) * pg, 0, -pg):
            pages = self._prefix_cache.get(tuple(prompt[:n]))
            if pages is not None:
                for pid in pages:
                    self._page_refs[pid] = self._page_refs.get(pid, 0) + 1
                self.prefix_hits += n
                return n, list(pages)
        return 0, []

    def _insert_prefix(self, prompt: list[int], slot: int):
        """Publish the slot's pages of the longest page-aligned, flush-safe
        prefix of `prompt` (once per key)."""
        pg = self.page_size
        n = ((len(prompt) - 32) // pg) * pg
        key = tuple(prompt[:n])
        if n <= 0 or key in self._prefix_cache:
            return
        pages = self._slot_pages[slot][: n // pg]
        for pid in pages:
            self._page_refs[pid] = self._page_refs.get(pid, 0) + 1
        self._prefix_cache[key] = list(pages)

    def _gather_prefix_kv(self, pages: list[int], n: int):
        """Read `n` tokens of K/V out of pool pages as bf16
        (nl, 1, KH, n, E) buffers for the remainder prefill. The gather
        copies, so later writes to the pool cannot reach it."""
        ids = torch.tensor(pages, dtype=torch.long, device=self.device)

        def gather(pool, scale):
            x = pool[:, ids]  # (nl, npg, KH, pg, E)
            if scale is not None:
                x = x.float() * scale[:, ids][..., None]
            nl, npg, kh, pg, e = x.shape
            x = x.transpose(1, 2).reshape(nl, kh, npg * pg, e)
            return x[:, None, :, :n].to(torch.bfloat16)

        return (gather(self.state.k, self.state.k_scale),
                gather(self.state.v, self.state.v_scale))

    def _prefill_remainder(self, prompt: list[int], n_match: int, shared: list[int]):
        """A prefix hit's prefill: the shared pages' K/V as the context of
        the remainder's chunked prefill at offset n_match. Returns (the
        last prompt token's logits (1, V), ks, vs (nl, 1, KH, sbuf, E))."""
        pk, pv = self._gather_prefix_kv(shared, n_match)
        remainder = prompt[n_match:]
        C = self.prefill_chunk
        rem_chunks = -(-len(remainder) // C)
        nl, kh, e = self.cfg.n_layers, self.cfg.n_kv_heads, self.cfg.head_dim
        sbuf = n_match + rem_chunks * C
        ks = torch.zeros((nl, 1, kh, sbuf, e), dtype=torch.bfloat16, device=self.device)
        vs = torch.zeros_like(ks)
        ks[:, :, :, :n_match] = pk
        vs[:, :, :, :n_match] = pv
        logits = None
        for ci in range(rem_chunks):
            chunk = remainder[ci * C : (ci + 1) * C]
            chunk = chunk + [0] * (C - len(chunk))
            logits, ks, vs = self._prefill_chunk_fn(
                self.params, torch.tensor([chunk], device=self.device), ks, vs, n_match + ci * C)
        return logits[:, (len(remainder) - 1) - (rem_chunks - 1) * C], ks, vs

    def _admit_paged(self, slot: int, L: int, ks_l, vs_l, start: int = 0):
        """Write a prefilled prompt's K/V (nl, KH, >= L, E) into the slot's
        pages [start / page, ceil(L / page)) in one indexed copy per pool;
        the pages below `start` are shared prefix pages and are not
        rewritten. Rows past L in the last page are zeros until the flush
        writes them."""
        self._ensure_pages(slot, L + PAGE_SLACK)
        pg = self.page_size
        p0, n_live = -(-start // pg), -(-L // pg)
        ids = torch.tensor(self._slot_pages[slot][p0:n_live], dtype=torch.long,
                           device=self.device)
        pad = n_live * pg - L

        def pages_of(x):  # (nl, KH, L, ...) -> (nl, n_live - p0, KH, pg, ...)
            x = torch.nn.functional.pad(x[:, :, :L], (0, 0) * (x.ndim - 3) + (0, pad))
            x = x.reshape(x.shape[0], x.shape[1], n_live, pg, *x.shape[3:])
            return x[:, :, p0:].transpose(1, 2)

        for pool, scales, new in ((self.state.k, self.state.k_scale, ks_l),
                                  (self.state.v, self.state.v_scale, vs_l)):
            if self.quantized:
                q, sc = _quant_token(new[:, :, :L])
                pool[:, ids], scales[:, ids] = pages_of(q), pages_of(sc)
            else:
                pool[:, ids] = pages_of(new.to(pool.dtype))

    def _admit(self):
        """Assign queued requests to free slots and advance admission.

        Long prompts admit INCREMENTALLY: their chunked prefill is split
        across engine steps — `prefill_chunks_per_step` chunks per step(),
        round-robin over admitting slots — so active decode streams keep
        producing tokens while a long prompt admits (with
        interleave_prefill=False, every chunk in this step). Short prompts admit
        in one step, and so do prefix-cache hits (only the remainder is
        prefilled)."""
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            self.slots[slot] = req
            L = len(req.prompt)
            n_match, shared = self._match_prefix(req.prompt) if self.prefix_cache else (0, [])
            if not n_match and L > self.prefill_chunk:
                C = self.prefill_chunk
                n_chunks = -(-L // C)
                nl, kh, e = self.cfg.n_layers, self.cfg.n_kv_heads, self.cfg.head_dim
                buf = (nl, 1, kh, n_chunks * C, e)
                self._admitting[slot] = {
                    "req": req,
                    "ks": torch.zeros(buf, dtype=torch.bfloat16, device=self.device),
                    "vs": torch.zeros(buf, dtype=torch.bfloat16, device=self.device),
                    "ci": 0,
                    "n_chunks": n_chunks,
                    "L": L,
                    "logits": None,
                }
                continue
            self._admit_one(slot, req, L, n_match, shared)
        burst = 0
        while self._admitting:
            order = sorted(self._admitting)
            pick = next((s for s in order if s > self._admit_rr), order[0])
            self._admit_rr = pick
            st = self._admitting[pick]
            C = self.prefill_chunk
            ci = st["ci"]
            chunk = st["req"].prompt[ci * C : (ci + 1) * C]
            chunk = chunk + [0] * (C - len(chunk))
            st["logits"], st["ks"], st["vs"] = self._prefill_chunk_fn(
                self.params, torch.tensor([chunk], device=self.device),
                st["ks"], st["vs"], ci * C,
            )
            st["ci"] += 1
            if st["ci"] == st["n_chunks"]:
                del self._admitting[pick]
                L = st["L"]
                logits = st["logits"][:, (L - 1) - (st["n_chunks"] - 1) * C]
                self._finalize_admit(pick, st["req"], logits, st["ks"], st["vs"], L, 0)
            if self.interleave_prefill:
                burst += 1
                if burst >= self.prefill_chunks_per_step:
                    break

    def _admit_one(self, slot, req, L, n_match=0, shared=()):
        """Single-step admission, then finalize: a prefix hit seeds the
        slot with the shared pages and prefills only the remainder;
        otherwise the prompt prefills padded to a power-of-two bucket (at
        least 64)."""
        if n_match:
            self._slot_pages[slot] = list(shared)
            self._dirty_table.add(slot)  # the row must show the adopted pages
            logits, ks, vs = self._prefill_remainder(req.prompt, n_match, shared)
            self._admit_paged(slot, L, ks[:, 0], vs[:, 0], start=n_match)
        else:
            bucket = max(64, 1 << (L - 1).bit_length())
            tokens = torch.tensor([req.prompt + [0] * (bucket - L)], device=self.device)
            logits_seq, ks, vs = self._prefill(self.params, tokens)
            logits = logits_seq[:, L - 1]
        self._finalize_admit(slot, req, logits, ks, vs, L, n_match)

    def _finalize_admit(self, slot, req, logits, ks, vs, L, n_match):
        """Write prefilled K/V into the slot (a prefix hit's are written
        already), sample + record the first token, and activate (or
        immediately retire) the slot."""
        if self.paged:
            if not n_match:
                self._admit_paged(slot, L, ks[:, 0], vs[:, 0])
            self._host_lens[slot] = L
        else:
            # in-place slice assignment of the whole bucket width: rows
            # beyond L are invisible (decode masks by lengths, flushes
            # overwrite them)
            S = self.state.k.shape[3]
            W = min(ks.shape[3], S)
            if self.quantized:  # per-token int8, in place
                for cache, scales, new in ((self.state.k, self.state.k_scale, ks),
                                           (self.state.v, self.state.v_scale, vs)):
                    cache[:, slot, :, :W], scales[:, slot, :, :W] = _quant_token(
                        new[:, 0, :, :W])
            else:
                self.state.k[:, slot, :, :W] = ks[:, 0, :, :W]
                self.state.v[:, slot, :, :W] = vs[:, 0, :, :W]
        self.state.lengths[slot] = L
        if self.prefix_cache:
            self._insert_prefix(req.prompt, slot)
        if self.spec_k:  # the drafting history: the prompt at positions [0, L)
            self._history[slot, :L] = torch.tensor(req.prompt, dtype=torch.int32)
        # sample the prefill token with the same settings as decode
        first = int(sample_tokens(logits, self._gen, self.temperature, self.top_k,
                                  self.top_p, self.min_p)[0])
        self.state.last_token[slot] = first
        req.out.append(first)
        if self.logprobs:
            req.logprobs.append(float(torch.log_softmax(logits[0].float(), dim=-1)[first]))
        # stop-sequence check FIRST so a final token that completes a stop
        # gets stripped consistently
        if (self._hit_stop(req)
                or (self.eos_id is not None and first == self.eos_id)
                or req.max_new_tokens <= 1):
            req.done = True
            self.slots[slot] = None
            self._retire_slot(slot)

    def step(self):
        """Admit pending requests, dispatch one decode CHUNK, and collect
        tokens from the oldest inflight chunk once the pipeline is full
        (or on drain)."""
        self._admit()
        live = {s: r for s, r in enumerate(self.slots)
                if r is not None and s not in self._admitting}
        dispatched = False
        if live:
            if self.paged:
                # pages for this chunk's flush, from the host lengths: no
                # device read
                for slot in live:
                    self._ensure_pages(slot, self._host_lens[slot] + self.chunk_size + PAGE_SLACK)
                self._flush_page_table()
            counts = lps = None
            if self.spec_k:
                toks, counts = self._chunk(self.params, self.state, self._history, self._gen)
            elif self.logprobs:
                toks, lps = self._chunk(self.params, self.state, self._gen)
            else:
                toks = self._chunk(self.params, self.state, self._gen)
            if self.paged:  # the chunk's own advance of the lengths
                self._host_lens = [n + self.chunk_size if n > 0 else 0 for n in self._host_lens]
            # snapshot slot->request at dispatch time: collection must not
            # attribute this chunk's tokens to a request admitted into a
            # recycled slot later
            self._inflight.append((toks, counts, live, lps))
            dispatched = True
        keep = self.pipeline_depth - 1 if dispatched else 0
        while len(self._inflight) > keep:
            self._collect(*self._inflight.pop(0))
        return dispatched or bool(self._inflight)

    @staticmethod
    def _trim_decode_state(req):
        """Drop cached decode state for tokens no longer in req.out."""
        while len(req._piece_lens) > len(req.out):
            del req._dec_bytes[len(req._dec_bytes) - req._piece_lens.pop():]

    def _hit_stop(self, req) -> bool:
        """True if req.out now ends with one of its stop sequences (token
        ids) or its decoded text contains one of its stop strings; the
        matched tokens/text are removed from the output.

        Stop strings are matched INCREMENTALLY on decoded bytes: only the
        newly-landed tokens are decoded, and only the tail a new match
        could occupy is searched."""
        for seq in req.stop:
            n = len(seq)
            if len(req.out) >= n and req.out[-n:] == seq:
                del req.out[-n:]
                del req.logprobs[len(req.out):]
                self._trim_decode_state(req)
                return True
        if req.stop_texts:
            decode_bytes = self.tokenizer.decode_bytes
            stop_bytes = [t.encode("utf-8") for t in req.stop_texts]
            max_stop = max(len(b) for b in stop_bytes)
            added = 0
            for tok in req.out[len(req._piece_lens):]:
                piece = decode_bytes([tok])
                req._dec_bytes.extend(piece)
                req._piece_lens.append(len(piece))
                added += len(piece)
            start = max(0, len(req._dec_bytes) - added - max_stop + 1)
            best = min((p for p in (req._dec_bytes.find(b, start) for b in stop_bytes)
                        if p >= 0), default=-1)
            if best >= 0:
                # strip tokens until the decoded bytes no longer reach the
                # match (a token spanning the boundary is removed whole)
                while req.out and len(req._dec_bytes) > best:
                    req.out.pop()
                    self._trim_decode_state(req)
                del req.logprobs[len(req.out):]
                return True
        return False

    def _collect(self, toks_dev, counts_dev, live, lps_dev=None):
        """Append a dispatched chunk's tokens (and logprobs) to its
        requests and retire the finished ones. A spec chunk's (steps, B, T)
        tokens come with counts (steps, B); the counters meter only what a
        request consumed: the tokens that survive in `out`, and the verify
        steps up to the one that finished it."""
        toks = toks_dev.cpu()  # waits for the chunk: (chunk, B) or (steps, B, T)
        counts = counts_dev.cpu().tolist() if counts_dev is not None else None
        lps = lps_dev.cpu().tolist() if lps_dev is not None else None
        toks = toks.tolist()
        for slot, req in live.items():
            if req.done:
                # finished in an earlier chunk while this one was already
                # in flight; its tokens for the slot are surplus
                continue
            if counts is None:
                slot_toks = [toks[t][slot] for t in range(len(toks))]
                slot_lps = [lps[t][slot] for t in range(len(toks))] if lps is not None else None
            else:
                # (token, verify step) pairs
                pairs = [(toks[t][slot][j], t) for t in range(len(toks))
                         for j in range(counts[t][slot])]
                slot_toks = [tok for tok, _ in pairs]
                slot_lps = None
            n_consumed = 0
            out_before = len(req.out)
            for tok in slot_toks:
                req.out.append(tok)
                if slot_lps is not None:
                    req.logprobs.append(slot_lps[n_consumed])
                n_consumed += 1
                full = len(req.prompt) + len(req.out) >= self.max_seq
                # stop check FIRST (unconditionally): a final allowed token
                # (or EOS) that also completes a stop sequence must still
                # be stripped from req.out
                stopped = self._hit_stop(req)
                if (stopped or len(req.out) >= req.max_new_tokens
                        or (self.eos_id is not None and tok == self.eos_id) or full):
                    # mid-chunk finish: the slot kept decoding to chunk end
                    # (bounded waste); surplus tokens are discarded
                    req.done = True
                    if self.slots[slot] is req:
                        self.slots[slot] = None
                    self._retire_slot(slot)
                    break
            if counts is not None:
                # the tokens that survive in req.out (a stop string may
                # have taken some back); the verify steps up to the one
                # that finished the request, else every step of the chunk
                self.spec_emitted += len(req.out) - out_before
                if req.done and n_consumed:
                    self.spec_verify_slots += pairs[n_consumed - 1][1] + 1
                else:
                    self.spec_verify_slots += len(toks)

    def run(self, max_steps: int = 10_000):
        steps = 0
        while ((self.queue or any(s is not None for s in self.slots)
                or self._inflight or self._admitting) and steps < max_steps):
            self.step()
            steps += 1
