"""Llama-family decoder on the ported kernels.

Counterpart of nnop_tpu/models/llama.py. Parameters are the JAX
package's tree — a dict of tensors with a list of per-layer dicts,
weights stored (in, out) and applied as `x @ w` — so trees convert
between the packages (models/weights.py:params_from_numpy). `Llama` wraps
a tree as a frozen `nn.Module` in eval mode.

Uses rms_norm (Triton), llama_rope (Triton) and flash_attention (CUDA);
the projections and the MLP are plain `torch.matmul` products, as the JAX
package leaves them to XLA, unless the `matmul=` hook routes them (the
quantized products: models/quantized.py:qmatmul). A Mixtral layer's MLP
is the routed mixture of experts of models/moe.py (its grouped path runs
kernel I, and in the backward kernel I and the dw kernel); `loss_fn`
adds its router's aux term. `forward(..., plain=True)`
runs the plain versions of the ops instead, the reference the kernels are
held to on the card. `init_quantized_params` builds random int8 or int4
weights directly, without a floating-point copy.

`forward` and `loss_fn` are differentiable: training is functional, as in
the JAX package, on a params tree whose leaves have `requires_grad_(True)`
(cli.py:train_loop); the ops' autograd Functions run the backward kernels.
Without a leaf that requires grad (the frozen `Llama`, the engine under
its own `no_grad`) no graph is recorded.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from nnop_tpu_torch.models.moe import init_moe_layer, moe_mlp
from nnop_tpu_torch.ops.flash_attention import flash_attention
from nnop_tpu_torch.ops.naive import naive_attention, naive_rms_norm, naive_rope
from nnop_tpu_torch.ops.quantization import QTensor, QTensor4, _pick_pack_block
from nnop_tpu_torch.ops.rms_norm import rms_norm
from nnop_tpu_torch.ops.rope import RotaryEmbedding, llama_rope


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Decoder-transformer config covering the Llama lineage of families.

    Family knobs (all default to Llama-3 semantics):
      sliding_window: Mistral — causal attention over the last
        `sliding_window` keys.
      rms_offset: Gemma — rms_norm computes (offset + w) * x_hat.
      act: "silu" (SwiGLU) or "gelu" (Gemma GeGLU, tanh approximation).
      qkv_bias: Qwen2 — additive bias on the q/k/v projections.
      tie_embeddings: lm_head = embed^T (Gemma, Qwen2-small).
      embed_scale: multiply embeddings by this after lookup (Gemma).
      attn_softcap / final_softcap: Gemma-2 logit softcapping.
      attn_scale: override the attention score scale (default
        1/sqrt(head_dim)).
      post_norms: Gemma-2 — rms_norm on each sublayer output.
      window_pattern: Gemma-2 — the window applies only on layers where
        layer_idx % window_pattern == 0.
      rope_scaling: Llama-3.1 NTK-by-parts scaling (factor,
        low_freq_factor, high_freq_factor, original_max_len).
      n_experts / n_experts_per_token / capacity_factor /
        router_aux_coef / moe_impl: Mixtral — the MLP becomes a top-k
        routed mixture of experts (models/moe.py); hidden_dim is the
        per-expert hidden size. moe_impl "einsum" (capacity dispatch) or
        "grouped" (expert-sorted grouped products).
    """

    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    hidden_dim: int = 14336
    rope_base: float = 500000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: Any = torch.bfloat16
    sliding_window: int | None = None
    rms_offset: float = 0.0
    act: str = "silu"
    qkv_bias: bool = False
    tie_embeddings: bool = False
    embed_scale: float | None = None
    attn_softcap: float | None = None
    final_softcap: float | None = None
    attn_scale: float | None = None
    post_norms: bool = False
    window_pattern: int | None = None
    rope_scaling: tuple[float, float, float, int] | None = None
    n_experts: int | None = None
    n_experts_per_token: int = 2
    capacity_factor: float | None = None
    router_aux_coef: float = 0.01
    moe_impl: str = "einsum"

    def layer_window(self, li: int) -> int | None:
        """Effective sliding window for layer `li` (Gemma-2 alternates)."""
        if self.sliding_window is None:
            return None
        if self.window_pattern is not None and li % self.window_pattern != 0:
            return None
        return self.sliding_window

    @staticmethod
    def llama3_8b(**kw):
        return LlamaConfig(**kw)

    @staticmethod
    def mistral_7b(**kw):
        defaults = dict(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                        n_kv_heads=8, head_dim=128, hidden_dim=14336,
                        rope_base=10000.0, rms_eps=1e-5, sliding_window=4096)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def gemma_2b(**kw):
        defaults = dict(vocab_size=256000, dim=2048, n_layers=18, n_heads=8,
                        n_kv_heads=1, head_dim=256, hidden_dim=16384,
                        rope_base=10000.0, rms_eps=1e-6, rms_offset=1.0,
                        act="gelu", tie_embeddings=True, embed_scale=2048.0**0.5)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def llama31_8b(**kw):
        defaults = dict(max_seq_len=131072, rope_scaling=(8.0, 1.0, 4.0, 8192))
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def gemma2_2b(**kw):
        defaults = dict(vocab_size=256000, dim=2304, n_layers=26, n_heads=8,
                        n_kv_heads=4, head_dim=256, hidden_dim=9216,
                        rope_base=10000.0, rms_eps=1e-6, rms_offset=1.0,
                        act="gelu", tie_embeddings=True, embed_scale=2304.0**0.5,
                        attn_softcap=50.0, final_softcap=30.0, post_norms=True,
                        sliding_window=4096, window_pattern=2)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def qwen2_7b(**kw):
        defaults = dict(vocab_size=152064, dim=3584, n_layers=28, n_heads=28,
                        n_kv_heads=4, head_dim=128, hidden_dim=18944,
                        rope_base=1000000.0, rms_eps=1e-6, qkv_bias=True)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def mixtral_8x7b(**kw):
        defaults = dict(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                        n_kv_heads=8, head_dim=128, hidden_dim=14336,
                        rope_base=1000000.0, rms_eps=1e-5, n_experts=8,
                        n_experts_per_token=2)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def tiny_moe(**kw):
        defaults = dict(n_experts=4, n_experts_per_token=2)
        defaults.update(kw)
        return LlamaConfig.tiny(**defaults)

    @staticmethod
    def tiny(**kw):
        defaults = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, head_dim=32, hidden_dim=256,
                        rope_base=10000.0, max_seq_len=256)
        defaults.update(kw)
        return LlamaConfig(**defaults)


def init_params(generator: torch.Generator, cfg: LlamaConfig):
    """Random-init params tree on the generator's device (the JAX
    package's init: N(0, 1/fan_in) projections, N(0, 0.02^2) embeddings,
    identity norms; a MoE layer's router and stacked experts as
    models/moe.py:init_moe_layer). Same seed, different numbers than
    jax.random."""
    d, hd = cfg.dim, cfg.head_dim
    dev = generator.device

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return x.mul_(std).to(cfg.dtype)

    def dense(shape):
        return normal(shape, shape[0] ** -0.5)

    def full(n):
        # Gemma-style zero-centered norm weights: identity is 1 - offset
        return torch.full((n,), 1.0 - cfg.rms_offset, dtype=cfg.dtype, device=dev)

    def zeros(n):
        return torch.zeros((n,), dtype=cfg.dtype, device=dev)

    def layer():
        out = {
            "attn_norm": full(d),
            "wq": dense((d, cfg.n_heads * hd)),
            "wk": dense((d, cfg.n_kv_heads * hd)),
            "wv": dense((d, cfg.n_kv_heads * hd)),
            "wo": dense((cfg.n_heads * hd, d)),
            "mlp_norm": full(d),
        }
        if cfg.n_experts is not None:
            out.update(init_moe_layer(cfg, dense))
        else:
            out.update({
                "w_gate": dense((d, cfg.hidden_dim)),
                "w_up": dense((d, cfg.hidden_dim)),
                "w_down": dense((cfg.hidden_dim, d)),
            })
        if cfg.qkv_bias:
            out["bq"] = zeros(cfg.n_heads * hd)
            out["bk"] = zeros(cfg.n_kv_heads * hd)
            out["bv"] = zeros(cfg.n_kv_heads * hd)
        if cfg.post_norms:
            out["attn_post_norm"] = full(d)
            out["mlp_post_norm"] = full(d)
        return out

    params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "layers": [layer() for _ in range(cfg.n_layers)],
        "final_norm": full(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size))
    return params


def init_quantized_params(generator: torch.Generator, cfg: LlamaConfig, *, wbits: int = 8):
    """Random weight-only int8 (wbits=8) or packed int4 (wbits=4) params,
    built directly as QTensor / QTensor4 on the generator's device: an 8B
    model never exists in floating point. Scales give the dequantized
    weights ~1/fan_in variance (the JAX package's init_quantized_params);
    norms and the embedding table stay floating point.

    Unlike the JAX package, which draws whole int4 bytes (so every nibble
    has mean -0.5 and the random model's logits collapse onto one
    direction), each nibble is drawn from [-7, 7].

    A MoE layer's stacked experts are int8 with (E, N) scales (axis 1)
    whatever wbits is, as in the JAX package; its router stays floating
    point, N(0, 0.02^2)."""
    d, hd = cfg.dim, cfg.head_dim
    dev = generator.device

    def qdense(shape):
        fan_in, n = shape
        if wbits == 4:
            p = _pick_pack_block(fan_in, 1024)
            kp = fan_in + (-fan_in % p)
            lo, hi = (torch.randint(-7, 8, (kp // 2, n), generator=generator, device=dev,
                                    dtype=torch.int32) for _ in range(2))
            byte = (lo & 0xF) | ((hi & 0xF) << 4)
            packed = torch.where(byte >= 128, byte - 256, byte).to(torch.int8)
            scale = torch.full((kp // 128, n), fan_in**-0.5 / 4.1, device=dev)
            return QTensor4(packed, scale, 128, p)
        vals = torch.randint(-127, 128, shape, generator=generator, device=dev,
                             dtype=torch.int8)
        return QTensor(vals, torch.full((n,), fan_in**-0.5 / 74.0, device=dev), 0)

    def qexperts(shape):
        E, fan_in, n = shape
        vals = torch.randint(-127, 128, shape, generator=generator, device=dev,
                             dtype=torch.int8)
        return QTensor(vals, torch.full((E, n), fan_in**-0.5 / 74.0, device=dev), 1)

    def ones():
        return torch.ones((d,), dtype=cfg.dtype, device=dev)

    def layer():
        out = {
            "attn_norm": ones(),
            "wq": qdense((d, cfg.n_heads * hd)),
            "wk": qdense((d, cfg.n_kv_heads * hd)),
            "wv": qdense((d, cfg.n_kv_heads * hd)),
            "wo": qdense((cfg.n_heads * hd, d)),
            "mlp_norm": ones(),
        }
        if cfg.n_experts is None:
            out.update(w_gate=qdense((d, cfg.hidden_dim)), w_up=qdense((d, cfg.hidden_dim)),
                       w_down=qdense((cfg.hidden_dim, d)))
            return out
        E = cfg.n_experts
        router = torch.randn((d, E), generator=generator, device=dev)
        out.update(w_router=router.mul_(0.02).to(cfg.dtype),
                   w_gate=qexperts((E, d, cfg.hidden_dim)), w_up=qexperts((E, d, cfg.hidden_dim)),
                   w_down=qexperts((E, cfg.hidden_dim, d)))
        return out

    embed = torch.randn((cfg.vocab_size, d), generator=generator, device=dev)
    return {
        "embed": embed.mul_(0.02).to(cfg.dtype),
        "layers": [layer() for _ in range(cfg.n_layers)],
        "final_norm": ones(),
        "lm_head": qdense((d, cfg.vocab_size)),
    }


def _matmul(x, w):
    return x @ w


def _split_heads(x, n_heads, head_dim):
    # (B, L, H*E) -> (B, H, L, E), contiguous (the kernels take dense rows)
    B, L, _ = x.shape
    return x.reshape(B, L, n_heads, head_dim).transpose(1, 2).contiguous()


def _merge_heads(x):
    # (B, H, L, E) -> (B, L, H*E)
    B, H, L, E = x.shape
    return x.transpose(1, 2).reshape(B, L, H * E)


def act_fn(cfg: LlamaConfig, g):
    if cfg.act == "silu":
        return F.silu(g)
    return F.gelu(g, approximate="tanh")


def _plain_rms_norm(x, w, eps, offset=0.0):
    return naive_rms_norm(x, w, eps=eps, offset=offset)


# (rms_norm, rope, attention): the kernels, or their plain versions
_KERNEL_OPS = (rms_norm, llama_rope, flash_attention)
_PLAIN_OPS = (_plain_rms_norm, naive_rope, naive_attention)


def _post(norm, layer, out, cfg: LlamaConfig, key: str):
    """Gemma-2 post-norm: normalize the sublayer OUTPUT pre-residual."""
    if cfg.post_norms:
        return norm(out, layer[key], cfg.rms_eps, offset=cfg.rms_offset)
    return out


def attention_block(layer, x, cos, sin, cfg: LlamaConfig, *, kpad_mask=None,
                    causal=True, layer_idx: int = 0, segment_ids=None, plain=False,
                    matmul=_matmul):
    """rms_norm -> qkv proj -> rope -> flash attention -> out proj (+ x)."""
    norm, rope, attention = _PLAIN_OPS if plain else _KERNEL_OPS
    h = norm(x, layer["attn_norm"], cfg.rms_eps, offset=cfg.rms_offset)
    if "wqkv" in layer:  # the engine's fused weights (runtime/engine.py:fuse_decode_weights)
        qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        qkv = matmul(h, layer["wqkv"])
        if cfg.qkv_bias:
            qkv = qkv + layer["bqkv"]
        xq, xk, xv = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
    else:
        xq, xk, xv = matmul(h, layer["wq"]), matmul(h, layer["wk"]), matmul(h, layer["wv"])
        if cfg.qkv_bias:
            xq, xk, xv = xq + layer["bq"], xk + layer["bk"], xv + layer["bv"]
    q = _split_heads(xq, cfg.n_heads, cfg.head_dim)
    k = _split_heads(xk, cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(xv, cfg.n_kv_heads, cfg.head_dim)
    q, k = rope(q, k, cos, sin)
    o = attention(
        q, k, v, causal=causal, kpad_mask=kpad_mask,
        segment_ids=(segment_ids, segment_ids) if segment_ids is not None else None,
        window=cfg.layer_window(layer_idx) if causal else None,
        softcap=cfg.attn_softcap, scale=cfg.attn_scale,
    )
    out = matmul(_merge_heads(o.to(x.dtype)), layer["wo"])
    return x + _post(norm, layer, out, cfg, "attn_post_norm")


def mlp_block(layer, x, cfg: LlamaConfig, *, plain=False, matmul=_matmul, w8a8: bool = False):
    """Gated MLP (SwiGLU / GeGLU), or the routed mixture of experts when
    cfg.n_experts is set, with residual. Returns (x + out, aux), aux the
    router's load-balancing loss (0 for a dense MLP). w8a8: the experts'
    W8A8 routing (models/moe.py:moe_mlp_grouped)."""
    norm = _PLAIN_OPS[0] if plain else _KERNEL_OPS[0]
    h = norm(x, layer["mlp_norm"], cfg.rms_eps, offset=cfg.rms_offset)
    if cfg.n_experts is not None:
        B, L, d = h.shape
        out, aux = moe_mlp(layer, h.reshape(B * L, d), cfg, act=lambda g: act_fn(cfg, g),
                           w8a8=w8a8, plain=plain)
        return x + _post(norm, layer, out.reshape(B, L, d), cfg, "mlp_post_norm"), aux
    if "w_gateup" in layer:  # the engine's fused weights
        gu = matmul(h, layer["w_gateup"]).float()
        gate, up = act_fn(cfg, gu[..., :cfg.hidden_dim]), gu[..., cfg.hidden_dim:]
    else:
        gate = act_fn(cfg, matmul(h, layer["w_gate"]).float())
        up = matmul(h, layer["w_up"]).float()
    out = matmul((gate * up).to(x.dtype), layer["w_down"])
    return x + _post(norm, layer, out, cfg, "mlp_post_norm"), 0.0


def forward(params, tokens, cfg: LlamaConfig, *, positions=None, kpad_mask=None,
            segment_ids=None, plain: bool = False, matmul=None, return_aux: bool = False,
            w8a8: bool = False):
    """Full forward pass: tokens (B, L) int -> logits (B, L, vocab) f32.
    params: the tree, or the engine's fused one (fuse_decode_weights).

    positions: (B, L) absolute positions (default arange). plain: run the
    plain versions of rms_norm, rope, attention and the grouped expert
    products (the kernels' oracle) instead of the kernels. matmul(x, w):
    the projection and lm_head product (default x @ w;
    models.quantized.qmatmul for quantized params). return_aux: also
    return the router load-balancing loss summed over the layers (0 for a
    dense model). w8a8: int8 experts run W8A8 where the engine's prefill
    runs it (models/moe.py)."""
    mm = matmul or _matmul
    B, L = tokens.shape
    if positions is None:
        positions = torch.arange(L, device=tokens.device).expand(B, L)
    x = params["embed"][tokens]
    if cfg.embed_scale is not None:
        x = (x.float() * cfg.embed_scale).to(x.dtype)
    cos, sin = RotaryEmbedding(cfg.head_dim, cfg.rope_base, scaling=cfg.rope_scaling)(positions)
    aux_total = 0.0
    for i, layer in enumerate(params["layers"]):
        x = attention_block(layer, x, cos, sin, cfg, kpad_mask=kpad_mask, layer_idx=i,
                            segment_ids=segment_ids, plain=plain, matmul=mm)
        x, aux = mlp_block(layer, x, cfg, plain=plain, matmul=mm, w8a8=w8a8)
        aux_total = aux_total + aux
    norm = _PLAIN_OPS[0] if plain else _KERNEL_OPS[0]
    x = norm(x, params["final_norm"], cfg.rms_eps, offset=cfg.rms_offset)
    if cfg.tie_embeddings:
        logits = (x @ params["embed"].T).float()
    else:
        logits = mm(x, params["lm_head"]).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if return_aux:
        return logits, torch.as_tensor(aux_total, dtype=torch.float32, device=logits.device)
    return logits


def loss_fn(params, tokens, targets, cfg: LlamaConfig, *, plain: bool = False):
    """Next-token cross-entropy, the mean over all positions, plus the
    router load-balancing aux for MoE configs, router_aux_coef * aux /
    n_layers (nnop_tpu/models/llama.py:loss_fn): tokens, targets (B, L)
    int -> scalar f32. plain as in forward."""
    logits, aux = forward(params, tokens, cfg, plain=plain, return_aux=True)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    loss = -ll.mean()
    if cfg.n_experts is not None:
        loss = loss + cfg.router_aux_coef * aux / cfg.n_layers
    return loss


class Llama(nn.Module):
    """A Llama-family decoder as a frozen `nn.Module` in eval mode. Its
    parameters are the JAX package's tree; `params` returns that tree
    (sharing storage), which the serving engine takes."""

    def __init__(self, cfg: LlamaConfig, params):
        super().__init__()
        self.cfg = cfg

        def frozen(tree):
            return nn.ParameterDict(
                {k: nn.Parameter(v, requires_grad=False) for k, v in tree.items()})

        self.top = frozen({k: v for k, v in params.items() if k != "layers"})
        self.layers = nn.ModuleList(frozen(layer) for layer in params["layers"])
        self.eval()

    @property
    def params(self):
        tree = {k: p.data for k, p in self.top.items()}
        tree["layers"] = [{k: p.data for k, p in layer.items()} for layer in self.layers]
        return tree

    def forward(self, tokens, *, plain: bool = False):
        return forward(self.params, tokens, self.cfg, plain=plain)
