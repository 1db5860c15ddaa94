"""Mistral decoder in plain float32 PyTorch (TF32 off).

The published equations (Mistral-7B-v0.1): RMS norm, rotary embedding in
the split-half convention with inv_freq = theta^(-2i/E), causal attention
with grouped KV heads where query p sees keys (p - window, p], a SwiGLU
MLP, a final norm and an untied head.

Departures, each a property of how the configuration is run, not of the
mathematics: stored weights are the bf16 tensors of `pbench/weights.py`,
used in f32; training rounds the parameters to bf16 after each AdamW
update, as they are stored.

`precision` selects what the products see: "f32" (the reference), or, as
the training cell's control that must fail the check, "fp8" (both
operands of every projection rounded to float8-e4m3 with a per-tensor
scale, the gradient passed straight through)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pbench import weights as W

ATTN_BLOCK = 512  # query rows per attention block
MLP_BLOCK = 4096  # rows per MLP block where no gradient is kept


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---- precision of the products --------------------------------------------


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    @staticmethod
    def backward(ctx, g):
        return g


def _operand(x, precision):
    return _RoundFp8.apply(x) if precision == "fp8" else x


def mm(x, w, precision="f32"):
    return _operand(x, precision) @ _operand(w, precision)


# ---- the layer's parts -----------------------------------------------------


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(L, E, theta, device, start=0):
    inv = theta ** (-torch.arange(0, E, 2, dtype=torch.float64) / E)
    ang = torch.arange(start, start + L, dtype=torch.float64)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float().to(device), ang.sin().float().to(device)


def rope(x, cos, sin):
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1, x2], -1) * cos + torch.cat([-x2, x1], -1) * sin


def _mask(s, e, k0, window, device):
    rows = torch.arange(s, e, device=device)[:, None]
    cols = torch.arange(k0, e, device=device)[None, :]
    m = cols <= rows
    if window is not None:
        m &= rows - cols < window
    return m


def _kv_range(s, window):
    return 0 if window is None else max(0, s - window + 1)


def attention_forward(q, k, v, window):
    """Causal GQA attention, blocks of query rows: q (B, H, L, E), k, v
    (B, KH, L, E) -> o (B, H, L, E), lse (B, H, L)."""
    B, H, L, E = q.shape
    rep = H // k.shape[1]
    scale = 1.0 / math.sqrt(E)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=q.dtype, device=q.device)
    for s in range(0, L, ATTN_BLOCK):
        e = min(L, s + ATTN_BLOCK)
        k0 = _kv_range(s, window)
        kk = k[:, :, k0:e].repeat_interleave(rep, dim=1)
        vv = v[:, :, k0:e].repeat_interleave(rep, dim=1)
        sc = (q[:, :, s:e] @ kk.transpose(-1, -2)) * scale
        sc = sc.masked_fill(~_mask(s, e, k0, window, q.device), -math.inf)
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        l = p.sum(-1, keepdim=True)
        o[:, :, s:e] = (p @ vv) / l
        lse[:, :, s:e] = (m + torch.log(l))[..., 0]
    return o, lse


class _Attention(torch.autograd.Function):
    """attention_forward with its gradient by the explicit formulas,
    recomputed block by block (nothing of size L x L is kept)."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        o, lse = attention_forward(q, k, v, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        window = ctx.window
        B, H, L, E = q.shape
        KH = k.shape[1]
        rep = H // KH
        scale = 1.0 / math.sqrt(E)
        delta = (do * o).sum(-1)
        dq = torch.zeros_like(q)
        dk = torch.zeros_like(k)
        dv = torch.zeros_like(v)
        for s in range(0, L, ATTN_BLOCK):
            e = min(L, s + ATTN_BLOCK)
            k0 = _kv_range(s, window)
            kk = k[:, :, k0:e].repeat_interleave(rep, dim=1)
            vv = v[:, :, k0:e].repeat_interleave(rep, dim=1)
            sc = (q[:, :, s:e] @ kk.transpose(-1, -2)) * scale
            mask = _mask(s, e, k0, window, q.device)
            p = torch.exp(sc - lse[:, :, s:e, None]).masked_fill(~mask, 0.0)
            dob = do[:, :, s:e]
            dvb = p.transpose(-1, -2) @ dob
            dp = dob @ vv.transpose(-1, -2)
            ds = p * (dp - delta[:, :, s:e, None])
            dq[:, :, s:e] = (ds @ kk) * scale
            dkb = (ds.transpose(-1, -2) @ q[:, :, s:e]) * scale
            n = e - k0
            dk[:, :, k0:e] += dkb.view(B, KH, rep, n, E).sum(2)
            dv[:, :, k0:e] += dvb.view(B, KH, rep, n, E).sum(2)
        return dq, dk, dv, None


def attention(q, k, v, window):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v, window)
    return attention_forward(q, k, v, window)[0]


def attention_block(x, lw, cfg, cos, sin, precision="f32"):
    """x (B, L, d) f32 -> x + attention(norm(x)); lw: the layer's f32 leaves."""
    B, L, d = x.shape
    H, KH, E = cfg["num_attention_heads"], cfg["num_key_value_heads"], W.head_dim(cfg)
    h = rms_norm(x, lw["attn_norm"], cfg["rms_norm_eps"])
    q = mm(h, lw["wq"], precision).view(B, L, H, E).transpose(1, 2)
    k = mm(h, lw["wk"], precision).view(B, L, KH, E).transpose(1, 2)
    v = mm(h, lw["wv"], precision).view(B, L, KH, E).transpose(1, 2)
    q, k = rope(q, cos, sin), rope(k, cos, sin)
    o = attention(q, k, v, cfg.get("sliding_window"))
    return x + mm(o.transpose(1, 2).reshape(B, L, H * E), lw["wo"], precision)


def _swiglu(h, wg, wu, wd, precision):
    return mm(F.silu(mm(h, wg, precision)) * mm(h, wu, precision), wd, precision)


def mlp_block(x, lw, cfg, precision="f32"):
    """x (B, L, d) -> x + mlp(norm(x)), in blocks of rows where no gradient
    is kept."""
    h = rms_norm(x, lw["mlp_norm"], cfg["rms_norm_eps"])
    if torch.is_grad_enabled():
        return x + _swiglu(h, lw["w_gate"], lw["w_up"], lw["w_down"], precision)
    out = torch.empty_like(x)
    for s in range(0, x.shape[1], MLP_BLOCK):
        out[:, s:s + MLP_BLOCK] = _swiglu(h[:, s:s + MLP_BLOCK], lw["w_gate"], lw["w_up"],
                                          lw["w_down"], precision)
    return x + out


def layer(x, lw, cfg, cos, sin, precision="f32"):
    return mlp_block(attention_block(x, lw, cfg, cos, sin, precision), lw, cfg, precision)


# ---- serving: the first token's logits -------------------------------------


@torch.no_grad()
def last_logits(cfg, seed, prompts, device, precision="f32"):
    """f32 logits (n, V) at the last position of each prompt, the weights
    made again from the seed one layer at a time; the prompts go through
    each layer together."""
    no_tf32()
    embed = W.make_embed(cfg, seed, device)
    xs = [embed[torch.as_tensor(p, device=device)].float()[None] for p in prompts]
    del embed
    E = W.head_dim(cfg)
    longest = max(len(p) for p in prompts)
    cos, sin = rope_tables(longest, E, cfg["rope_theta"], device)
    for i in range(cfg["num_hidden_layers"]):
        lw = {n: t.float() for n, t in W.make_layer(cfg, seed, i, device).items()}
        xs = [layer(x, lw, cfg, cos[:x.shape[1]], sin[:x.shape[1]], precision) for x in xs]
        del lw
    fn = W.make_final_norm(cfg, seed, device).float()
    head = W.make_head(cfg, seed, device).float()
    last = torch.cat([rms_norm(x[:, -1], fn, cfg["rms_norm_eps"]) for x in xs])
    return mm(last, head, precision)


# ---- training: the first steps ---------------------------------------------


def loss_fn(params, tokens, targets, cfg, precision="f32"):
    """Mean next-token cross-entropy over all positions. params: {name: f32
    leaf} (weights.flatten)."""
    B, L = tokens.shape
    x = params["embed"][tokens]
    cos, sin = rope_tables(L, W.head_dim(cfg), cfg["rope_theta"], tokens.device)
    for i in range(cfg["num_hidden_layers"]):
        lw = {k.split(".", 2)[2]: v for k, v in params.items() if k.startswith(f"layers.{i}.")}
        x = layer(x, lw, cfg, cos, sin, precision)
    x = rms_norm(x, params["final_norm"], cfg["rms_norm_eps"])
    logits = mm(x, params["lm_head"], precision)
    return F.cross_entropy(logits.view(B * L, -1), targets.reshape(B * L).long())


def train_steps(cfg, seed, batches, lr, device, precision="f32", b1=0.9, b2=0.999, eps=1e-8):
    """AdamW steps from the seed's bf16 weights over `batches` [(tokens,
    targets) int tensors (B, L)], parameters rounded to bf16 after each
    update. Returns (losses, {leaf: norm of step 1's gradient}, {leaf:
    norm of the parameters' change after the last step})."""
    no_tf32()
    params = {n: t.float().requires_grad_(True)
              for n, t in W.flatten(W.make_model(cfg, seed, device)).items()}
    names = list(params)
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, grad1 = [], {}
    for count, (tokens, targets) in enumerate(batches, 1):
        loss = loss_fn(params, tokens, targets, cfg, precision)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(loss.item())
        with torch.no_grad():
            b1c = 1.0 - b1 ** count
            b2c = 1.0 - b2 ** count
            for n, g in zip(names, grads):
                if count == 1:
                    grad1[n] = g.norm().item()
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                step = (mu[n] / b1c) / ((nu[n] / b2c).sqrt() + eps)
                params[n].copy_((params[n] - lr * step).to(torch.bfloat16).float())
        del grads, loss
    del mu, nu
    start = W.flatten(W.make_model(cfg, seed, device))
    change = {n: (params[n].detach() - start[n].float()).norm().item() for n in names}
    return losses, grad1, change
