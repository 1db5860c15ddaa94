"""Mistral and Mixtral decoders in plain float32 PyTorch (TF32 off).

The published equations (Mistral-7B-v0.1, Mixtral-8x7B-v0.1): RMS norm,
rotary embedding in the split-half convention with inv_freq =
theta^(-2i/E), causal attention with grouped KV heads where query p sees
keys (p - window, p], a SwiGLU MLP, a final norm and an untied head.
Mixtral's MLP routes each token: router logits r = h W_r, the top k of
them, weights the softmax over those k, and the output sum_j w_j
SwiGLU_{e_j}(h), computed one expert at a time over its own rows. The
training loss adds the program's aux term, the Switch load-balance loss
of each layer (E sum_e f_e p_e, f_e the share of the assignments to
expert e, p_e its mean router probability) times `router_aux_loss_coef`
over the number of layers.

Departures, each a property of how the configuration is run, not of the
mathematics: stored weights are the bf16 tensors of `pbench/weights.py`,
used in f32 (or, where the configuration states "weights": "int8", their
int8 form by the plain per-channel rule of `int8_weight`); training rounds
the parameters to bf16 after each AdamW update, as they are stored.

A routed layer may be given the experts to take (`route`): the program's
own choices, replayed, so that what follows is compared on the same
routing; the weights still come from the reference's own logits at
those experts. A `Routing` records how far each given choice lies from
the reference's own.

`precision` selects what the products see: "f32" (the reference), or, as
the training cell's control that must fail the check, "fp8" (both
operands of every projection and expert product rounded to float8-e4m3
with a per-tensor scale, the gradient passed straight through; the router
stays in f32, as the program computes it)."""

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


class Routing:
    """What a run's routed layers chose, against the reference's own
    router. Per routed layer call (`key`): the experts taken (`chosen`,
    uint8); and, where a taken expert is not among the reference's own
    top k, how far its reference logit lies below the reference's k-th
    (the widest such gap, `margin`, in f32 logit units) and how many
    assignments differ (`flips` of `assignments`)."""

    def __init__(self):
        self.chosen = {}
        self.assignments = 0
        self._flips = []
        self._widest = []

    @torch.no_grad()
    def note(self, key, logits, own, idx):
        self.chosen[key] = idx.to(torch.uint8)
        hit = (idx[:, :, None] == own.indices[:, None, :]).any(-1)
        gap = own.values[:, -1:] - logits.gather(1, idx)
        self._widest.append(torch.where(hit, -math.inf, gap).amax())
        self._flips.append((~hit).sum())
        self.assignments += idx.numel()

    @property
    def margin(self) -> float:
        return max([0.0] + [float(w) for w in self._widest])

    @property
    def flips(self) -> int:
        return int(sum(int(f) for f in self._flips))

    def passes(self, n_layers):
        """The chosen experts as [pass][layer] for keys (pass, layer)."""
        n = 1 + max(p for p, _ in self.chosen)
        return [[self.chosen[(p, i)] for i in range(n_layers)] for p in range(n)]


def load_balance(logits, idx, n_experts):
    """The Switch load-balance loss of one layer's routing."""
    k = idx.shape[1]
    f = (idx[..., None] == torch.arange(n_experts, device=idx.device)).float().sum(1).mean(0)
    return n_experts * ((f / k) * torch.softmax(logits, dim=-1).mean(0)).sum()


def moe_block(x, lw, cfg, precision="f32", route=None, routing=None, key=None):
    """x (B, L, d) -> (x + moe(norm(x)), the layer's load-balance loss).
    route: (B * L, k) experts to take in place of the reference's own top
    k; routing: a Routing that notes this call under `key`. Where no
    gradient is kept, each expert runs over its rows in blocks."""
    B, L, d = x.shape
    n_exp, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    h = rms_norm(x, lw["mlp_norm"], cfg["rms_norm_eps"]).reshape(B * L, d)
    logits = h @ lw["w_router"]
    own = logits.topk(k, dim=-1)
    idx = own.indices if route is None else route.to(h.device).long()
    w = torch.softmax(logits.gather(1, idx), dim=-1)
    if routing is not None:
        routing.note(key, logits, own, idx)
    grad = torch.is_grad_enabled()
    out = torch.zeros_like(h)
    for e in range(n_exp):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        step = max(1, tok.numel()) if grad else MLP_BLOCK
        for s in range(0, tok.numel(), step):
            t = tok[s:s + step]
            y = _swiglu(h[t], lw["w_gate"][e], lw["w_up"][e], lw["w_down"][e], precision)
            y = y * w[t, slot[s:s + step], None]
            out = out.index_add(0, t, y) if grad else out.index_add_(0, t, y)
    return x + out.view(B, L, d), load_balance(logits, idx, n_exp)


def layer(x, lw, cfg, cos, sin, precision="f32", route=None, routing=None, key=None):
    """One decoder layer: (x out, its load-balance loss, 0 when dense)."""
    x = attention_block(x, lw, cfg, cos, sin, precision)
    if "w_router" in lw:
        return moe_block(x, lw, cfg, precision, route, routing, key)
    return mlp_block(x, lw, cfg, precision), 0.0


PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


def int8_weight(w):
    """A weight (..., K, N) as stored in int8, in f32: for each output
    column (of each expert) the scale amax|w| / 127 over K, the value
    round(w / scale), half to even, within +-127, times the scale."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True).clamp(min=1e-8) / torch.tensor(
        127.0, device=wf.device)
    return (wf / scale).round().clamp(-127.0, 127.0) * scale


def stored(cfg, name, w):
    """A leaf in f32 as the configuration stores it: the projections and
    experts (and the head) through int8 where it states "weights": "int8";
    the embedding, the norms and the router as bf16."""
    if cfg.get("weights") == "int8" and name in PROJECTIONS:
        return int8_weight(w)
    return w.float()


# ---- serving: the first token's logits -------------------------------------


@torch.no_grad()
def last_logits(cfg, seed, prompts, device, precision="f32", routes=None, routing=None):
    """f32 logits (n, V) at the last position of each prompt, the weights
    made again from the seed one layer at a time; the prompts go through
    each layer together. routes: per prompt, its experts to take at each
    routed layer ((layers, L, k)); routing: a Routing that notes each
    (prompt, layer)."""
    no_tf32()
    embed = W.make_embed(cfg, seed, device)
    xs = [embed[torch.as_tensor(p, device=device)].float()[None] for p in prompts]
    del embed
    E = W.head_dim(cfg)
    longest = max(len(p) for p in prompts)
    cos, sin = rope_tables(longest, E, cfg["rope_theta"], device)
    for i in range(cfg["num_hidden_layers"]):
        lw = {n: stored(cfg, n, t) for n, t in W.layer_leaves(cfg, seed, i, device)}
        xs = [layer(x, lw, cfg, cos[:x.shape[1]], sin[:x.shape[1]], precision,
                    None if routes is None else routes[p][i], routing, (p, i))[0]
              for p, x in enumerate(xs)]
        del lw
    fn = W.make_final_norm(cfg, seed, device).float()
    head = stored(cfg, "lm_head", W.make_head(cfg, seed, device))
    last = torch.cat([rms_norm(x[:, -1], fn, cfg["rms_norm_eps"]) for x in xs])
    return mm(last, head, precision)


# ---- training: the first steps ---------------------------------------------


def loss_fn(params, tokens, targets, cfg, precision="f32", route=None, routing=None, step=0):
    """Mean next-token cross-entropy over all positions, and for routed
    layers the program's aux term. params: {name: f32 leaf}
    (weights.flatten); route: per layer, the experts to take ((B * L, k));
    routing: a Routing that notes each (step, layer)."""
    B, L = tokens.shape
    x = params["embed"][tokens]
    cos, sin = rope_tables(L, W.head_dim(cfg), cfg["rope_theta"], tokens.device)
    aux = 0.0
    for i in range(cfg["num_hidden_layers"]):
        lw = {k.split(".", 2)[2]: v for k, v in params.items() if k.startswith(f"layers.{i}.")}
        x, a = layer(x, lw, cfg, cos, sin, precision, None if route is None else route[i],
                     routing, (step, i))
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg["rms_norm_eps"])
    logits = mm(x, params["lm_head"], precision)
    loss = F.cross_entropy(logits.view(B * L, -1), targets.reshape(B * L).long())
    if W.n_experts(cfg):
        loss = loss + cfg["router_aux_loss_coef"] * aux / cfg["num_hidden_layers"]
    return loss


# f32 parameters, gradients and AdamW moments take 16 bytes a parameter; past
# this share of the card the moments live in host memory, leaf by leaf
MOMENTS_ON_CARD = 0.75


def _moments_home(params, device):
    if device.type != "cuda":
        return device
    n = sum(p.numel() for p in params.values())
    if 16 * n <= MOMENTS_ON_CARD * torch.cuda.get_device_properties(device).total_memory:
        return device
    return torch.device("cpu")


def train_steps(cfg, seed, batches, lr, device, precision="f32", routes=None, routing=None,
                b1=0.9, b2=0.999, eps=1e-8):
    """AdamW steps from the seed's bf16 weights over `batches` [(tokens,
    targets) int tensors (B, L)], parameters rounded to bf16 after each
    update. routes: per step, per layer, the experts to take; routing: a
    Routing that notes each (step, layer). Returns (losses, {leaf: norm of
    step 1's gradient}, {leaf: norm of the parameters' change after the
    last step})."""
    no_tf32()
    params = {n: t.float().requires_grad_(True) for n, t in W.leaves(cfg, seed, device)}
    names = list(params)
    home = _moments_home(params, device)
    mu, nu = {}, {}
    losses, grad1 = [], {}
    for count, (tokens, targets) in enumerate(batches, 1):
        loss = loss_fn(params, tokens, targets, cfg, precision,
                       None if routes is None else routes[count - 1], routing, count - 1)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(loss.item())
        with torch.no_grad():
            b1c = 1.0 - b1 ** count
            b2c = 1.0 - b2 ** count
            for n, g in zip(names, grads):
                if count == 1:
                    grad1[n] = g.norm().item()
                m = mu[n].to(device) if n in mu else torch.zeros_like(g)
                v = nu[n].to(device) if n in nu else torch.zeros_like(g)
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                step = (m / b1c) / ((v / b2c).sqrt() + eps)
                params[n].copy_((params[n] - lr * step).to(torch.bfloat16).float())
                if count < len(batches):
                    mu[n], nu[n] = m.to(home), v.to(home)
        del grads, loss
    del mu, nu
    change = {n: (params[n].detach() - t.float()).norm().item()
              for n, t in W.leaves(cfg, seed, device)}
    return losses, grad1, change
