"""The AdamW update of one leaf, in place: a Triton kernel for Hopper.

It replaces the eager update of `parallel/tp_llama.py:AdamW` (the JAX
package's `AdamW.update`, nnop_tpu/parallel/tp_llama.py:264-286, which
XLA fuses into one pass a leaf; it has no Pallas kernel). One program
reads its block of p, g, mu and nu once, keeps every intermediate in f32
registers and writes mu, nu and p back:

    g    = g * scale in f32, rounded to g's dtype     (with a clip scale)
    mu   = b1 * mu + (1 - b1) * g
    nu   = b2 * nu + (1 - b2) * g * g
    step = (mu / b1c) / (sqrt(nu / b2c) + eps) + wd * p
    p    = p - lr * step, rounded to p's dtype once

with the plain version's f32 order (`naive_adamw_update_`, the CPU path
and the oracle the tests hold to the JAX update), its division and square
root rounded to nearest as on the CPU (Triton's `/` and `tl.sqrt` are
approximate). A PyTorch `add_(x, alpha=a)` is one fused multiply-add;
the kernel takes the same ones.

Bound on the H100: device-memory bandwidth. A bf16 leaf moves 22 bytes a
parameter (reads p, g: 2 + 2, mu, nu: 4 + 4; writes p, mu, nu: 2 + 4 + 4)
against ~20 flops. The eager update made about 13 passes over full-size
f32 temporaries and a launch each. lr, b1c and b2c are kernel arguments
(a new step count compiles nothing); the clip scale is a 0-d device
tensor read by pointer (no host sync). The loads are masked, and Triton's
own specialisation of the element count (a multiple of 16 or not) keeps
them vectorised: every leaf of the repo's configurations is a multiple of
16, so one compile per dtype and flag pair serves them all.

The launch runs inside a PyTorch op (`nnop::adamw_update`): the profiler
ties a kernel to the op that launched it, and a Triton launch made
outside any op to nothing, so a trace could not tell the update's device
time (`port_bench`'s `adamw_ms.train` reads it so).
"""

from __future__ import annotations

import functools

import torch

from nnop_tpu_torch.utils.platform import cdiv, check_cuda_operand

_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_BLOCK = 1024
_WARPS = 4


def clip_scaled(g, scale):
    """g times the global-norm clip scale (a 0-d f32 tensor), in f32 and
    rounded to g's dtype once, as the JAX clip promotes."""
    return (g.float() * scale).to(g.dtype)


def naive_adamw_update_(p, g, mu, nu, *, lr, b1, b2, b1c, b2c, eps, wd, scale=None):
    """The plain update of one leaf, in place, through eager f32 temporaries
    (at most two of the leaf's size at once)."""
    if scale is not None:
        g = clip_scaled(g, scale)
    g32 = g.float()
    mu.mul_(b1).add_(g32, alpha=1 - b1)
    nu.mul_(b2).addcmul_(g32, g32, value=1 - b2)
    del g32
    den = torch.div(nu, b2c).sqrt_().add_(eps)
    step = torch.div(mu, b1c).div_(den)
    del den
    p32 = p.float()  # p itself for an f32 leaf
    if wd:
        step.add_(p32, alpha=wd)
    p.copy_(p32.sub_(step.mul_(lr)))


def adamw_update_(p, g, mu, nu, *, lr, b1, b2, b1c, b2c, eps, wd, scale=None):
    """One AdamW step of the leaf p with gradient g and f32 moments mu, nu,
    all overwritten in place. lr, b1c, b2c: this step's rate and bias
    corrections (floats); scale: the global-norm clip scale, a 0-d f32
    tensor on p's device, or None. A CUDA leaf runs the kernel (one
    launch; bf16, f16 or f32, else it raises), a CPU leaf the plain
    version."""
    if p.device.type != "cuda":
        naive_adamw_update_(p, g, mu, nu, lr=lr, b1=b1, b2=b2, b1c=b1c, b2c=b2c, eps=eps,
                            wd=wd, scale=scale)
        return
    check_cuda_operand("p", p, _DTYPES)
    check_cuda_operand("g", g, (p.dtype,), device=p.device)
    for name, t in (("mu", mu), ("nu", nu)):
        check_cuda_operand(name, t, (torch.float32,), device=p.device)
    if not g.shape == mu.shape == nu.shape == p.shape:
        raise ValueError(f"shapes p {tuple(p.shape)}, g {tuple(g.shape)}, mu {tuple(mu.shape)}, "
                         f"nu {tuple(nu.shape)} differ")
    if scale is not None:
        check_cuda_operand("scale", scale, (torch.float32,), device=p.device)
        if scale.numel() != 1:
            raise ValueError(f"scale has {scale.numel()} elements, expected 1")
    if p.numel():
        _OP(p, g, mu, nu, scale, *map(float, (lr, b1, b2, b1c, b2c, eps, wd)))
        adamw_update_.launches += 1


adamw_update_.launches = 0


def _launch(p, g, mu, nu, scale, lr, b1, b2, b1c, b2c, eps, wd):
    """One launch of the kernel on checked operands (the CUDA kernel of the
    op nnop::adamw_update)."""
    _kernel()[(cdiv(p.numel(), _BLOCK),)](
        p, g, mu, nu, mu if scale is None else scale, p.numel(), lr, b1, 1 - b1, b2, 1 - b2,
        b1c, b2c, eps, wd, HAS_SCALE=scale is not None, HAS_WD=bool(wd), BLOCK=_BLOCK,
        num_warps=_WARPS)


# A plain Library op, not torch.library.custom_op: the latter's first call
# imports torch._dynamo (~10 s of the training cell's set-up on an H100's host).
_LIB = torch.library.Library("nnop", "DEF")
_LIB.define("adamw_update(Tensor(a!) p, Tensor g, Tensor(b!) mu, Tensor(c!) nu, Tensor? scale, "
            "float lr, float b1, float b2, float b1c, float b2c, float eps, float wd) -> ()")
_LIB.impl("adamw_update", _launch, "CUDA")
_OP = torch.ops.nnop.adamw_update.default


@functools.cache
def _kernel():
    """Define the Triton kernel (imported here, at first launch; the names
    are module globals because Triton resolves them there)."""
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def adamw_kernel(p_ptr, g_ptr, mu_ptr, nu_ptr, scale_ptr, n, lr, b1, c1, b2, c2, b1c, b2c,
                     eps, wd, HAS_SCALE: tl.constexpr, HAS_WD: tl.constexpr,
                     BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        live = offs < n
        p = tl.load(p_ptr + offs, mask=live, other=0.0).to(tl.float32)
        g = tl.load(g_ptr + offs, mask=live, other=0.0)
        mu = tl.load(mu_ptr + offs, mask=live, other=0.0)
        nu = tl.load(nu_ptr + offs, mask=live, other=0.0)
        if HAS_SCALE:
            g = (g.to(tl.float32) * tl.load(scale_ptr)).to(g_ptr.dtype.element_ty)
        g = g.to(tl.float32)
        mu = tl.fma(g, c1, mu * b1)
        nu = tl.fma(g * c2, g, nu * b2)
        den = tl.sqrt_rn(tl.div_rn(nu, b2c)) + eps
        step = tl.div_rn(tl.div_rn(mu, b1c), den)
        if HAS_WD:
            step = tl.fma(p, wd, step)
        p = (p - step * lr).to(p_ptr.dtype.element_ty)
        tl.store(mu_ptr + offs, mu, mask=live)
        tl.store(nu_ptr + offs, nu, mask=live)
        tl.store(p_ptr + offs, p, mask=live)

    return adamw_kernel
