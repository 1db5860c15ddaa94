"""roofline.attn_bwd.train: the attention backward's share of its bound.

Summed bound time over summed device time of the dQ and dK/dV kernels
(`csrc/flash_bwd.cuh`) in the traced window; each call's bound from the
cell's shapes (pbench/roofline.py:flash_bwd_dq, flash_bwd_dkv: three and
four products of 2E operations a visible pair, bf16)."""

from pbench import roofline
from pbench.weights import head_dim


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or "seq_len" not in ctx:
        return None
    cfg = ctx["config"]
    shape = (ctx["batch"], cfg["num_attention_heads"], cfg["num_key_value_heads"],
             head_dim(cfg), ctx["seq_len"], cfg.get("sliding_window"))
    t_dq, n_dq = trace.select(lambda n: "flash_bwd_dq_kernel" in n)
    t_kv, n_kv = trace.select(lambda n: "flash_bwd_dkv_kernel" in n)
    if not (n_dq and n_kv):
        return None
    bound = (n_dq * roofline.bound_s(*roofline.flash_bwd_dq(*shape), "bf16")
             + n_kv * roofline.bound_s(*roofline.flash_bwd_dkv(*shape), "bf16"))
    return 100.0 * bound / (t_dq + t_kv)
