"""roofline.flash_fwd.serve: kernel C's share of its bound in the prefill.

Summed bound over summed device time of the flash_fwd_kernel launches
(`csrc/flash_fwd.cuh`) in the trace of the card alone. Each prefill call
runs C once a layer, over its prompt rows at its offset; a call's bound
(pbench/roofline.py:flash_fwd, bf16) counts those rows' visible pairs and
visible K/V rows once. Padding rows, which the last chunk of a prompt and
a short prompt's bucket carry, are work no request needs and are not
counted."""

from pbench import roofline
from pbench.weights import head_dim


def read(ctx):
    trace = ctx.get("trace")
    chunks = ctx.get("traced_chunks")
    if trace is None or not chunks:
        return None
    cfg = ctx["config"]
    H, KH, E = cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg)
    w = cfg.get("sliding_window")
    bound = cfg["num_hidden_layers"] * sum(
        roofline.bound_s(*roofline.flash_fwd(1, H, KH, E, off, rows, w), "bf16")
        for _, _, off, _, rows, _ in chunks if rows > 0)
    t, count = trace.select(lambda n: "flash_fwd_kernel" in n)
    if not count:
        return None
    return 100.0 * bound / t
