"""mfu.train: the training steps' share of the card's bf16 peak.

The least time the operations of the steps completed in the traced
window need at 989 TFLOP/s (pbench/roofline.py:train_step_ops: the
products forward and backward, 6 per parameter and token, and the
visible attention pairs), over the traced window."""

from pbench import roofline


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("steps"):
        return None
    ops = roofline.train_step_ops(ctx["config"], ctx["batch"], ctx["seq_len"]) * ctx["steps"]
    return 100.0 * roofline.ops_s(ops, "bf16") / trace.window_s
