"""idle_share.train: the share of the traced window in which no device
operation ran (the union of the kernels', copies' and fills' intervals)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
