"""idle_share.serve: the share of the traced stretch of the card alone
(no host ops recorded, so the profiler adds little to the host's work) in
which no device operation ran (the union of the kernels', copies' and
fills' intervals)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0:  # a stretch that traced nothing
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
