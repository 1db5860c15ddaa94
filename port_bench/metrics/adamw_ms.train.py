"""adamw_ms.train: device time of the kernels launched inside the
harness's range around `parallel/tp_llama.py:AdamW.update`, per step."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("steps"):
        return None
    ops = trace.in_range("bench.adamw")
    if not ops:
        return None
    return 1e3 * sum(e - s for s, e, _ in ops) / ctx["steps"]
