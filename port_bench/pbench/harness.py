"""One run of a cell: the driver, the per-layer readers and the result
line's keys."""

from __future__ import annotations

import dataclasses
import math
import time

from pbench import device as card
from pbench import spec


@dataclasses.dataclass
class Job:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    plant: str = "none"
    t0: float = dataclasses.field(default_factory=time.perf_counter)


def _metrics(cell, out, trace):
    if not trace:
        return {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                for m in cell.end_to_end if m["name"] in out["e2e"]}
    ctx = dict(out.get("ctx", {}), config=cell.config, traffic=cell.traffic,
               workload=cell.workload)
    found = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            found[m["name"]] = {"value": value, "unit": m["unit"]}
    return found


def run_cell(cell, seed, seconds, trace, device, plant="none", t0=None):
    """One run of a cell: the driver's result plus the result line's keys."""
    import torch

    job = Job(cell, int(seed), float(seconds), bool(trace), torch.device(device), plant)
    if t0 is not None:
        job.t0 = t0
    if job.device.type == "cuda":
        torch.cuda.set_device(job.device)
        torch.cuda.reset_peak_memory_stats(job.device)
    drv = spec.driver(cell.workload["driver"])
    out = drv.run(job)
    found = out["checks"]
    result = {
        "correct": all(c.ok for c in found),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": _metrics(cell, out, trace),
        "device": card.describe(job.device, out["memory_peak_bytes"]),
    }
    if trace and "trace" in out:
        tr = out["trace"]
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = out.get("breakdown") or tr.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in found}
    return result, out


def emit(result, out=None, err=None) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, and the result as the last line of standard output."""
    import json
    import sys

    out, err = out or sys.stdout, err or sys.stderr
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=err, flush=True)
    print(json.dumps(jsonable(result)), file=out, flush=True)


def jsonable(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    return x
