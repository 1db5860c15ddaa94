"""The benchmark of nnop_tpu_torch on one NVIDIA H100.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json: it loads, makes the weights on the card
from the seed, warms up the cell's own shapes, measures for `--seconds`,
checks what the timed path produced against the plain reference, and
prints one JSON line last on standard output (with `--trace 0` the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics, the
device's busy time and a breakdown), and each compared number beside its
limit as the last lines on standard error. It exits with 2, printing no
result, without a CUDA card, and with 3 if JAX or the JAX package was
loaded.

`--readings N` runs N seeds from `--seed` on, each with a window of
`--seconds`, and prints each seed's compared numbers: the readings a
limit is set from. `--plant control` puts the precision below the
configuration's in the program's place (the control, which must fail);
`--plant state|half|token` plants a fault in the timed path, and
`--plant route` (configurations with routed experts) makes the program
take its lowest-logit expert in place of its second choice for every
fourth token.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python can take it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(BENCH_DIR, ".cache")


def _environment():
    """Fixed caches inside the checkout, set before anything imports
    Triton or CUDA; the checkout's root on the path (the program) and
    port_bench (the harness)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT, BENCH_DIR):
        if p not in sys.path:
            sys.path.insert(0, p)


_environment()

from pbench import guard  # noqa: E402

guard.install()

from pbench import device as card  # noqa: E402
from pbench import spec  # noqa: E402
from pbench.harness import emit, jsonable, run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings", type=int, default=0)
    ap.add_argument("--plant", default="none", choices=("none", "control", "state", "half",
                                                        "token", "route"))
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if args.plant == "route" and not cell.config.get("num_local_experts"):
        ap.error("--plant route needs a configuration with routed experts")
    try:
        card.require_cuda(cell.chips)
    except card.NoCard as e:
        print(f"port_bench: {e}; no result", file=sys.stderr)
        return 2
    if args.readings:
        for k in range(args.readings):
            seed = args.seed + k
            result, out = run_cell(cell, seed, args.seconds, False, "cuda:0", args.plant)
            print(json.dumps(jsonable({"seed": seed, "plant": args.plant,
                                        "checks": result["checks"],
                                        "readings": out.get("readings", {}),
                                        "metrics": result["metrics"]})), flush=True)
        return _guard_exit()
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", args.plant,
                         t0=T0)
    code = _guard_exit()
    if code:
        return code
    emit(result)
    return 0


def _guard_exit() -> int:
    leaked = guard.banned_loaded()
    if leaked:
        print(f"port_bench: modules loaded that the benchmark refuses: {leaked}; no result",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
