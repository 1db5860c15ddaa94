"""Time the port's featureless flash-attention kernels (C, dQ, dK/dV) in
two or more checkouts on one card, in turns, so that two versions are
compared inside one call.

    python scripts/torch_flash_ab.py ROOT_A ROOT_B [ROOT_B ROOT_A ...]

Each ROOT is a checkout holding `nnop_tpu_torch/`. Every ROOT runs in a
process of its own (it builds and imports its own kernels), at the shapes
of `chip_smoke.py` phase 3's main cases: C at q (1, 32, 512, 128) over kv
(1, 8, 1536, 128) from row offset 1024 (a prefill chunk), C causal at the
8B training geometry q (2, 32, 4096, 128), kv (2, 8, 4096, 128), and dQ
and dK/dV there; then the same three kernels there with a pair bias
(2, 32, 4096, 4096) bf16 and with segment ids (four documents of 1024),
where the ROOT's kernels take them (null where they raise). One JSON
line per ROOT: median ms over 5 repetitions of back-to-back calls (CUDA
events), with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_CHILD = r"""
import json, statistics, subprocess, sys, torch
from nnop_tpu_torch.ops.flash_attention import flash_fwd
from nnop_tpu_torch.ops.flash_attention_bwd import flash_bwd_dkv, flash_bwd_dq

def ms(fn, n, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / n)
    return statistics.median(out)

g = torch.Generator(device="cuda")
g.manual_seed(0)
def randn(*s):
    return torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)

res = {}
q, k, v = randn(1, 32, 512, 128), randn(1, 8, 1536, 128), randn(1, 8, 1536, 128)
kw = dict(causal=True, scale=128 ** -0.5, causal_offset=1024)
res["flash_fwd_chunk_ms"] = ms(lambda: flash_fwd(q, k, v, **kw), 20)
q, k, v, do = (randn(2, h, 4096, 128) for h in (32, 8, 8, 32))
kw = dict(causal=True, scale=128 ** -0.5)
o, lse = flash_fwd(q, k, v, **kw)
_, delta = flash_bwd_dq(q, k, v, o, lse, do, **kw)
res["flash_fwd_train_ms"] = ms(lambda: flash_fwd(q, k, v, **kw), 5)
res["flash_bwd_dq_ms"] = ms(lambda: flash_bwd_dq(q, k, v, o, lse, do, **kw), 5)
res["flash_bwd_dkv_ms"] = ms(lambda: flash_bwd_dkv(q, k, v, lse, delta, do, **kw), 5)
seg = torch.arange(4, device="cuda", dtype=torch.int32).repeat_interleave(1024).expand(2, 4096)
for name, extra in (("pair", dict(pair=randn(2, 32, 4096, 4096))),
                    ("segments", dict(segment_ids=(seg, seg)))):
    try:
        o, lse = flash_fwd(q, k, v, **kw, **extra)
    except NotImplementedError:
        res.update({f"{k_}_{name}_ms": None for k_ in ("flash_fwd", "flash_bwd_dq",
                                                         "flash_bwd_dkv")})
        continue
    delta = flash_bwd_dq(q, k, v, o, lse, do, **kw, **extra)[1]
    res[f"flash_fwd_{name}_ms"] = ms(lambda: flash_fwd(q, k, v, **kw, **extra), 5)
    res[f"flash_bwd_dq_{name}_ms"] = ms(lambda: flash_bwd_dq(q, k, v, o, lse, do, **kw, **extra), 5)
    res[f"flash_bwd_dkv_{name}_ms"] = ms(
        lambda: flash_bwd_dkv(q, k, v, lse, delta, do, **kw, **extra), 5)
res["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()[0]
print(json.dumps(res))
"""


def main():
    roots = sys.argv[1:]
    if len(roots) < 2:
        sys.exit(__doc__)
    for root in roots:
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, "-c", _CHILD], cwd=root, capture_output=True,
                             text=True, env=dict(os.environ, PYTHONPATH=root))
        if out.returncode:
            sys.exit(f"{root}: exit {out.returncode}\n{out.stderr[-4000:]}")
        print(json.dumps(dict(root=root, **json.loads(out.stdout.strip().splitlines()[-1]))))


if __name__ == "__main__":
    main()
