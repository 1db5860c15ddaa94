"""Kernel C's numbers in two checkouts, and what phase 9a's gate makes of
them, on one H100.

    python scripts/torch_flash_numerics.py bits ROOT_A ROOT_B
    python scripts/torch_flash_numerics.py route9a ROOT [ROOT ...] [--prompts N]

Each ROOT is a checkout holding `nnop_tpu_torch/` and runs in a process of
its own (it builds and imports its own kernels; unpack the parent with
`git archive` into `build/`, which git ignores).

`bits`: C's o and lse on the same inputs (seed 7) at four shapes, q (1, 32,
512, 128) causal, the same chunk at offset 1024 over kv (1, 8, 1536, 128)
with kpad < 1100, the 8B training geometry at L 2048 (q (2, 32, 2048,
128)), and q (1, 32, 300, 64) over 4 KV heads; prints the share of
elements whose bits differ between ROOT_A and ROOT_B.

`route9a`: chip_smoke.py phase 9a's reference check alone (Mixtral-8x7B at
full depth, int8 weights, W8A8 prefill, chip_smoke's seed and prompts):
the engine's first-token logits against `forward(plain=True)`, as cosines,
for phase 9a's prompts 1 and 3 and N more prompts of 1100 tokens (seeds
SEED + 99 + i); chip_smoke.py's helpers come from this checkout. One JSON
line a ROOT, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BITS = r"""
import sys, torch
from nnop_tpu_torch.ops.flash_attention import flash_fwd
g = torch.Generator(device="cuda")
g.manual_seed(7)
def randn(*s):
    return torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
out = {}
for name, B, QH, KH, QL, KL, E, off, nv in (("bucket512", 1, 32, 8, 512, 512, 128, 0, None),
                                            ("chunk1024", 1, 32, 8, 512, 1536, 128, 1024, 1100),
                                            ("train2048", 2, 32, 8, 2048, 2048, 128, 0, None),
                                            ("e64", 1, 32, 4, 300, 300, 64, 0, None)):
    q, k, v = randn(B, QH, QL, E), randn(B, KH, KL, E), randn(B, KH, KL, E)
    kw = dict(causal=True, scale=E ** -0.5, causal_offset=off)
    if nv:
        kw["kpad_mask"] = (torch.arange(KL, device="cuda") < nv)[None]
    o, lse = flash_fwd(q, k, v, **kw)
    out[name] = (o.cpu(), lse.cpu())
torch.save(out, sys.argv[1])
"""

_ROUTE9A = r"""
import importlib.util, json, subprocess, sys
import numpy as np, torch
spec = importlib.util.spec_from_file_location("cs", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from nnop_tpu_torch.models.llama import LlamaConfig, forward, init_quantized_params
from nnop_tpu_torch.models.quantized import qmatmul
from nnop_tpu_torch.runtime.engine import Engine, fuse_decode_weights
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
# chip_smoke.py main()'s draws before phase 9's prompts
rng = np.random.default_rng(cs.SEED)
V = LlamaConfig.llama3_8b().vocab_size
_ = [rng.integers(0, V, n).tolist() for n in (150, 280, 400, 1100)]
fresh = [rng.integers(0, V, 512).tolist() for _ in range(16)]
_ = [p[:384] + rng.integers(0, V, 128).tolist() for p in fresh]
mix = [rng.integers(0, 32000, n).tolist() for n in (150, 280, 400, 1100)]
more = [np.random.default_rng(cs.SEED + 99 + i).integers(0, 32000, 1100).tolist()
        for i in range(int(sys.argv[2]))]
cfg = LlamaConfig.mixtral_8x7b()
gen = torch.Generator(device=dev)
gen.manual_seed(cs.SEED)
params = fuse_decode_weights(init_quantized_params(gen, cfg, wbits=8), in_place=True)
head = params["lm_head"]
eng = Engine(params, cfg, max_batch=8, max_seq=2048, quantized_kv=True, w8a8=True)
cos = []
with torch.no_grad():
    for p in [mix[1], mix[3]] + more:
        got = cs.first_logits(eng, p)
        want = forward(params, torch.tensor([p], device=dev), cfg, plain=True, w8a8=True,
                       matmul=lambda x, w: qmatmul(x, w, plain=True, w8a8=w is not head))[0, -1]
        cos.append(cs._cosine(got, want))
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip().splitlines()[0]
print(json.dumps(dict(prompts_1_3=cos[:2], more=cos[2:], below_0_99=sum(c < 0.99 for c in cos),
                      card=card)))
"""


def _run(root, code, *args):
    root = os.path.abspath(root)
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=root, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=root))
    if out.returncode:
        sys.exit(f"{root}: exit {out.returncode}\n{out.stderr[-4000:]}")
    return root, out.stdout


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("bits", "route9a"))
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--prompts", type=int, default=16)
    args = ap.parse_args()
    if args.what == "bits":
        import torch

        if len(args.roots) != 2:
            sys.exit("bits takes two roots")
        files = []
        for i, root in enumerate(args.roots):
            path = os.path.join(ROOT, "build", f"flash_bits_{i}.pt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            _run(root, _BITS, path)
            files.append(torch.load(path))
        for name, ((oa, la), (ob, lb)) in ((k, (files[0][k], files[1][k])) for k in files[0]):
            o_bits = (oa.view(torch.int16) != ob.view(torch.int16)).float().mean().item()
            lse_bits = (la.view(torch.int32) != lb.view(torch.int32)).float().mean().item()
            print(json.dumps(dict(shape=name, o_bits_differ=o_bits, lse_bits_differ=lse_bits,
                                  o_values_differ=(oa != ob).float().mean().item())))
        return
    for root in args.roots:
        root, out = _run(root, _ROUTE9A, os.path.join(ROOT, "chip_smoke.py"), str(args.prompts))
        print(json.dumps(dict(root=root, **json.loads(out.strip().splitlines()[-1]))))


if __name__ == "__main__":
    main()
