"""Time the port's attention kernels in two or more checkouts on one card,
in turns, so that two versions are compared inside one call.

    python scripts/torch_flash_ab.py [--kernel flash|decode] ROOT_A ROOT_B [ROOT_B ROOT_A ...]

Each ROOT is a checkout holding `nnop_tpu_torch/`. Every ROOT runs in a
process of its own (it builds and imports its own kernels), at the shapes
of `chip_smoke.py` phase 3's main cases.

`--kernel flash` (the default): the featureless flash-attention kernels
C, dQ and dK/dV. C at q (1, 32, 512, 128) over kv (1, 8, 1536, 128) from
row offset 1024 (a prefill chunk), C causal at the 8B training geometry
q (2, 32, 4096, 128), kv (2, 8, 4096, 128), and dQ and dK/dV there; then
the same three kernels there with a pair bias (2, 32, 4096, 4096) bf16
and with segment ids (four documents of 1024), where the ROOT's kernels
take them (null where they raise).

`--kernel decode`: decode attention (kernel D) at `chip_smoke.py` phase
3's shapes, at T 1 and T 5 (the speculative verify): q (8, 32, T, 128)
over the Llama-3-8B cache (32, 8, 8, 2144, 128) and q (8, 32, T, 64) over
a TinyLlama-1.1B one (22, 8, 4, 2144, 64), lengths 0..2100, staged 5, in
bf16 and int8; G 8 at T 9 (q (4, 32, 9, 128), KH 4); Mistral's window (q
(4, 32, T, 128), lengths 300..8000, window 4096) and Gemma-2's head dim
256 with the softcap (window 4096, and its global layers), linear
in bf16 and int8 and paged (pages of 512) at T 1; and the paged
deployment (pools (32, 256, 8, 128, 128), lengths 512..640, staged 9,
and TinyLlama's E 64 there), bf16 and int8. Each case prints its tile
relative error against the plain version (null, with what it raised,
where the ROOT's D raises). The `ptxas -v` registers and spill-store
bytes of each decode instantiation are printed once per ROOT where its
process builds the kernels (empty where the ROOT's `build/` holds them
already).

One JSON line per ROOT: median ms over 5 repetitions of back-to-back
calls (CUDA events), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_PRELUDE = r"""
import json, re, statistics, subprocess, sys, torch

def ms(fn, n=20, reps=5):
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
def randn(*s, scale=1.0):
    return (torch.randn(s, generator=g, device="cuda") * scale).to(torch.bfloat16)

res = {}
"""

_FLASH = r"""
from nnop_tpu_torch.ops.flash_attention import flash_fwd
from nnop_tpu_torch.ops.flash_attention_bwd import flash_bwd_dkv, flash_bwd_dq

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
"""

_DECODE = r"""
from nnop_tpu_torch.ops import naive
from nnop_tpu_torch.ops.attention_decode import decode_attention
from nnop_tpu_torch.ops.attention_decode_paged import paged_decode_attention
from nnop_tpu_torch.utils.build import build

regs, entry, spill = {}, "", 0
for line in build().log.splitlines():  # ptxas -v: the entry, its spill stores, its registers
    if "Compiling entry function" in line:
        entry = line.split("'")[1]
    elif "spill stores" in line:
        spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
    elif "decode_kernel" in entry and "Used" in line and "registers" in line:
        m = re.search(r"decode_kernelILi(\d+)ELi(\d)E(.+?)Lb(\d)ELb(\d)E", entry)
        if m:  # split-KV: padded head dim, row tiles, cache type, paged, softcap
            E, rows, ty, paged, cap = m.groups()
            key = f"E{E} m{rows} {ty[-4:]} paged{paged} softcap{cap}"
        else:  # one block per (slot, KV head): q/cache types, paged, softcap, verify
            m = re.search(r"decode_kernelILi(\d+)E(.+?)Lb(\d)ELb(\d)E(?:Lb(\d)E)?", entry)
            E, ty, paged, cap, verify = m.groups()
            kind = {"ff": "f32", "fa": "f32/int8"}.get(ty, "bf16/int8" if ty.endswith("a") else "bf16")
            key = f"E{E} {kind} paged{paged} softcap{cap} verify{verify or 0}"
        regs[key] = [int(re.search(r"Used (\d+) registers", line).group(1)), spill]
res["registers"] = regs

def tile_err(got, ref, tile=64):
    def tiles(t):
        t = torch.nn.functional.pad(t, (0, 0, 0, -t.shape[2] % tile))
        return t.reshape(*t.shape[:2], -1, tile * t.shape[3])
    dn = tiles(got.float() - ref.float()).norm(dim=-1)
    rn = tiles(ref.float()).norm(dim=-1)
    return float("inf") if bool((dn[rn == 0] > 0).any()) else (dn[rn > 0] / rn[rn > 0]).max().item()

def case(key, args, kw, paged=False):
    op = paged_decode_attention if paged else decode_attention
    ref = naive.naive_paged_decode_attention if paged else naive.naive_decode_attention
    try:
        o = op(*args, **kw)
    except (NotImplementedError, ValueError, RuntimeError) as e:
        res[key + "_ms"], res[key + "_raised"] = None, f"{type(e).__name__}: {e}"[:200]
        return
    res[key + "_err"] = tile_err(o, ref(*args, **kw))
    res[key + "_ms"] = ms(lambda: op(*args, **kw))

def cache(shape, int8):
    if not int8:
        return (randn(*shape), randn(*shape)), ()
    return (tuple(torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)
                  for _ in range(2)),
            tuple(torch.rand(shape[:4], generator=g, device="cuda") * 0.02 + 0.01
                  for _ in range(2)))

def table_for(B, n_pages, max_pages):
    perm = torch.randperm(n_pages, generator=g, device="cuda").to(torch.int32)
    return perm[: B * max_pages].reshape(B, max_pages).contiguous()

# Llama-3-8B (E 128, G 4) and TinyLlama-1.1B (E 64, G 8): linear, T 1 and 5
lengths = torch.tensor([0, 1, 63, 64, 65, 300, 1100, 2100], dtype=torch.int32, device="cuda")
for name, NL, KH, E in (("", 32, 8, 128), ("e64_", 22, 4, 64)):
    stage = (randn(8, NL, KH, 32, E), randn(8, NL, KH, 32, E))
    for mode in ("bf16", "int8"):
        caches, scales = cache((NL, 8, KH, 2144, E), mode == "int8")
        for T in (1, 5):
            case(f"{name}{mode}_T{T}", (randn(8, 32, T, E), *caches, lengths, *scales),
                 dict(k_stage=stage[0], v_stage=stage[1], staged_n=5, layer=3))
        del caches, scales
# G 8 past the row bound: q (4, 32, 9, 128), KH 4 (z-split)
caches = (randn(2, 4, 4, 2144, 128), randn(2, 4, 4, 2144, 128))
st = (randn(4, 2, 4, 32, 128), randn(4, 2, 4, 32, 128))
case("g8_T9", (randn(4, 32, 9, 128), *caches,
               torch.tensor([0, 1, 65, 2100], dtype=torch.int32, device="cuda")),
     dict(k_stage=st[0], v_stage=st[1], staged_n=9, layer=1))
# Mistral's window and Gemma-2's head dim 256 with the softcap (and its
# global layers), linear in bf16 and int8 at T 1 and 5, paged at T 1
lens = torch.tensor([300, 4500, 6100, 8000], dtype=torch.int32, device="cuda")
for name, E, QH, KHf, cap, qs, win in (("mistral_window", 128, 32, 8, None, 1.0, 4096),
                                       ("gemma2_e256_softcap", 256, 8, 4, 50.0, 40.0, 4096),
                                       ("gemma2_global", 256, 8, 4, 50.0, 40.0, None)):
    st = (randn(4, 2, KHf, 32, E), randn(4, 2, KHf, 32, E))
    kw = dict(k_stage=st[0], v_stage=st[1], staged_n=5, layer=1, window=win, softcap=cap)
    for mode in ("bf16", "int8"):
        caches, scales = cache((2, 4, KHf, 8032, E), mode == "int8")
        for T in (1, 5):
            sfx = "" if mode == "bf16" else "_int8"
            case(f"{name}{sfx}_T{T}", (randn(4, QH, T, E, scale=qs), *caches, lens, *scales), kw)
        del caches, scales
        if win is None:
            continue
        counts = [-(-int(n) // 512) for n in lens.tolist()]
        pools, pscales = cache((2, sum(counts) + 4, KHf, 512, E), mode == "int8")
        perm = table_for(1, sum(counts) + 4, sum(counts) + 4)[0]
        table = torch.zeros((4, max(counts) + 1), dtype=torch.int32, device="cuda")
        for b, c in enumerate(counts):  # each slot its own pages, shuffled
            table[b, :c] = perm[sum(counts[:b]):sum(counts[:b]) + c]
        case(f"paged_{name}{'' if mode == 'bf16' else '_int8'}",
             (randn(4, QH, 1, E, scale=qs), *pools, table, lens, *pscales), kw, paged=True)
        del pools, pscales
# the paged deployment: pools (32, 256, 8, 128, 128), lengths 512..640, staged 9;
# TinyLlama's E 64 in the same geometry with KH 4
plen = torch.randint(512, 641, (32,), generator=g, device="cuda", dtype=torch.int32)
table = table_for(32, 256, 8)
for name, KH, E in (("paged", 8, 128), ("paged_e64", 4, 64)):
    st = (randn(32, 32, KH, 32, E), randn(32, 32, KH, 32, E))
    for mode in ("bf16", "int8"):
        pools, pscales = cache((32, 256, KH, 128, E), mode == "int8")
        case(f"{name}_{mode}", (randn(32, 32, 1, E), *pools, table, plen, *pscales),
             dict(k_stage=st[0], v_stage=st[1], staged_n=9, layer=3), paged=True)
        del pools, pscales
"""

_CARD = r"""
res["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()[0]
print(json.dumps(res))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("flash", "decode"), default="flash")
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args()
    if len(args.roots) < 2:
        sys.exit(__doc__)
    child = _PRELUDE + {"flash": _FLASH, "decode": _DECODE}[args.kernel] + _CARD
    seen = set()
    for root in args.roots:
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, "-c", child], cwd=root, capture_output=True,
                             text=True, env=dict(os.environ, PYTHONPATH=root))
        if out.returncode:
            sys.exit(f"{root}: exit {out.returncode}\n{out.stderr[-4000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        regs = res.pop("registers", None)
        if regs is not None and root not in seen:  # the build's report, once per ROOT
            seen.add(root)
            print(json.dumps(dict(root=root, registers=regs)))
        print(json.dumps(dict(root=root, **res)))


if __name__ == "__main__":
    main()
