"""The noise floor of chip_smoke.py's phase 14e logprob check, on one H100.

    python scripts/torch_logprob_floor.py [--tree DIR] [--repeat N]

Llama-3-8B at full width and depth with chip_smoke.py's random bf16
weights (its seed), `Engine(logprobs=True)` through EngineServer, 64
tokens a request, on phase 14's four prompts in phase 14e's batches of
two; every returned logprob against log_softmax of `forward(plain=True)`'s
f32 logits on the prompt and the tokens (chip_smoke.py:logprob_lattice).
It runs twice over: with kernel D, and with the engine's decode attention
on its plain version (ops/naive.py:naive_decode_attention), each
`--repeat` times. `--tree DIR` takes the package from another checkout
(the parent commit, say); chip_smoke.py's helpers come from this one.
Prints one JSON line a run and prompt: the largest and mean |engine -
plain|, the bf16 steps by which the token's logit moved (largest, and how
many positions moved 1 and 2), the largest residual off the bf16 lattice,
whether the run repeats the first bit for bit, and the same for a control
that rounds each engine logprob to bf16 (a bf16 log_softmax's output).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT,
                                                                             "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _summary(cs, lps, toks, logits):
    diff, steps, resid = cs.logprob_lattice(lps, toks, logits)
    return dict(max=diff.max().item(), mean=diff.mean().item(), steps_max=int(steps.max()),
                steps_1=int((steps == 1).sum()), steps_2=int((steps == 2).sum()),
                resid_max=resid.max().item(), resid_over_2e_3=int((resid > 2e-3).sum()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT, help="the checkout whose package is measured")
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_logprob_floor: needs an H100")
    sys.path.insert(0, os.path.abspath(args.tree))
    cs = _chip_smoke()
    from nnop_tpu_torch.models.llama import LlamaConfig, forward, init_params
    from nnop_tpu_torch.ops import naive
    from nnop_tpu_torch.runtime import engine as engine_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_decode = engine_mod.decode_attention

    def plain_decode(q, k, v, lengths, k_scale=None, v_scale=None, **kw):
        return naive.naive_decode_attention(q, k, v, lengths, k_scale, v_scale, **kw)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    cfg, dev = LlamaConfig.llama3_8b(), torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    params = init_params(gen, cfg)
    prompts = cs.span_prompts(np.random.default_rng(cs.SEED + 14), cfg.vocab_size,
                              (200, 450, 700, 1100))
    for decode, fn in (("kernel D", kernel_decode), ("plain", plain_decode)):
        engine_mod.decode_attention = fn
        first = {}
        for rep in range(args.repeat):
            for pair in (prompts[:2], prompts[2:]):
                eng = engine_mod.Engine(params, cfg, max_batch=8, max_seq=2048, logprobs=True)
                bodies, _, _ = cs._serve(eng, pair, cs.SPEC_NEW)
                del eng
                for prompt, body in zip(pair, bodies):
                    toks, lps = body["tokens"], body["logprobs"]
                    with torch.no_grad():
                        logits = forward(params, torch.tensor([prompt + toks[:-1]], device=dev),
                                         cfg, plain=True)[0, len(prompt) - 1:].float()
                    control = torch.tensor(lps).bfloat16().double().tolist()
                    same = first.setdefault(len(prompt), (toks, lps)) == (toks, lps)
                    print(json.dumps(dict(
                        tree=os.path.abspath(args.tree), decode=decode, run=rep,
                        prompt=len(prompt), repeats_first=same,
                        engine=_summary(cs, lps, toks, logits),
                        bf16_control=_summary(cs, control, toks, logits), card=card)),
                        flush=True)
                torch.cuda.empty_cache()
    engine_mod.decode_attention = kernel_decode


if __name__ == "__main__":
    main()
