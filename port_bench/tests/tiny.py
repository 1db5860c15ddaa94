"""Tiny versions of the benchmark's cells, for the CPU: the real cells'
files with the sizes cut so a test process holds them."""

from __future__ import annotations

import copy
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)

from pbench import spec  # noqa: E402

# limits of the tiny sizes, set from their own readings on the CPU (six
# sound seeds and three of the control each): a tiny bf16 model reads
# larger gaps than the cells' full widths, so the cells' limits do not hold
LIMITS = {
    "mistral-7b.train-l8192": {"loss_gap": 0.005, "grad1_gap": 0.009, "update_gap": 0.02},
    "mistral-7b.prefill-longdoc": {"logit_gap": 0.5, "logprob_gap": 0.5},
}
MOE_LIMITS = {
    "mistral-7b.train-l8192": {"loss_gap": 0.005, "grad1_gap": 0.009, "update_gap": 0.02,
                               "route_margin": 0.05},
    "mistral-7b.prefill-longdoc": {"logit_gap": 0.5, "logprob_gap": 0.5, "route_margin": 0.1},
}
CFG = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
           vocab_size=256)


def cell(name: str, experts=None, **over):
    """The tiny cell; experts=(n, k): every layer routes each token to k
    of n experts on the program's grouped path."""
    c = spec.cell(name)
    c = copy.deepcopy(c)
    c.config.update(CFG, num_hidden_layers=2)
    if experts:
        c.config.update(num_local_experts=experts[0], num_experts_per_tok=experts[1],
                        router_aux_loss_coef=0.02, moe_impl="grouped")
    if c.config.get("sliding_window"):
        c.config["sliding_window"] = 24
    t = c.traffic
    if t["kind"] == "packed_docs":
        t.update(seq_len=64, rows=8, doc_len={"median": 16, "sigma": 1.0, "min": 2, "max": 200})
    else:
        t.update(clients=2, prompt_len={"min": 20, "max": 90}, grid=16, warmup_requests=2,
                 sample=4)
        e = c.workload["engine"]
        c.workload["engine"] = dict(e, max_seq=128,
                                    options=dict(e.get("options", {}), prefill_chunk=32))
    c.workload["limits"] = dict((MOE_LIMITS if experts else LIMITS)[name])
    for k, v in over.items():
        getattr(c, k).update(v)
    return c
