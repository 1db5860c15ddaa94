"""Drive the port's serving and training paths once on one H100:
Llama-3-8B, Mixtral-8x7B, Mistral-7B and Gemma-2-2B, each served and
trained; the NNop.jl op set (softmax, layer norm, attention with the
pair bias and segment ids) and packed-document training; speculative
decoding and per-token logprobs.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure raises and exits
non-zero:
  1. device: require an sm_90 card; print its name and power limit.
  2. build: compile nnop_tpu_torch/csrc/*.cu from this checkout (one nvcc
     per source, in parallel).
  3. kernels: each Hopper kernel on the card at the serving paths' shapes
     (plus edge cases), held against its plain PyTorch version on the same
     inputs, both timed by CUDA events, with one PyTorch library call that
     computes the same function timed beside it where there is one. The
     paged modes of D and E run at the paged deployment's shapes (phase 7),
     and E's one-token write beside them; kernel I's four modes at
     Mixtral's decode and prefill shapes (phase 9); C, D and E with the
     sliding window, the softcap and head dim 256 at Mistral-7B's and
     Gemma-2-2B's shapes (phase 11: C at a chunk past the window, with
     and without it; C causal at L 8192; D's four modes at lengths on
     both sides of the window; q scaled up so that the softcap binds),
     held to a relative error per 64-row tile of each head, A and B at
     Gemma-2's widths, and planted faults that must read above that
     limit: the plain version with the window one key (and one 32-key
     tile) too wide, or without the softcap. The op set: softmax and
     layer norm forward and backward at (16384, 4096) in f32 and bf16 and
     softmax at (4096, 128256) (column chunks), held per row to a
     relative error; C, dQ (with dpair) and dK/dV with the pair bias
     (N(0, 1)) at bench.py's reference grid and the 8B training geometry,
     with segment ids at attn8b_seg, and at head dims 32 and 96 (padded),
     per 64-row tile (dpair per 64 x 64 tile); planted faults (the
     softmax denominator without a column chunk, layer norm without the
     mean, no pair, dpair without a key tile, a document boundary moved
     by one key) must read above those limits.
  4. bf16 path: Llama-3-8B at full width and depth (random bf16 weights
     from a seeded torch.Generator on the card) behind the port's
     EngineServer; 4 concurrent /v1/completions requests (one through
     chunked admission), launch counters, and the engine's first-token
     logits against models.llama.forward on the plain ops.
  5. int8 path: the same model with random int8 weights
     (init_quantized_params), Engine(quantized_kv=True, w8a8=True): the
     same 4 requests; W8A8 prefill products, weight-only decode products,
     the int8 KV cache in decode attention and the flush.
  6. int4 path: packed int4 weights with the int8 KV cache; 2 requests.
  7. paged path, run between 5 and 6 on phase 5's weights: the repo's
     paged deployment (scripts/bench_engine.py --paged): int8 weights
     with W8A8 prefill products, Engine(max_batch=32, max_seq=648,
     chunk_size=16, quantized_kv=True, paged=True, prefix_cache=True), 32
     concurrent requests of 512 prompt tokens, half of them repeating the
     first 384 tokens (3 pages) of another; prefix hits, page accounting,
     and no launch of the linear decode attention or flush.
  9. Mixtral-8x7B (LlamaConfig.mixtral_8x7b) at full width behind
     EngineServer, greedy, prompts of phase 4's lengths from its vocabulary:
     (a) full depth, random int8 projections and experts, the engine's
     fused tree built in place, Engine(quantized_kv=True, w8a8=True), 4
     requests: W8A8 grouped products at prefill (Tp >= 1024), weight-only
     grouped products at decode, peak memory; (b) 12 layers (93 GB of bf16
     weights at full depth do not fit one card): bf16 weights and cache, 4
     requests (the bf16 grouped product), then the same weights as packed
     int4 with the int8 cache, 2 requests. First-token cosine ≥ 0.99 against
     the plain forward, and the share of expert assignments in which the
     two paths differ. Runs after 6, before training.
  8. training, after the serving phases: (a) gradient parity at full
     width, Llama-3-8B with 2 layers, B=1, L=2048: loss_fn and every
     gradient leaf through the kernels against the plain ops on the card;
     (b) cli.train_loop on Llama-3-8B at full width with 8 layers, B=1,
     L=4096, the CLI's synthetic stream, AdamW at lr 1e-4 (the CLI's
     default 1e-3 raises step 1's loss there), 5 steps: finite losses,
     step 1's batch at a lower loss after the last step, the exact launch
     counts of every step, no plain version called; ms per step, tokens/s,
     peak memory and a torch.profiler breakdown of the last step.
 10. MoE training, after 8: (a) one Mixtral MoE layer at full width (T
     4096, bf16, moe_impl="grouped"): the gradients of h, w_router, w_gate,
     w_up and w_down and the aux term through kernel I (forward and dx)
     and the dw kernel against the plain versions, and against the einsum
     path; (b) phase 8b's trainer on Mixtral-8x7B at full width with 2
     layers (moe_impl="grouped"; full depth needs 560 GB for weights,
     gradients and moments).
 11. the families at full width and full depth, after 10, greedy through
     EngineServer on random bf16 weights, prompts of 300, 4600 and 6200
     tokens x 32 new (two admitted in chunks past the window, two decoding
     past it): (a) Mistral-7B (window 4096), Engine(max_batch=4,
     max_seq=8192), linear bf16 cache; (b) the same weights paged with the
     int8 cache, the two long prompts, every page back; (c) Gemma-2-2B
     (head dim 256, window 4096 on every other layer, softcaps 50 and 30)
     on (a)'s engine; (d) a 2-layer Mistral-7B written as a local HF
     directory (config.json, two bf16 shards), read back by config_from_hf
     and load_hf_llama: greedy streams identical to the same weights served
     directly. Window launches of C and D in (a)-(c), softcap launches in
     (c), first-token cosine >= 0.99 on every prompt, peak memory.
 13. the families trained, after 12: (a) the loss and every gradient
     leaf of Mistral-7B and of Gemma-2-2B at full width with 2 layers
     (Gemma-2: layer 0 windowed, layer 1 global), B 1, L 4608 (the window
     binds past 4096), through the kernels against the plain ops; (b)
     phase 8b's trainer on Mistral-7B with 8 layers and (c) on Gemma-2-2B
     with GEMMA2_TRAIN_LAYERS, B 1, L 8192, 5 steps: every C, dQ and
     dK/dV launch in the family's mode (Mistral's window at head dim 128;
     Gemma-2's softcap at head dim 256, windowed on its even layers),
     exact every step, and no plain version called.
 12. the op set, after 11: (a) online_softmax, layer_norm and
     flash_attention with the pair and with segment ids through
     torch.autograd at phase 3's shapes, one launch of each kernel per
     call, exact; (b) Llama-3-8B at full width with 2 layers, B 1, L
     4096, on a row of random documents (200-1800 tokens) packed by
     pack_tokens_segmented with positions reset per document:
     forward(segment_ids=, positions=), the mean next-token
     cross-entropy and its backward with exact launches (C, dQ and dK/dV
     in their segment modes); each document's logits against the
     document run alone (cosine >= 0.999), every gradient leaf against
     plain=True (cosine >= 0.9995); the step's ms and peak memory.
 15. the CLI's defaults and head dim 64, last: (a) `cli generate --prompt
     abcabc` and `cli train --steps 3` with every other default (f32
     `tiny`, head dim 32, on cuda) through cli.main: 32 tokens, a finite
     loss, D's E 32 f32 mode, C, dQ, dK/dV and E launched; (b) a bf16
     LlamaConfig at TinyLlama-1.1B's published widths (dim 2048, 32 heads
     over 4 KV heads, head dim 64, 22 layers, hidden 5632, vocab 32000;
     random weights from the seed) behind EngineServer as phase 4 serves,
     first-token cosine >= 0.99 against the plain forward; (c) the same
     weights with spec_k=4 as phase 14 runs it (D's verify mode at E 64).
 14. speculative decoding and logprobs, each on weights a serving phase
     holds (run right after it), prompts of repeated 64-token runs (so
     that prompt lookup finds drafts), 64 new tokens each, through
     EngineServer: (a) after 4, Llama-3-8B bf16, Engine(max_batch=8,
     max_seq=2048, spec_k=4), 4 requests of 200-1100 tokens; (b) after
     5, the int8 weights and cache; (c) after 11c, Gemma-2-2B at prompts
     of 300, 4600 and 6200 tokens (the verify mode at head dim 256 with
     the window and the softcap). Each: every prompt's first verify
     step's 5 rows of logits, taken by make_spec_chunk(with_logits=True)
     outside the served runs, against forward(plain=True) on the prompt
     and the 5 input tokens (cosine >= 0.99); the streams against the
     plain engine's on the same prompts, identical or parted where the
     plain forward's logits of the two tokens tie (within NEAR_TIE_REL of
     max|logit|; at most WIDE_TIES_MAX a phase past that, within
     WIDE_TIE_ULPS; each parting printed by kind); D's verify launches =
     layers x verify steps dispatched (counted by E's flushes) and no
     T = 1 launch of D; tokens per verify step and both engines' tokens/s
     (observations). (d) a sampled spec request (temperature 0.8, top_p
     0.9) runs to its length; (e) Engine(logprobs=True) through the
     server's "logprobs" field, each value against log_softmax of the
     plain forward's f32 logits (the token's logit at most LOGPROB_STEPS
     bf16 steps away, the rest within LOGPROB_RESID), the first against the
     engine's own f32 first-token logits (LOGPROB_OWN_TOL, below a bf16
     logprob's rounding), and spec decoding with logprobs or paged raises
     ValueError.
Phase 3 also holds kernel D's speculative-verify mode (T > 1) at the spec
path's shapes: Llama-3-8B's cache with q (8, 32, 5, 128) in bf16 and
int8, Mistral-7B past its window, Gemma-2-2B at head dim 256 with the
softcap binding, and G 8 at T 9 (three z-blocks), per 64-row tile
against the plain version, with SDPA over the joined K/V and the same
mask as the yardstick (with the softcap, compiled flex_attention's
forward, its softcap as score_mod) and planted faults (the intra-draft mask one
staged row too wide, every draft cut at the first draft's window edge,
the last z-block's rows dropped) that must read above the limit.
Phase 3 also holds D's split-KV combine: at the 8B bf16 row a
rerun is bit-identical, the plain split-then-merge over the split plan's
ranges (naive_decode_partials, lse_merge) is o, and the same merge
without the split holding the longest slot's middle rows (a planted
fault) must read above the limit; every D row is also held per 64-row
tile; D at E 64 (TinyLlama-1.1B's geometry: bf16, int8, verify, paged)
and E 32 f32 (`tiny`); and the library yardsticks of D's T = 1 and paged
bf16 rows (SDPA over the joined live K/V with a boolean mask; with the
softcap compiled flex_attention) and of E's bf16 flushes (index_put_ of
the staged rows).
Phase 3 also holds the AdamW kernel on Mistral-7B's 8-layer leaves (bf16
params and gradients, f32 moments; 2.007 B parameters, 22 bytes each)
against the plain eager update, one leaf at a time from the same state:
mu and nu within 1e-6 of the leaf's largest, p within one bf16 ulp; the
step's time against its byte bound; no library call takes bf16 params
with f32 moments.
Phase 3 also holds the grouped backward at Mixtral's training shapes: dw
(the new kernel) and dx (kernel I on the transposed experts), a planted
fault, two bit-identical dw runs, experts without a row; and the
families' training kernels at B 1, L 8192: A-bwd at Gemma-2's rows with
offset 1, B's backward at head dim 256, C, dQ and dK/dV with Mistral's
window, Gemma-2's softcap (binding) with and without the window, head
dim 256 without features (MQA) and segment ids with the softcap, per
64-row tile against the plain backward (one group of heads at a time),
with planted faults (the window one key or one 64-key tile too wide, dS
without the factor 1 - t^2, dq without its upper 128 lanes) and two
bit-identical runs; the library yardstick is SDPA's backward, or with
the softcap compiled flex_attention's.
Each serving phase (and phases 8b, 10b, 12, 13b-c, 14a-c and 15a-c) sets the launch counts to 0
just before it runs and reads them just after. The seconds of each phase
are printed before the last two lines: {"kernels": [...]}, then {"ok":
true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

BF16_TOL = 2e-2
BF16_TOL_WHY = ("bf16 output: one bf16 ulp is <= 1.6e-2 below magnitude 4, "
                "and both sides accumulate in fp32 in a different order")
QMM_TOL_WHY = ("2e-2 * max(1, max|plain|): bf16 output of fp32 sums over K up to 14336 "
               "taken in another order")
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp8": 1979e12, "f32": 67e12}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def device_ms(fn, n=20, reps=5):
    """Median over `reps` of the per-call device time of `n` back-to-back
    calls, from CUDA events. A spin kernel runs first so that the host
    queues all n launches before the card reaches them: the events then
    time the card, not the host's launch rate (unless the host takes
    longer than the spin, as a plain version with a host sync does)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n)
    return statistics.median(out)


def library_ms(name, fn, n=20):
    """The time of one PyTorch library call computing the kernel's
    function (a yardstick the port never calls), or None with the error
    printed when this torch refuses it."""
    try:
        return device_ms(fn, n=n)
    except Exception as e:  # noqa: BLE001 - the yardstick is optional; report why
        print(f"phase 3 {name}: library call raised {type(e).__name__}: "
              f"{str(e).splitlines()[0][:300]}")
        return None


def bound(nbytes, ops, kind):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else
                "operations")


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def tile_rel_err(got, ref, tile=64):
    """The largest |got - ref| / |ref| (Frobenius norms) over the `tile`-row
    tiles of each (batch, head) of (B, H, N, E) tensors. Each tile is held
    to its own scale, so an error on the deep rows or keys, whose gradients
    are small, reads as large as one on the first. A tile whose reference
    is zero must be zero."""
    def tiles(t):
        t = torch.nn.functional.pad(t, (0, 0, 0, -t.shape[2] % tile))
        return t.reshape(*t.shape[:2], -1, tile * t.shape[3])

    dn = tiles(got.float() - ref.float()).norm(dim=-1)
    rn = tiles(ref.float()).norm(dim=-1)
    zero = rn == 0
    if bool((dn[zero] > 0).any()):
        return float("inf")
    return (dn[~zero] / rn[~zero]).max().item()


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def phase_device():
    from nnop_tpu_torch.utils.platform import require_hopper

    name = require_hopper()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1 device: {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")
    print(smi)


def phase_build():
    from nnop_tpu_torch.utils.build import build, load_library

    res = build()
    load_library()
    print(f"phase 2 build: {res.seconds:.2f} s nvcc -> {res.path}")
    entry = spill = ""
    for line in res.log.splitlines():
        if "Compiling entry function" in line:  # the mangled name holds the kernel's name
            entry = line.split("'")[1]
            flash = re.search(r"(flash_(fwd|bwd_dq|bwd_dkv)_kernel)ILi(\d+)ELb(\d)ELb(\d)ELb(\d)",
                              entry)
            decode = re.search(r"decode_kernelILi(\d+)ELi(\d)E(.+?)Lb(\d)ELb(\d)E", entry)
            if flash:  # C's flags: softcap, window, extra; the backward's: window, softcap, extra
                name, kind, E, *bits = flash.groups()
                flags = ("softcap", "window") if kind == "fwd" else ("window", "softcap")
                entry = f"{name} E {E} " + " ".join(
                    f"{f} {b}" for f, b in zip((*flags, "extra"), bits))
            elif decode:  # D: padded head dim, row tiles, cache type, paged, softcap
                E, tiles, kind, *bits = decode.groups()
                kind = {"f": "f32", "a": "int8"}.get(kind, "bf16")
                entry = f"decode_kernel E {E} row tiles {tiles} {kind} cache " + " ".join(
                    f"{f} {b}" for f, b in zip(("paged", "softcap"), bits))
            else:
                entry = entry.split("_cu_")[-1][:70]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line or "error" in line.lower():
            print(f"  ptxas: {entry}: {line.strip()}; {spill}")


class Phase3:
    """Phase 3's bookkeeping: every case is checked; the main case of each
    kernel entry keeps its error, times, bound and library time."""

    def __init__(self):
        self.results = {}

    def report(self, name, case, err, tol, why, ms=None, plain_ms=None, bounds=None,
               library=None, main=False, measure="max_abs_err", abs_err=None):
        """bounds: bound()'s dict for a timed case; library: the library
        call's ms (main cases; None where there is none). `err` is what
        `measure` names; where that is not the max abs error (the
        gradients' relative errors), abs_err gives it for the kernels line."""
        timing = "" if ms is None else f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        if bounds is not None:
            timing += f"; bound {bounds['bound_ms']:.4f} ms ({bounds['bound_by']})"
        if main or library is not None:
            timing += "; library " + ("none" if library is None else f"{library:.4f} ms")
        shown = "" if abs_err is None else f"; max_abs_err {abs_err:.3e}"
        print(f"phase 3 {name} [{case}]: {measure} {err:.3e} (tol {tol:g}: {why}){shown}"
              f"{timing}")
        check(err <= tol, f"{name} [{case}] {measure} {err} > {tol}")
        if main:
            self.results[name] = dict(max_abs_err=err if abs_err is None else abs_err, ms=ms,
                                      plain_ms=plain_ms, library_ms=library, **bounds)


def phase_kernels():
    """Returns {kernel entry: {max_abs_err, ms, plain_ms, bound_ms,
    bound_by, library_ms}} at the main shape of each entry, after checking
    every case."""
    import torch.nn.functional as F

    from nnop_tpu_torch.ops import naive
    from nnop_tpu_torch.ops.attention_decode import decode_attention
    from nnop_tpu_torch.ops.flash_attention import flash_fwd
    from nnop_tpu_torch.ops.kv_write import flush_staging
    from nnop_tpu_torch.ops.rms_norm import rms_norm
    from nnop_tpu_torch.ops.rope import RotaryEmbedding, llama_rope

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    bf = torch.bfloat16
    p3 = Phase3()

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # A. rms_norm: decode rows (8) and a prefill chunk (512), width 4096
    w = (0.5 + 0.1 * torch.randn(4096, generator=gen, device=dev)).to(bf)
    for rows in (8, 512):
        x = randn(rows, 4096)
        lib = library_ms("rms_norm", lambda: F.rms_norm(x, (4096,), w, 1e-5))
        err = max_err(rms_norm(x, w, 1e-5), naive.naive_rms_norm(x, w, eps=1e-5))
        p3.report("rms_norm", f"({rows}, 4096) bf16", err, BF16_TOL, BF16_TOL_WHY,
                  device_ms(lambda: rms_norm(x, w, 1e-5)),
                  device_ms(lambda: naive.naive_rms_norm(x, w, eps=1e-5)),
                  bound(2 * nbytes(x) + nbytes(w), 4 * x.numel(), "f32"), lib, rows == 8)

    # B. llama_rope: decode (8 slots at ragged positions) and a 512-row chunk
    rope = RotaryEmbedding(128, 500000.0)
    for (B, L, pos) in ((8, 1, [[0], [1], [63], [64], [65], [300], [1100], [2100]]),
                        (1, 512, [list(range(100, 612))])):
        q, k = randn(B, 32, L, 128, scale=0.5), randn(B, 8, L, 128, scale=0.5)
        cos, sin = rope(torch.tensor(pos, device=dev))
        got, want = llama_rope(q, k, cos, sin), naive.naive_rope(q, k, cos, sin)
        err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        p3.report("llama_rope", f"q ({B}, 32, {L}, 128) bf16", err, BF16_TOL, BF16_TOL_WHY,
                  device_ms(lambda: llama_rope(q, k, cos, sin)),
                  device_ms(lambda: naive.naive_rope(q, k, cos, sin)),
                  bound(2 * nbytes(q, k) + nbytes(cos, sin), 3 * (q.numel() + k.numel()), "f32"),
                  None, B == 8)

    # C. flash forward: chunked prefill (offset + kpad), bucketed causal,
    #    an offset that is not a tile multiple, a length that is not one
    scale = 128 ** -0.5
    for case, QL, KL, causal, offset, n_valid, is_main in (
        ("chunked: 512 rows at offset 1024 of a 1536 buffer", 512, 1536, True, 1024, 1100, True),
        ("chunked: offset 100 (not a tile multiple), kpad < 612", 512, 1024, True, 100, 612,
         False),
        ("bucketed causal prefill, L=512", 512, 512, True, None, None, False),
        ("causal, L=300 (not a tile multiple)", 300, 300, True, None, None, False),
        ("non-causal, 100 rows x 300 keys", 100, 300, False, None, None, False),
    ):
        q, k, v = randn(1, 32, QL, 128), randn(1, 8, KL, 128), randn(1, 8, KL, 128)
        kw = dict(causal=causal, scale=scale)
        if offset is not None:
            kw.update(causal_offset=offset,
                      kpad_mask=(torch.arange(KL, device=dev) < n_valid)[None])
        o, lse = flash_fwd(q, k, v, **kw)
        o_ref, lse_ref = naive.naive_attention(q, k, v, return_lse=True, **kw)
        err = max(max_err(o, o_ref), max_err(lse, lse_ref))
        # the (row, key) pairs this case computes: causal from its offset, under kpad
        cols = torch.arange(KL, device=dev)[None]
        mask = torch.ones((QL, KL), dtype=torch.bool, device=dev)
        if causal:
            mask &= cols <= (offset or 0) + torch.arange(QL, device=dev)[:, None]
        if n_valid is not None:
            mask &= cols < n_valid
        lib = library_ms("flash_fwd", lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, enable_gqa=True))
        p3.report("flash_fwd", case, err, BF16_TOL, BF16_TOL_WHY + " (o bf16, lse f32)",
                  device_ms(lambda: flash_fwd(q, k, v, **kw)),
                  device_ms(lambda: naive.naive_attention(q, k, v, **kw), n=5),
                  bound(nbytes(q, k, v, o, lse), 4 * 128 * 32 * int(mask.sum()), "bf16"), lib,
                  is_main)

    # D/E share the engine's cache: (32, 8, 8, 2144, 128) bf16 or int8 with
    # per-token scales, staging (8, 32, 8, 32, 128) bf16, ragged lengths
    # with an empty slot
    NL, B, KH, S, W = 32, 8, 8, 2144, 32
    len_list = [0, 1, 63, 64, 65, 300, 1100, 2100]
    lengths = torch.tensor(len_list, dtype=torch.int32, device=dev)
    k_stage, v_stage = randn(B, NL, KH, W, 128), randn(B, NL, KH, W, 128)
    q = randn(B, 32, 1, 128)
    for mode in ("bf16", "int8"):
        name = "decode_attention" if mode == "bf16" else "decode_attention_int8"
        if mode == "bf16":
            caches, scales = (randn(NL, B, KH, S, 128), randn(NL, B, KH, S, 128)), ()
        else:
            caches = tuple(torch.randint(-127, 128, (NL, B, KH, S, 128), generator=gen,
                                         device=dev, dtype=torch.int8) for _ in range(2))
            scales = tuple(torch.rand((NL, B, KH, S), generator=gen, device=dev) * 0.02 + 0.01
                           for _ in range(2))
        args = (q, *caches, lengths, *scales)
        for n in (5, 0, 32):
            dkw = dict(k_stage=k_stage, v_stage=v_stage, staged_n=n, layer=3)
            o = decode_attention(*args, **dkw)
            o_ref = naive.naive_decode_attention(*args, **dkw)
            check(o[0].abs().max().item() == 0.0, "decode: the empty slot must give zeros")
            if n != 5:
                p3.report(name, f"staged_n {n}", max_err(o, o_ref), BF16_TOL, BF16_TOL_WHY)
                continue
            item = caches[0].element_size()
            live = sum(len_list) * KH * 128 * 2  # K and V values of the live rows
            staged = sum(1 for x in len_list if x > 0) * n * KH * 128 * 2
            moved = (live * item + staged * 2 + nbytes(q, o)
                     + (sum(len_list) * KH * 2 * 4 if mode == "int8" else 0))
            ops = 4 * 128 * 32 * (sum(len_list) + staged // (KH * 128 * 2))
            lib = None
            if mode == "bf16":  # SDPA over the joined live K/V; no call reads an int8 cache
                lib = decode_library(name, q, *caches, k_stage, v_stage, lengths, 3, n, None)
                split_fault(name, o, q, caches, lengths, dkw)
            case = (f"q (8, 32, 1, 128), {mode} cache (32, 8, 8, 2144, 128), lengths 0..2100, "
                    "staged_n 5")
            p3.report(name, case, max_err(o, o_ref), BF16_TOL, BF16_TOL_WHY,
                      device_ms(lambda: decode_attention(*args, **dkw)),
                      device_ms(lambda: naive.naive_decode_attention(*args, **dkw)),
                      bound(moved, ops, "bf16"), lib, True)
            p3.report(name, f"{case}, per 64-row tile", tile_rel_err(o, o_ref), ATTN_REL_TOL,
                      ATTN_REL_WHY, measure="tile relative error")

        # E. flush: bit-exact against the plain flush (values and scales)
        name = "flush_staging" if mode == "bf16" else "flush_staging_int8"
        cache_args = [*caches, *(scales or (None, None))]
        got = [t.clone() if t is not None else None for t in cache_args]
        flush_staging(*got, k_stage, v_stage, lengths)
        want = [t.clone() if t is not None else None for t in cache_args]
        naive.naive_flush_staging(want[0], want[1], k_stage, v_stage, lengths, want[2], want[3])
        pairs = [(g, w_) for g, w_ in zip(got, want) if g is not None]
        check(all(torch.equal(g, w_) for g, w_ in pairs), f"{name} is not bit-exact")
        err = max(max_err(g, w_) for g, w_ in pairs)
        rows = B * NL * KH * W
        moved = nbytes(k_stage, v_stage) + 2 * rows * 128 * caches[0].element_size() + (
            2 * rows * 4 if mode == "int8" else 0)
        lib = flush_library(name, want[:2], k_stage, v_stage, lengths) if mode == "bf16" else None
        p3.report(name, f"(8, 32, 8, 32, 128) -> (32, 8, 8, 2144, 128) {mode}", err, 0.0,
                  "a copy or the same IEEE quantization: bit-exact",
                  device_ms(lambda: flush_staging(*got, k_stage, v_stage, lengths)),
                  device_ms(lambda: naive.naive_flush_staging(
                      want[0], want[1], k_stage, v_stage, lengths, want[2], want[3]), n=3),
                  bound(moved, 0, "f32"), lib, True)
        del caches, scales, args, got, want, pairs
        torch.cuda.empty_cache()

    phase_paged_kernels(p3, gen, randn)
    phase_small_head_dims(p3, gen, randn)
    phase_products(p3, gen, randn)
    phase_grouped(p3, gen, randn)
    phase_grouped_bwd(p3, gen, randn)
    phase_train_kernels(p3, gen, randn)
    phase_family_kernels(p3, gen, randn)
    phase_verify_kernels(p3, gen, randn)
    phase_family_train_kernels(p3, gen, randn)
    phase_opset_kernels(p3, gen, randn)
    phase_adamw_kernel(p3, gen, randn)
    return p3.results


BWD_REL_TOL = 1e-2
BWD_REL_WHY = ("the largest |got - plain| / |plain| over the 64-row query (dq) or key (dk, dv) "
               "tiles of every head. On an H100 80GB HBM3 at 700 W the kernels read 3.9e-4 to "
               "1.1e-3 (bf16 rounding of the outputs, and of P and dS where the fp32 sums before "
               "them differ in order) and planted faults 0.12 to 0.85 (phase 3 prints them)")
DW_REL_TOL = 1e-5
DW_REL_WHY = ("|dw - plain| / |plain|: the same fp32 products summed over 4096 rows in another "
              "order, ~1e-7 relative per sum")


def phase_train_kernels(p3, gen, randn):
    """The training path's kernels: A with rstd and A-bwd at (4096, 4096),
    B backward at q (1, 32, 4096, 128), C then dQ and dK/dV at the 8B
    training geometry (q (2, 32, 4096, 128), kv (2, 8, 4096, 128), causal),
    the backward's edge cases, and two bit-identical backward runs."""
    import torch.nn.functional as F

    from nnop_tpu_torch.ops import naive
    from nnop_tpu_torch.ops.flash_attention import flash_fwd
    from nnop_tpu_torch.ops.flash_attention_bwd import (
        flash_attention_bwd,
        flash_bwd_dkv,
        flash_bwd_dq,
    )
    from nnop_tpu_torch.ops.rms_norm import rms_norm_bwd, rms_norm_fwd
    from nnop_tpu_torch.ops.rope import RotaryEmbedding, llama_rope_bwd

    dev = torch.device("cuda")
    bf = torch.bfloat16

    # A with rstd, A-bwd: the 8B trainer's rows (B * L = 4096), offset 0
    x, dy = randn(4096, 4096), randn(4096, 4096)
    w = (0.5 + 0.1 * torch.randn(4096, generator=gen, device=dev)).to(bf)
    y, rstd = rms_norm_fwd(x, w, 1e-5)
    y_ref, rstd_ref = naive.naive_rms_norm_fwd(x, w, eps=1e-5)
    rel = ((rstd - rstd_ref).abs() / rstd_ref).max().item()
    check(rel <= 1e-5, f"rms_norm_rstd: rstd relative error {rel} > 1e-5")
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    p3.report("rms_norm_rstd", f"(4096, 4096) bf16 (rstd relative error {rel:.2e} <= 1e-5)",
              max_err(y, y_ref), BF16_TOL, BF16_TOL_WHY,
              device_ms(lambda: rms_norm_fwd(x, w, 1e-5)),
              device_ms(lambda: naive.naive_rms_norm_fwd(x, w, eps=1e-5)),
              bound(2 * nbytes(x) + nbytes(w, rstd), 4 * x.numel(), "f32"),
              library_ms("rms_norm_rstd", lambda: F.rms_norm(xg, (4096,), wg, 1e-5)), True)
    dx, dw = rms_norm_bwd(x, w, rstd, dy)
    dx_ref, dw_ref = naive.naive_rms_norm_bwd(x, w, rstd, dy)
    p3.report("rms_norm_bwd", "dw (4096,) f32, summed over 4096 rows",
              ((dw - dw_ref).norm() / dw_ref.norm()).item(), DW_REL_TOL, DW_REL_WHY,
              measure="relative error", abs_err=max_err(dw, dw_ref))
    y_lib = F.rms_norm(xg, (4096,), wg, 1e-5)
    p3.report("rms_norm_bwd", "dx (4096, 4096) bf16", max_err(dx, dx_ref), BF16_TOL,
              BF16_TOL_WHY, device_ms(lambda: rms_norm_bwd(x, w, rstd, dy)),
              device_ms(lambda: naive.naive_rms_norm_bwd(x, w, rstd, dy)),
              bound(3 * nbytes(x) + nbytes(w, rstd, dw), 8 * x.numel(), "f32"),
              library_ms("rms_norm_bwd", lambda: torch.autograd.grad(
                  y_lib, (xg, wg), dy, retain_graph=True)), True)
    del x, dy, xg, wg, y_lib, dx, dx_ref, y, y_ref

    # B backward: the inverse rotation of the 8B trainer's q and k gradients
    dq, dk = randn(1, 32, 4096, 128, scale=0.5), randn(1, 8, 4096, 128, scale=0.5)
    cos, sin = RotaryEmbedding(128, 500000.0)(torch.arange(4096, device=dev)[None])
    got, want = llama_rope_bwd(dq, dk, cos, sin), naive.naive_rope(dq, dk, cos, sin, -1.0)
    p3.report("llama_rope_bwd", "dq (1, 32, 4096, 128), dk (1, 8, 4096, 128) bf16",
              max(max_err(got[0], want[0]), max_err(got[1], want[1])), BF16_TOL, BF16_TOL_WHY,
              device_ms(lambda: llama_rope_bwd(dq, dk, cos, sin)),
              device_ms(lambda: naive.naive_rope(dq, dk, cos, sin, -1.0)),
              bound(2 * nbytes(dq, dk) + nbytes(cos, sin), 3 * (dq.numel() + dk.numel()), "f32"),
              None, True)
    del dq, dk, got, want

    # C, dQ and dK/dV at the 8B training geometry
    def plain_bwd(q, k, v, o, lse, do, **kw):
        """naive_attention_bwd one batch element at a time (its fp32
        (QH, QL, KL) intermediates are 2.1 GB each at L = 4096)."""
        kp = kw.pop("kpad_mask", None)
        parts = [naive.naive_attention_bwd(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], o[b:b + 1], lse[b:b + 1], do[b:b + 1],
            kpad_mask=None if kp is None else kp[b:b + 1], **kw) for b in range(q.shape[0])]
        return tuple(torch.cat(t) for t in zip(*parts))

    def plain_fwd(q, k, v, **kw):
        parts = [naive.naive_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], return_lse=True,
                                       **kw) for b in range(q.shape[0])]
        return tuple(torch.cat(t) for t in zip(*parts))

    L, scale = 4096, 128 ** -0.5
    kw = dict(causal=True, scale=scale)
    q, k, v, do = (randn(2, h, L, 128) for h in (32, 8, 8, 32))
    o, lse = flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = plain_fwd(q, k, v, **kw)
    pairs = 2 * 32 * L * (L + 1) // 2  # the (row, key) pairs causal attention computes
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    sdpa = functools.partial(F.scaled_dot_product_attention, is_causal=True, scale=scale,
                             enable_gqa=True)
    p3.report("flash_fwd", "8B training geometry: q (2, 32, 4096, 128), kv (2, 8, 4096, 128), "
              "causal", max(max_err(o, o_ref), max_err(lse, lse_ref)), BF16_TOL,
              BF16_TOL_WHY + " (o bf16, lse f32)", device_ms(lambda: flash_fwd(q, k, v, **kw), n=5),
              device_ms(lambda: plain_fwd(q, k, v, **kw), n=1, reps=3),
              bound(nbytes(q, k, v, o, lse), 4 * 128 * pairs, "bf16"),
              library_ms("flash_fwd", lambda: sdpa(q, k, v), n=5))
    del o_ref, lse_ref
    again = flash_fwd(q, k, v, **kw)
    check(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
          "flash_fwd: two runs on the same inputs differ")
    print("phase 3 flash_fwd: two runs at the 8B training geometry are bit-identical (o, lse)")
    del again
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, **kw)
    ref = plain_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
          "dQ/dK/dV: two runs on the same inputs differ")
    print("phase 3 flash_bwd: two runs of dQ and dK/dV on the same inputs are bit-identical")
    del again
    graph = []  # SDPA's forward, run once by the warm-up call

    def sdpa_bwd():
        if not graph:
            graph.append(sdpa(qg, kg, vg))
        return torch.autograd.grad(graph[0], (qg, kg, vg), do, retain_graph=True)

    lib = library_ms("flash_bwd", sdpa_bwd, n=5)
    plain_ms = device_ms(lambda: plain_bwd(q, k, v, o, lse, do, **kw), n=1, reps=3)
    # the backward's work: five products of 2 * E flops per visible pair
    # (S, dP, dQ in the dQ kernel; the dK/dV kernel needs S and dP again
    # from its inputs, plus dK and dV)
    p3.report("flash_bwd_dq", "dq (2, 32, 4096, 128), causal, GQA 32/8",
              tile_rel_err(dq, ref[0]), BWD_REL_TOL, BWD_REL_WHY,
              device_ms(lambda: flash_bwd_dq(q, k, v, o, lse, do, **kw), n=5), plain_ms,
              bound(nbytes(q, k, v, o, do, lse, dq, delta), 3 * 2 * 128 * pairs, "bf16"), lib,
              True, "tile relative error", max_err(dq, ref[0]))
    p3.report("flash_bwd_dkv", "dk, dv (2, 8, 4096, 128), causal, GQA 32/8",
              max(tile_rel_err(dk, ref[1]), tile_rel_err(dv, ref[2])), BWD_REL_TOL,
              BWD_REL_WHY + " (the larger of dk's and dv's)",
              device_ms(lambda: flash_bwd_dkv(q, k, v, lse, delta, do, **kw), n=5), plain_ms,
              bound(nbytes(q, k, v, do, lse, delta, dk, dv), 4 * 2 * 128 * pairs, "bf16"), lib,
              True, "tile relative error", max(max_err(dk, ref[1]), max_err(dv, ref[2])))
    print(f"phase 3 flash_bwd: the whole backward's bound (five products) "
          f"{5 * 2 * 128 * pairs / PEAK_OPS_PER_S['bf16'] * 1e3:.4f} ms")
    # the gate's reach: the plain backward with a planted fault, as a dQ
    # kernel that drops the last key tile would give, and a dK/dV kernel
    # that skips the last query tile (read on the key tiles before the
    # last, which it leaves all zero)
    last = (torch.arange(L, device=dev) < L - 64).expand(2, L)
    no_tile = plain_bwd(q, k, v, o, lse, do, kpad_mask=last, **kw)[0]
    no_rows = plain_bwd(q[:, :, :-64], k, v, o[:, :, :-64], lse[:, :, :-64], do[:, :, :-64],
                        **kw)
    planted = (tile_rel_err(no_tile, ref[0]),
               tile_rel_err(no_rows[1][:, :, :-64], ref[1][:, :, :-64]),
               tile_rel_err(no_rows[2][:, :, :-64], ref[2][:, :, :-64]))
    print(f"phase 3 flash_bwd: planted faults read (tile relative error, tol {BWD_REL_TOL:g}): "
          f"dq without the last key tile {planted[0]:.3e}; without the last query tile, dk "
          f"{planted[1]:.3e}, dv {planted[2]:.3e}")
    check(min(planted) > BWD_REL_TOL, f"a planted fault passes the gradients' gate: {planted}")
    del q, k, v, do, o, lse, dq, dk, dv, delta, ref, qg, kg, vg, graph, no_tile, no_rows
    torch.cuda.empty_cache()

    # edge cases: ragged L, E = 64, non-causal, kpad hiding keys 0-6 of
    # batch 1 (under causal its rows 0-6 see no key: zero gradients)
    for case, causal, QL, KL, E, kpad in (
        ("causal, L=1000 (ragged), E=128", True, 1000, 1000, 128, False),
        ("causal, L=1000, E=64, kpad: rows 0-6 of batch 1 see no key", True, 1000, 1000, 64,
         True),
        ("non-causal, QL=1000, KL=700, E=128, kpad", False, 1000, 700, 128, True),
    ):
        q, do = randn(2, 32, QL, E), randn(2, 32, QL, E)
        k, v = randn(2, 8, KL, E), randn(2, 8, KL, E)
        mask = None
        if kpad:
            mask = torch.ones((2, KL), dtype=torch.bool, device=dev)
            mask[1, :7] = False
        ekw = dict(causal=causal, scale=E ** -0.5, kpad_mask=mask)
        o, lse = flash_fwd(q, k, v, **ekw)
        got = flash_attention_bwd(q, k, v, o, lse, do, **ekw)
        ref = plain_bwd(q, k, v, o, lse, do, **ekw)
        if kpad and causal:
            check(got[0][1, :, :7].abs().max().item() == 0.0,
                  "flash_bwd: rows that see no key must get zero dq")
        for name, which, g, r in zip(("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv"), "qkv",
                                     got, ref):
            check(bool(torch.isfinite(g).all()), f"{name} [{case}]: non-finite d{which}")
            p3.report(name, f"{case}: d{which}", tile_rel_err(g, r), BWD_REL_TOL, BWD_REL_WHY,
                      measure="tile relative error", abs_err=max_err(g, r))
        del q, k, v, do, o, lse, got, ref
    torch.cuda.empty_cache()


ADAMW_WHY = ("the largest |p - plain| in bf16 ulps of max(|p| before, after): the same f32 "
             "update, divided exactly where the plain path on the card multiplies by a "
             "scalar's reciprocal, rounded to bf16 once on both sides")


def phase_adamw_kernel(p3, gen, randn):
    """AdamW on the leaves of mistral-7b-8l (the training cell's 75
    leaves): step 2 of the kernel against the plain update from the same
    state, leaf by leaf; then one step's time (75 launches) against the
    byte bound (22 bytes a parameter) and the plain update's."""
    from nnop_tpu_torch.models.llama import LlamaConfig, init_params
    from nnop_tpu_torch.ops.adamw import adamw_update_, naive_adamw_update_
    from nnop_tpu_torch.parallel.tp_llama import tree_leaves

    params = tree_leaves(init_params(gen, LlamaConfig.mistral_7b(n_layers=8)))
    grads = [randn(*p.shape, scale=1e-2) for p in params]
    # the moments of a step 1 with gradients of the same scale
    mus = [randn(*p.shape, scale=1e-3, dtype=torch.float32) for p in params]
    nus = [randn(*p.shape, scale=3e-4, dtype=torch.float32).square_() for p in params]
    n = sum(p.numel() for p in params)
    b1c, b2c = (float(np.float32(1.0) - np.float32(b) ** np.float32(2)) for b in (0.9, 0.999))
    kw = dict(lr=1e-4, b1=0.9, b2=0.999, b1c=b1c, b2c=b2c, eps=1e-8, wd=0.0)
    ulps, mom, abs_err = 0.0, 0.0, 0.0
    for p, g, mu, nu in zip(params, grads, mus, nus):
        ref = [t.clone() for t in (p, mu, nu)]
        naive_adamw_update_(ref[0], g, ref[1], ref[2], **kw)
        p_old = p.clone()
        adamw_update_(p, g, mu, nu, **kw)
        mag = torch.maximum(ref[0].abs(), p_old.abs())
        ulp = (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag).float()
        diff = (p.float() - ref[0].float()).abs()
        ulps = max(ulps, (diff / ulp).max().item())
        abs_err = max(abs_err, diff.max().item())
        mom = max(mom, *((a - b).abs().max().item() / b.abs().max().item()
                         for a, b in ((mu, ref[1]), (nu, ref[2]))))
        del ref, p_old, mag, ulp, diff
    check(mom <= 1e-6, f"adamw_update: mu or nu {mom:.3e} of the leaf's largest > 1e-6")

    def kernel_step():
        for p, g, mu, nu in zip(params, grads, mus, nus):
            adamw_update_(p, g, mu, nu, **kw)

    def plain_step():
        for p, g, mu, nu in zip(params, grads, mus, nus):
            naive_adamw_update_(p, g, mu, nu, **kw)

    p3.report("adamw_update", f"mistral-7b-8l: {len(params)} leaves, {n / 1e9:.3f} B parameters, "
              f"bf16 p and g, f32 mu and nu (mu, nu within {mom:.2e} of the leaf's largest)",
              ulps, 1.0, ADAMW_WHY, device_ms(kernel_step, n=5, reps=3),
              device_ms(plain_step, n=2, reps=3), bound(22 * n, 20 * n, "f32"), None, True,
              "bf16 ulps", abs_err=abs_err)
    del params, grads, mus, nus
    torch.cuda.empty_cache()


def phase_paged_kernels(p3, gen, randn):
    """The paged modes of D and E at phase 7's shapes (pools of 256 pages
    of 128 tokens for 32 layers, a shuffled table, lengths 512-640), an
    edge case at page 256, the idle-slot flush, and write_kv_token."""
    from nnop_tpu_torch.ops import naive
    from nnop_tpu_torch.ops.attention_decode_paged import paged_decode_attention
    from nnop_tpu_torch.ops.kv_write import flush_staging_paged, write_kv_token

    dev = torch.device("cuda")

    def pools(NL, n_pages, page, mode):
        shape = (NL, n_pages, 8, page, 128)
        if mode == "bf16":
            return (randn(*shape), randn(*shape)), ()
        return (tuple(torch.randint(-127, 128, shape, generator=gen, device=dev,
                                    dtype=torch.int8) for _ in range(2)),
                tuple(torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 0.01
                      for _ in range(2)))

    def table_for(B, n_pages, max_pages):
        perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
        return perm[: B * max_pages].reshape(B, max_pages).contiguous()

    NL, B, n_pages, page, max_pages, W = 32, 32, 256, 128, 8, 32
    lengths = torch.randint(512, 641, (B,), generator=gen, device=dev, dtype=torch.int32)
    len_list = lengths.tolist()
    table = table_for(B, n_pages, max_pages)
    k_stage, v_stage = randn(B, NL, 8, W, 128), randn(B, NL, 8, W, 128)
    q = randn(B, 32, 1, 128)
    for mode in ("bf16", "int8"):
        sfx = "" if mode == "bf16" else "_int8"
        caches, scales = pools(NL, n_pages, page, mode)
        item = caches[0].element_size()

        # D, paged: the main case, then staged_n 0 and 32
        args = (q, *caches, table, lengths, *scales)
        for n in (9, 0, 32):
            dkw = dict(k_stage=k_stage, v_stage=v_stage, staged_n=n, layer=3)
            err = max_err(paged_decode_attention(*args, **dkw),
                          naive.naive_paged_decode_attention(*args, **dkw))
            if n != 9:
                p3.report(f"paged_decode_attention{sfx}", f"staged_n {n}", err, BF16_TOL,
                          BF16_TOL_WHY)
                continue
            keys = sum(len_list) + B * n
            moved = (sum(len_list) * 8 * 128 * 2 * item + B * n * 8 * 128 * 2 * 2
                     + 2 * nbytes(q) + nbytes(lengths)
                     + sum(-(-x // page) for x in len_list) * 4
                     + (sum(len_list) * 8 * 2 * 4 if mode == "int8" else 0))
            lib = None if sfx else decode_library(
                "paged_decode_attention", q, *caches, k_stage, v_stage, lengths, 3, n, None,
                table=table)
            case = (f"q (32, 32, 1, 128), {mode} pool (32, 256, 8, 128, 128), shuffled table, "
                    "lengths 512..640, staged_n 9, layer 3")
            o = paged_decode_attention(*args, **dkw)
            p3.report(f"paged_decode_attention{sfx}", case, err, BF16_TOL,
                      BF16_TOL_WHY, device_ms(lambda: paged_decode_attention(*args, **dkw)),
                      device_ms(lambda: naive.naive_paged_decode_attention(*args, **dkw)),
                      bound(moved, 4 * 128 * 32 * keys, "bf16"), lib, True)
            p3.report(f"paged_decode_attention{sfx}", f"{case}, per 64-row tile",
                      tile_rel_err(o, naive.naive_paged_decode_attention(*args, **dkw)),
                      ATTN_REL_TOL, ATTN_REL_WHY, measure="tile relative error")

        # D, paged edge case: page 256, ragged lengths, an empty slot
        e_caches, e_scales = pools(2, 16, 256, mode)
        e_len = torch.tensor([0, 45, 300, 513], dtype=torch.int32, device=dev)
        e_table = table_for(4, 16, 4)
        e_q, e_ks, e_vs = randn(4, 32, 1, 128), randn(4, 2, 8, 32, 128), randn(4, 2, 8, 32, 128)
        e_args = (e_q, *e_caches, e_table, e_len, *e_scales)
        dkw = dict(k_stage=e_ks, v_stage=e_vs, staged_n=7, layer=1)
        o = paged_decode_attention(*e_args, **dkw)
        check(o[0].abs().max().item() == 0.0, "paged decode: the empty slot must give zeros")
        p3.report(f"paged_decode_attention{sfx}", "page 256, lengths 0/45/300/513",
                  max_err(o, naive.naive_paged_decode_attention(*e_args, **dkw)), BF16_TOL,
                  BF16_TOL_WHY)
        del e_caches, e_scales

        # E, paged: bit-exact against the plain flush at every slot's length
        name = f"flush_staging_paged{sfx}"
        cache_args = [*caches, *(scales or (None, None))]
        got = [t.clone() if t is not None else None for t in cache_args]
        flush_staging_paged(*got, k_stage, v_stage, lengths, table, page)
        want = [t.clone() if t is not None else None for t in cache_args]
        naive.naive_flush_staging_paged(want[0], want[1], k_stage, v_stage, lengths, table,
                                        want[2], want[3])
        pairs = [(g, w_) for g, w_ in zip(got, want) if g is not None]
        check(all(torch.equal(g, w_) for g, w_ in pairs), f"{name} is not bit-exact")
        err = max(max_err(g, w_) for g, w_ in pairs)

        # the idle slot: base 0, its stale row naming slot 5's first page
        idle_len, idle_table = lengths.clone(), table.clone()
        idle_len[0], idle_table[0] = 0, table[5]
        idle = [t.clone() if t is not None else None for t in cache_args]
        flush_staging_paged(*idle, k_stage, v_stage, idle_len, idle_table, page)
        stale = int(table[5, 0])
        check(all(torch.equal(t[:, stale], c[:, stale]) for t, c in zip(idle, cache_args)
                  if t is not None), f"{name}: the idle slot's flush changed a live page")
        p3.report(name, f"idle slot with a stale row: page {stale} unchanged", 0.0, 0.0,
                  "an unchanged page")
        rows = B * NL * 8 * W
        moved = (nbytes(k_stage, v_stage) + 2 * rows * 128 * item + nbytes(lengths, table)
                 + (2 * rows * 4 if mode == "int8" else 0))
        lib = None if sfx else flush_library(name, want[:2], k_stage, v_stage, lengths, table)
        p3.report(name, f"(32, 32, 8, 32, 128) -> pool (32, 256, 8, 128, 128) {mode}", err,
                  0.0, "a copy or the same IEEE quantization: bit-exact",
                  device_ms(lambda: flush_staging_paged(*got, k_stage, v_stage, lengths, table,
                                                        page)),
                  device_ms(lambda: naive.naive_flush_staging_paged(
                      want[0], want[1], k_stage, v_stage, lengths, table, want[2], want[3]), n=3),
                  bound(moved, 0, "f32"), lib, True)
        del caches, scales, args, got, want, pairs, idle
        torch.cuda.empty_cache()

    # write_kv_token: one row per (slot, KV head) of a (32, 8, 1024, D) cache
    pos = torch.randint(0, 1024, (B,), generator=gen, device=dev, dtype=torch.int32)
    idx = torch.arange(B, device=dev)
    for dtype, D in ((torch.bfloat16, 128), (torch.int8, 128), (torch.float32, 1)):
        cache, new = (randn(*shape, scale=30.0, dtype=torch.float32).clamp(-127, 127).to(dtype)
                      for shape in ((B, 8, 1024, D), (B, 8, 1, D)))
        got, want = cache.clone(), cache.clone()
        write_kv_token(got, new, pos)
        naive.naive_write_kv_token(want, new, pos)
        check(torch.equal(got, want), f"write_kv_token {dtype} is not bit-exact")
        main = dtype == torch.bfloat16
        # the library call: cache[arange(B), :, positions] = new[:, :, 0] (index_put_)
        key, rows = (idx, slice(None), pos.long()), new[:, :, 0]
        lib = library_ms("write_kv_token", lambda: got.__setitem__(key, rows)) if main else None
        p3.report("write_kv_token", f"(32, 8, 1024, {D}) {dtype}", max_err(got, want), 0.0,
                  "a copy: bit-exact", device_ms(lambda: write_kv_token(got, new, pos)),
                  device_ms(lambda: naive.naive_write_kv_token(want, new, pos)),
                  bound(2 * nbytes(new) + nbytes(pos), 0, "f32"), lib, main)
        del cache, got, want
    torch.cuda.empty_cache()


WINDOW = 4096  # Mistral-7B's and Gemma-2-2B's sliding window
# the decode shapes of phase 11: four slots on both sides of the window,
# five staged rows
FAMILY_LENS, FAMILY_STAGED = [300, 4500, 6100, 8000], 5
ATTN_REL_TOL = 1e-2
ATTN_REL_WHY = ("|got - plain| / |plain| per 64-row query tile of each head (a slot's head in "
                "decode), as outputs averaging thousands of keys are small; bf16 o and P round "
                "by <= 2^-9. On an H100 80GB HBM3 at 700 W the kernels read at most 4.2e-3 (D "
                "split-KV: 4.8e-3) and planted faults 0.12 to 1.03")
# the softcap binds where q is scaled up: scores of std ~q_scale reach
# several times the cap
BIG_Q = 40.0


def _decode_mode(head_dim, int8, E, q8, win, cap, verify):
    """The decode entries' single-token modes (the keys of mode_launches):
    Mistral's window at head dim 128, and any call at head dim 256
    (Gemma-2's, with the softcap)."""
    return E == head_dim and q8 == int8 and (win or head_dim == 256) and not verify


def _planted(name, what, err):
    """A planted fault: the kernel's output against the plain version of a
    wrong computation must read above the tolerance."""
    print(f"phase 3 {name} [planted fault: {what}]: tile relative error {err:.3e} (must "
          f"exceed {ATTN_REL_TOL:g})")
    check(err > ATTN_REL_TOL, f"{name}: the planted fault ({what}) reads {err}")


def _heads_in_groups(fn, q, k, v, groups, **kw):
    """fn(q, k, v, **kw) over `groups` slices of the query heads and their
    KV heads, concatenated: the plain attention on the same inputs with
    its f32 score tensor cut to 1/groups."""
    qs, ks, vs = (t.chunk(groups, dim=1) for t in (q, k, v))
    return torch.cat([fn(a, b, c, **kw) for a, b, c in zip(qs, ks, vs)], dim=1)


def phase_family_kernels(p3, gen, randn):
    """Phase 3 at Mistral-7B's and Gemma-2-2B's serving shapes: C with the
    sliding window (chunked prefill past it), the softcap and head dim
    256, and causal at L 8192; D with the window, the softcap and head dim
    256 in its four modes; E at head dim 256; A and B at Gemma-2's widths;
    and planted window faults for C and D."""
    import torch.nn.functional as F

    from nnop_tpu_torch.ops import naive
    from nnop_tpu_torch.ops.attention_decode import decode_attention
    from nnop_tpu_torch.ops.attention_decode_paged import paged_decode_attention
    from nnop_tpu_torch.ops.flash_attention import flash_fwd
    from nnop_tpu_torch.ops.kv_write import flush_staging
    from nnop_tpu_torch.ops.rms_norm import rms_norm
    from nnop_tpu_torch.ops.rope import RotaryEmbedding, llama_rope

    dev = torch.device("cuda")
    bf = torch.bfloat16

    # A and B at Gemma-2's widths: rows of 2304 with offset 1; head dim 256
    w = (0.1 * torch.randn(2304, generator=gen, device=dev)).to(bf)
    for rows in (4, 512):
        x = randn(rows, 2304)
        err = max_err(rms_norm(x, w, 1e-6, offset=1.0),
                      naive.naive_rms_norm(x, w, eps=1e-6, offset=1.0))
        p3.report("rms_norm", f"Gemma-2 ({rows}, 2304) bf16, offset 1", err, BF16_TOL,
                  BF16_TOL_WHY, device_ms(lambda: rms_norm(x, w, 1e-6, offset=1.0)),
                  device_ms(lambda: naive.naive_rms_norm(x, w, eps=1e-6, offset=1.0)),
                  bound(2 * nbytes(x) + nbytes(w), 4 * x.numel(), "f32"))
    rope = RotaryEmbedding(256, 10000.0)
    for B, L, pos in ((4, 1, [[n] for n in FAMILY_LENS]), (1, 512, [list(range(5632, 6144))])):
        q, k = randn(B, 8, L, 256, scale=0.5), randn(B, 4, L, 256, scale=0.5)
        cos, sin = rope(torch.tensor(pos, device=dev))
        got, want = llama_rope(q, k, cos, sin), naive.naive_rope(q, k, cos, sin)
        p3.report("llama_rope", f"Gemma-2 q ({B}, 8, {L}, 256) bf16",
                  max(max_err(got[0], want[0]), max_err(got[1], want[1])), BF16_TOL,
                  BF16_TOL_WHY, device_ms(lambda: llama_rope(q, k, cos, sin)),
                  device_ms(lambda: naive.naive_rope(q, k, cos, sin)),
                  bound(2 * nbytes(q, k) + nbytes(cos, sin), 3 * (q.numel() + k.numel()), "f32"))

    # C: causal from a row offset over a key buffer with kpad, as the
    # engine's chunked prefill calls it; the bound counts the (row, key)
    # pairs the mask keeps and the K/V rows some row sees. Each fault is
    # (what, the plain version's wrong arguments).
    def flash_case(name, case, QH, KH, QL, KL, E, offset, n_valid, window, softcap, main=False,
                   groups=1, lib=True, q_scale=1.0, faults=()):
        q, k, v = randn(1, QH, QL, E, scale=q_scale), randn(1, KH, KL, E), randn(1, KH, KL, E)
        kw = dict(causal=True, scale=E ** -0.5, causal_offset=offset, window=window,
                  softcap=softcap)
        if n_valid < KL:
            kw["kpad_mask"] = (torch.arange(KL, device=dev) < n_valid)[None]
        o, lse = flash_fwd(q, k, v, **kw)

        def plain(**over):
            return _heads_in_groups(naive.naive_attention, q, k, v, groups, **dict(kw, **over))

        want = plain()
        rows = offset + torch.arange(QL, device=dev)[:, None]
        cols = torch.arange(KL, device=dev)[None]
        mask = (cols <= rows) & (cols < n_valid)
        if window is not None:
            mask &= rows - cols < window
        moved = 2 * nbytes(q) + nbytes(lse) + 2 * KH * int(mask.any(0).sum()) * E * 2
        library = None
        if lib and softcap is None:  # plain causal as is_causal, any other mask as a tensor
            causal_only = QL == KL and offset == 0 and n_valid == KL and window is None
            sdpa_kw = dict(is_causal=True) if causal_only else dict(attn_mask=mask)
            library = library_ms(name, lambda: F.scaled_dot_product_attention(
                q, k, v, scale=E ** -0.5, enable_gqa=True, **sdpa_kw))
        elif lib:  # the softcap: compiled flex_attention, the mask as its block mask
            library, flex_o = flex_verify_ms(name, q, k, v, mask[None, None], softcap)
            if flex_o is not None:
                print(f"phase 3 {name} [{case}]: flex_attention {library:.4f} ms, its o against "
                      f"the plain version: tile relative error {tile_rel_err(flex_o, want):.3e}")
        p3.report(name, case, tile_rel_err(o, want), ATTN_REL_TOL, ATTN_REL_WHY + " (o bf16)",
                  device_ms(lambda: flash_fwd(q, k, v, **kw)), device_ms(plain, n=2, reps=3),
                  bound(moved, 4 * E * QH * int(mask.sum()), "bf16"), library, main,
                  measure="tile relative error", abs_err=max_err(o, want))
        del want
        for what, over in faults:
            _planted(name, what, tile_rel_err(o, plain(**over)))

    no_cap = ("the plain version without the softcap", dict(softcap=None))

    def wide(w):  # a window one key tile too wide
        return (f"window {w} against plain {w + 32}", dict(window=w + 32))

    # Mistral's chunked prefill past the window: chunk 11 of a 6200-token
    # prompt (rows 5632..6143) over the engine's 6656-key buffer
    chunk = dict(QH=32, KH=8, QL=512, KL=6656, E=128, offset=5632, n_valid=6144)
    m_chunk = "Mistral chunk: q (1, 32, 512, 128) at offset 5632, kv (1, 8, 6656, 128), kpad < 6144"
    flash_case("flash_fwd_window", f"{m_chunk}, window 4096", **chunk, window=WINDOW, softcap=None,
               main=True, faults=[wide(WINDOW)])
    flash_case("flash_fwd_window", "the same chunk without the window (every key tile up to "
               "the diagonal)", **chunk, window=None, softcap=None)
    flash_case("flash_fwd_window", "the same chunk, window 4096, softcap 5 (binding: q x 4)",
               **chunk, window=WINDOW, softcap=5.0, q_scale=4.0, faults=[no_cap])
    # causal self-attention at L 8192, the first entry past L 4096 (no
    # serving caller: a prefill past 4096 tokens runs in chunks)
    flash_case("flash_fwd", "causal, q = kv (1, 32 | 8, 8192, 128) (row 6's long L)", 32, 8,
               8192, 8192, 128, 0, 8192, None, None, groups=4)
    # Gemma-2's geometry: its windowed layers (window and softcap) and its
    # global ones (softcap only), at the same chunk of a 6200-token prompt;
    # q scaled so that the softcap binds
    g2 = dict(QH=8, KH=4, QL=512, KL=6656, E=256, offset=5632, n_valid=6144)
    g_chunk = "Gemma-2 chunk: q (1, 8, 512, 256) at offset 5632, kv (1, 4, 6656, 256)"
    # 8 heads x 512 rows are 32 blocks of 128 rows, at most half the card:
    # C runs them as 64 blocks of 64 rows
    flash_case("flash_fwd_e256_softcap", f"{g_chunk}, softcap 50 (binding: q x {BIG_Q:g}), window "
               "4096", **g2, window=WINDOW, softcap=50.0, q_scale=BIG_Q, main=True,
               faults=[no_cap, wide(WINDOW)])
    flash_case("flash_fwd_e256_softcap", f"the same, softcap 50 (binding), no window (a global "
               "layer)", **g2, window=None, softcap=50.0, q_scale=BIG_Q, faults=[no_cap])
    flash_case("flash_fwd_e256_softcap", "the same, softcap 5 (binding: q x 4), no window", **g2,
               window=None, softcap=5.0, q_scale=4.0, faults=[no_cap])
    flash_case("flash_fwd_e256_softcap", "the same, window 4096 without the softcap", **g2,
               window=WINDOW, softcap=None, faults=[wide(WINDOW)])
    flash_case("flash_fwd_e256_softcap", "Gemma-2B MQA: q (1, 8, 300, 256), kv (1, 1, 300, 256), "
               "causal", 8, 1, 300, 300, 256, 0, 300, None, None, lib=False)
    for win in (17, 33):  # planted faults, and the tiny windows themselves
        flash_case("flash_fwd_window", f"window {win}: q (1, 32, 300, 128) at offset 100, kv "
                   "(1, 8, 400, 128)", 32, 8, 300, 400, 128, 100, 400, win, None, lib=False,
                   faults=[(f"window {win} against plain {win + 1}", dict(window=win + 1))])
    torch.cuda.empty_cache()

    # D: Mistral's decode (E 128) with the window, Gemma-2's (E 256, KH 4)
    # with the softcap and the window; lengths on both sides of the window
    def decode_case(name, case, E, QH, KH, paged, quantized, window, softcap, main=False,
                    lens=FAMILY_LENS, n_st=FAMILY_STAGED, q_scale=1.0, faults=()):
        NL, B, page = 2, len(lens), 512
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        if paged:  # the engine's page at max_seq 8192; a shuffled table
            counts = [-(-n // page) for n in lens]
            n_pages = sum(counts) + 4
            perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
            table = torch.zeros((B, max(counts) + 1), dtype=torch.int32, device=dev)
            used = 0
            for b, c in enumerate(counts):
                table[b, :c] = perm[used:used + c]
                used += c
            shape = (NL, n_pages, KH, page, E)
        else:
            shape = (NL, B, KH, -(-(max(lens) + 32) // 32) * 32, E)
        if quantized:
            caches = tuple(torch.randint(-127, 128, shape, generator=gen, device=dev,
                                         dtype=torch.int8) for _ in range(2))
            scales = tuple(torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 0.01
                           for _ in range(2))
        else:
            caches, scales = (randn(*shape), randn(*shape)), ()
        q = randn(B, QH, 1, E, scale=q_scale)
        stage = (randn(B, NL, KH, 32, E), randn(B, NL, KH, 32, E))
        if paged:
            op, ref = paged_decode_attention, naive.naive_paged_decode_attention
            args = (q, *caches, table, lengths, *scales)
        else:
            op, ref = decode_attention, naive.naive_decode_attention
            args = (q, *caches, lengths, *scales)
        dkw = dict(k_stage=stage[0], v_stage=stage[1], staged_n=n_st, layer=NL - 1,
                   window=window, softcap=softcap)
        o = op(*args, **dkw)
        want = ref(*args, **dkw)
        # the live rows of this run: a cache row p < len with p >= len +
        # n_st - window, a staged row w >= n_st - window (none for len 0)
        first = [max(0, n + n_st - window) if window else 0 for n in lens]
        cache_rows = sum(max(0, n - f) for n, f in zip(lens, first))
        staged_rows = sum(min(n_st, window or n_st) for n in lens if n > 0)
        moved = (KH * E * 2 * (cache_rows * caches[0].element_size() + staged_rows * 2)
                 + 2 * nbytes(q) + nbytes(lengths) + (KH * 2 * 4 * cache_rows if quantized else 0)
                 + (4 * sum(-(-(n - f) // page) for n, f in zip(lens, first)) if paged else 0))
        library = None
        if main and not quantized:
            library = decode_library(name, q, *caches, *stage, lengths, NL - 1, n_st, window,
                                     softcap, table=table if paged else None, want=want)
        p3.report(name, case, tile_rel_err(o, want), ATTN_REL_TOL, ATTN_REL_WHY,
                  device_ms(lambda: op(*args, **dkw)),
                  device_ms(lambda: ref(*args, **dkw), n=3, reps=3),
                  bound(moved, 4 * E * QH * (cache_rows + staged_rows), "bf16"),
                  library, main,
                  measure="tile relative error", abs_err=max_err(o, want))
        for what, over in faults:
            _planted(name, what, tile_rel_err(o, ref(*args, **dict(dkw, **over))))

    shape_m = "q (4, 32, 1, 128), lengths 300/4500/6100/8000, staged 5"
    shape_g = "q (4, 8, 1, 256), KH 4, lengths 300/4500/6100/8000, staged 5"
    cap_g = f"softcap 50 (binding: q x {BIG_Q:g})"
    for paged in (False, True):
        for quantized in (False, True):
            sfx = "_int8" if quantized else ""
            kind = (f"{'int8' if quantized else 'bf16'} "
                    f"{'pool (2, ·, ·, 512, E), shuffled table' if paged else 'cache'}")
            pre = "paged_decode_attention" if paged else "decode_attention"
            decode_case(f"{pre}_window{sfx}", f"Mistral: {shape_m}, {kind}, window 4096", 128, 32,
                        8, paged, quantized, WINDOW, None, main=True, faults=[wide(WINDOW)])
            decode_case(f"{pre}_window{sfx}", f"Mistral: {shape_m}, {kind}, window 4096, softcap 5 "
                        "(binding: q x 4)", 128, 32, 8, paged, quantized, WINDOW, 5.0,
                        q_scale=4.0, faults=[no_cap])
            decode_case(f"{pre}_e256{sfx}", f"Gemma-2: {shape_g}, {kind}, {cap_g}, window 4096",
                        256, 8, 4, paged, quantized, WINDOW, 50.0, main=True, q_scale=BIG_Q,
                        faults=[no_cap, wide(WINDOW)])
            decode_case(f"{pre}_e256{sfx}", f"Gemma-2: {shape_g}, {kind}, {cap_g}, no window",
                        256, 8, 4, paged, quantized, None, 50.0, q_scale=BIG_Q, faults=[no_cap])
            torch.cuda.empty_cache()
    decode_case("decode_attention_window", f"Mistral: {shape_m}, bf16 cache, no window (every "
                "live row)", 128, 32, 8, False, False, None, None)
    decode_case("decode_attention_e256", "Gemma-2B MQA: q (4, 8, 1, 256), KH 1, bf16 cache, "
                "window 4096", 256, 8, 1, False, False, WINDOW, None)
    for win in (17, 33):  # planted faults: the windows reach into the staged rows at n_st 20
        for paged in (False, True):
            decode_case("paged_decode_attention_window" if paged else "decode_attention_window",
                        f"window {win}, staged 20, lengths 0/1/65/200", 128, 32, 8, paged, False,
                        win, None, lens=[0, 1, 65, 200], n_st=20,
                        faults=[(f"window {win} against plain {win + 1}", dict(window=win + 1))])

    # E at head dim 256: Gemma-2's 26 layers, 4 slots, 4 KV heads
    NL, B, KH, S, W = 26, 4, 4, 8224, 32
    lengths = torch.tensor(FAMILY_LENS, dtype=torch.int32, device=dev)
    k_stage, v_stage = randn(B, NL, KH, W, 256, scale=3.0), randn(B, NL, KH, W, 256, scale=3.0)
    for quantized in (False, True):
        shape = (NL, B, KH, S, 256)
        if quantized:
            cache_args = [torch.zeros(shape, dtype=torch.int8, device=dev) for _ in range(2)]
            cache_args += [torch.zeros(shape[:4], device=dev) for _ in range(2)]
        else:
            cache_args = [torch.zeros(shape, dtype=bf, device=dev) for _ in range(2)] + [None] * 2
        got = [t.clone() if t is not None else None for t in cache_args]
        flush_staging(*got, k_stage, v_stage, lengths)
        naive.naive_flush_staging(cache_args[0], cache_args[1], k_stage, v_stage, lengths,
                                  cache_args[2], cache_args[3])
        pairs = [(g, w_) for g, w_ in zip(got, cache_args) if g is not None]
        check(all(torch.equal(g, w_) for g, w_ in pairs), "flush_staging at E 256 is not bit-exact")
        rows = B * NL * KH * W
        moved = nbytes(k_stage, v_stage) + 2 * rows * 256 * got[0].element_size() + (
            2 * rows * 4 if quantized else 0)
        lib = None if quantized else flush_library("flush_staging_e256", cache_args[:2], k_stage,
                                                   v_stage, lengths)
        p3.report("flush_staging_e256", f"Gemma-2: (4, 26, 4, 32, 256) -> (26, 4, 4, 8224, 256) "
                  f"{'int8' if quantized else 'bf16'}", max(max_err(g, w_) for g, w_ in pairs),
                  0.0, "a copy or the same IEEE quantization: bit-exact",
                  device_ms(lambda: flush_staging(*got, k_stage, v_stage, lengths)),
                  device_ms(lambda: naive.naive_flush_staging(
                      cache_args[0], cache_args[1], k_stage, v_stage, lengths, cache_args[2],
                      cache_args[3]), n=3),
                  bound(moved, 0, "f32"), lib, not quantized)
        del cache_args, got, pairs
        torch.cuda.empty_cache()


VERIFY_T = 5  # the engine's verify rows at spec_k 4: the last token and 4 drafts


def _verify_visible(lens, n_st, T, window):
    """The live rows of a verify run, counted as the T = 1 rows are: the
    cache rows and staged rows some draft of a slot sees (each read once),
    and the (draft, key) pairs the drafts see. Draft t sits at position
    len + n_st - T + t; a slot of length 0 sees nothing."""
    cache_rows = staged_rows = pairs = 0
    for n in lens:
        if n == 0:
            continue
        for t in range(T):
            own = n_st - T + t  # the draft's staged row
            lo_c = max(0, n + own + 1 - window) if window else 0
            lo_s = max(0, own + 1 - window) if window else 0
            pairs += max(0, n - lo_c) + own + 1 - lo_s
        cache_rows += n - (max(0, n + n_st - T + 1 - window) if window else 0)
        staged_rows += n_st - (max(0, n_st - T + 1 - window) if window else 0)
    return cache_rows, staged_rows, pairs


def _sdpa_verify_inputs(q, k_cache, v_cache, k_stage, v_stage, lengths, layer, n_st, window,
                        table=None):
    """F.scaled_dot_product_attention's inputs for a decode or verify
    step: each slot's live cache rows (with `table`, its pages of a pool in
    order) then its staged rows, joined and padded to the longest slot,
    and the boolean mask of the same visibility (B, 1, T, Lmax) (an idle
    slot's row sees nothing: SDPA gives NaN there, which the yardstick's
    time does not mind)."""
    B, _, T, E = q.shape
    lens = lengths.tolist()
    Lmax = max(lens) + n_st
    KH = k_cache.shape[2]
    kj = torch.zeros((B, KH, Lmax, E), dtype=q.dtype, device=q.device)
    vj = torch.zeros_like(kj)
    mask = torch.zeros((B, 1, T, Lmax), dtype=torch.bool, device=q.device)
    t = torch.arange(T, device=q.device)[:, None]
    for b, n in enumerate(lens):
        if table is None:
            kj[b, :, :n], vj[b, :, :n] = k_cache[layer, b, :, :n], v_cache[layer, b, :, :n]
        else:
            ids = table[b, :-(-n // k_cache.shape[3])].long()
            for dst, pool in ((kj, k_cache), (vj, v_cache)):
                dst[b, :, :n] = pool[layer, ids].transpose(0, 1).reshape(KH, -1, E)[:, :n]
        kj[b, :, n:n + n_st] = k_stage[b, layer, :, :n_st]
        vj[b, :, n:n + n_st] = v_stage[b, layer, :, :n_st]
        if n == 0:
            continue
        pos = torch.arange(n + n_st, device=q.device)[None]  # key positions
        qpos = n + n_st - T + t  # the drafts' positions
        vis = pos <= qpos
        if window:
            vis &= pos > qpos - window
        mask[b, 0, :, :n + n_st] = vis
    return kj, vj, mask


def flex_verify_ms(name, q, k, v, mask, softcap):
    """The forward of torch's flex_attention (compiled; a yardstick the
    port never calls) over a verify step's joined K/V: the score softcap
    as its score_mod and `mask` (B, 1, T, L) as its block mask, so one
    PyTorch call computes what D's verify mode computes with the softcap.
    Returns (ms or None, flex's o)."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def score_mod(s, b, h, qi, ki):
        return softcap * torch.tanh(s / softcap)

    def mask_mod(b, h, qi, ki):
        return mask[b, 0, qi, ki]

    B, _, T, E = q.shape
    graph, out = [], []

    def flex_fwd():
        if not graph:  # inside library_ms, which reports a refusal of this torch
            block_mask = create_block_mask(mask_mod, B, None, T, k.shape[2], device=q.device)
            fn = torch.compile(flex_attention, dynamic=False)
            graph.append(lambda: fn(q, k, v, score_mod=score_mod, block_mask=block_mask,
                                    scale=E ** -0.5, enable_gqa=True))
        out[:] = [graph[0]()]
        return out[0]

    ms = library_ms(f"{name} (flex_attention)", flex_fwd)
    return ms, (out[0] if out else None)


def decode_library(name, q, k_cache, v_cache, k_stage, v_stage, lengths, layer, n_st, window,
                   softcap=None, table=None, want=None):
    """A D row's library yardstick: SDPA over the joined live K/V with the
    same boolean mask, or with the softcap compiled flex_attention (its o's
    tile error against `want`, the plain version, printed)."""
    import torch.nn.functional as F

    kj, vj, mask = _sdpa_verify_inputs(q, k_cache, v_cache, k_stage, v_stage, lengths, layer,
                                       n_st, window, table)
    if softcap is None:
        return library_ms(name, lambda: F.scaled_dot_product_attention(
            q, kj, vj, attn_mask=mask, scale=q.shape[-1] ** -0.5, enable_gqa=True))
    ms, flex_o = flex_verify_ms(name, q, kj, vj, mask, softcap)
    if flex_o is not None and want is not None:
        print(f"phase 3 {name}: flex_attention {ms:.4f} ms, its o against the plain version: "
              f"tile relative error {tile_rel_err(flex_o, want):.3e}")
    return ms


def flush_library(name, caches, k_stage, v_stage, lengths, table=None):
    """E's library yardstick: the staged rows put into the K and V caches
    (or pools, through `table`) by index_put_ (advanced-index assignment),
    one call each."""
    B, NL, KH, W, E = k_stage.shape
    dev = k_stage.device
    bi = torch.arange(B, device=dev).repeat_interleave(W)
    wi = torch.arange(W, device=dev).repeat(B)
    g = lengths.long()[bi] + wi
    if table is None:
        key = (slice(None), bi, slice(None), g)
    else:
        page = caches[0].shape[3]
        key = (slice(None), table.long()[bi, g // page], slice(None), g % page)
    vals = [st[bi, :, :, wi].to(caches[0].dtype) for st in (k_stage, v_stage)]
    return library_ms(name, lambda: [c.__setitem__(key, x) for c, x in zip(caches, vals)])


def split_fault(name, o, q, caches, lengths, dkw):
    """Kernel D's split-KV combine at a phase 3 shape: a rerun gives the
    same bits; the plain split-then-merge over the plan's ranges
    (naive_decode_partials, lse_merge in split order) is o within the
    limit, and the same merge with the split that holds the longest slot's
    middle rows dropped (a planted fault) must read above it."""
    from nnop_tpu_torch.ops import naive
    from nnop_tpu_torch.ops.attention_decode import (SPLIT_TILE, block_rows, decode_attention,
                                                     split_count, split_tiles)
    from nnop_tpu_torch.ops.flash_attention import lse_merge

    check(torch.equal(o, decode_attention(q, *caches, lengths, **dkw)),
          f"{name}: a rerun is not bit-identical")
    B, QH, T, E = q.shape
    KH, S = caches[0].shape[2], caches[0].shape[3]
    n_split = split_count(B * KH * block_rows(T, QH // KH, E, False)[1], S,
                          torch.cuda.get_device_properties(0).multi_processor_count)
    lens = lengths.tolist()
    tiles = [[split_tiles(n, 0, n_split, s) for n in lens] for s in range(n_split)]
    ranges = [(torch.tensor([lo * SPLIT_TILE for lo, _ in t]),
               torch.tensor([max(lo, hi) * SPLIT_TILE for lo, hi in t])) for t in tiles]
    parts = naive.naive_decode_partials(q, *caches, lengths, ranges=ranges,
                                        stage_split=n_split - 1, **dkw)
    longest = max(range(B), key=lambda b: lens[b])
    mid = lens[longest] // 2 // SPLIT_TILE
    drop = next(s for s, t in enumerate(tiles) if t[longest][0] <= mid < t[longest][1])

    def merged(skip=None):
        kept = [part for s, part in enumerate(parts) if s != skip]
        out, lse = kept[0]
        for o_s, lse_s in kept[1:]:
            out, lse = lse_merge(out, lse, o_s, lse_s)
        return out

    err = tile_rel_err(o, merged())
    print(f"phase 3 {name} [split-KV: {n_split} splits]: a rerun is bit-identical; the plain "
          f"split-then-merge against o: tile relative error {err:.3e} (tol {ATTN_REL_TOL:g})")
    check(err <= ATTN_REL_TOL, f"{name}: the plain split-then-merge reads {err}")
    _planted(name, f"split {drop} of {n_split} dropped (slot {longest}'s middle rows)",
             tile_rel_err(o, merged(drop)))


def phase_small_head_dims(p3, gen, randn):
    """Kernel D at head dims the kernel pads inside: TinyLlama-
    1.1B's E 64 (32 heads over 4 KV heads) at phase 3's 8B lengths, bf16,
    int8 and verify (T 5), and paged at the paged deployment's shapes; and
    the CLI default's E 32 in f32 at `tiny`'s widths. Each per 64-row tile
    against the plain version; SDPA over the joined K/V as the yardstick
    where the cache is floating-point."""
    from nnop_tpu_torch.ops import naive
    from nnop_tpu_torch.ops.attention_decode import decode_attention
    from nnop_tpu_torch.ops.attention_decode_paged import paged_decode_attention

    dev = torch.device("cuda")

    def caches_of(shape, quantized, dtype=torch.bfloat16):
        if not quantized:
            return (randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)), ()
        return (tuple(torch.randint(-127, 128, shape, generator=gen, device=dev,
                                    dtype=torch.int8) for _ in range(2)),
                tuple(torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 0.01
                      for _ in range(2)))

    def row(name, case, q, caches, scales, stage, lengths, n_st, layer, table=None, main=False,
            lib=True):
        paged = table is not None
        op = paged_decode_attention if paged else decode_attention
        ref = naive.naive_paged_decode_attention if paged else naive.naive_decode_attention
        args = (q, *caches, table, lengths, *scales) if paged else (q, *caches, lengths, *scales)
        dkw = dict(k_stage=stage[0], v_stage=stage[1], staged_n=n_st, layer=layer)
        o, want = op(*args, **dkw), ref(*args, **dkw)
        B, QH, T, E = q.shape
        KH, lens = caches[0].shape[2], lengths.tolist()
        cache_rows, staged_rows, pairs = _verify_visible(lens, n_st, T, None)
        moved = (KH * E * 2 * (cache_rows * caches[0].element_size() + staged_rows * 2)
                 + 2 * nbytes(q) + nbytes(lengths) + (KH * 2 * 4 * cache_rows if scales else 0)
                 + (4 * sum(-(-n // caches[0].shape[3]) for n in lens) if paged else 0))
        library = None
        if lib and not scales:
            library = decode_library(name, q, *caches, *stage, lengths, layer, n_st, None,
                                     table=table)
        p3.report(name, case, tile_rel_err(o, want), ATTN_REL_TOL, ATTN_REL_WHY,
                  device_ms(lambda: op(*args, **dkw)),
                  device_ms(lambda: ref(*args, **dkw), n=3, reps=3),
                  bound(moved, 4 * E * QH * pairs, "bf16"), library, main,
                  measure="tile relative error", abs_err=max_err(o, want))

    # TinyLlama-1.1B's decode: 22 layers, E 64, KH 4, lengths 0..2100
    NL, B, KH, S, E = 22, 8, 4, 2144, 64
    lengths = torch.tensor([0, 1, 63, 64, 65, 300, 1100, 2100], dtype=torch.int32, device=dev)
    stage = (randn(B, NL, KH, 32, E), randn(B, NL, KH, 32, E))
    tl = "TinyLlama-1.1B: q (8, 32, {T}, 64), {kind} cache (22, 8, 4, 2144, 64), lengths 0..2100"
    for quantized in (False, True):
        caches, scales = caches_of((NL, B, KH, S, E), quantized)
        kind = "int8" if quantized else "bf16"
        sfx = "_int8" if quantized else ""
        row(f"decode_attention_e64{sfx}", tl.format(T=1, kind=kind) + ", staged_n 5",
            randn(B, 32, 1, E), caches, scales, stage, lengths, 5, 3, main=True)
        row("decode_attention_verify_e64", tl.format(T=5, kind=kind) + ", staged_n 5 (spec_k 4)",
            randn(B, 32, 5, E), caches, scales, stage, lengths, 5, 3, main=not quantized)
        del caches, scales
    # the paged deployment's shapes at E 64: pools of 256 pages of 128
    B = 32
    lengths = torch.randint(512, 641, (B,), generator=gen, device=dev, dtype=torch.int32)
    table = torch.randperm(256, generator=gen, device=dev).to(torch.int32).reshape(B, 8)
    stage = (randn(B, NL, KH, 32, E), randn(B, NL, KH, 32, E))
    for quantized in (False, True):
        caches, scales = caches_of((NL, 256, KH, 128, E), quantized)
        row("paged_decode_attention_e64", f"TinyLlama-1.1B: q (32, 32, 1, 64), "
            f"{'int8' if quantized else 'bf16'} pool (22, 256, 4, 128, 64), shuffled table, "
            "lengths 512..640, staged_n 9", randn(B, 32, 1, E), caches, scales, stage, lengths,
            9, 3, table=table, main=not quantized)
        del caches, scales
    # the CLI's default model: f32 `tiny` (E 32, 4 heads over 2), max_seq 256
    lengths = torch.tensor([0, 7, 100, 250], dtype=torch.int32, device=dev)
    caches, _ = caches_of((2, 4, 2, 256, 32), False, torch.float32)
    row("decode_attention_e32_f32", "tiny: q (4, 4, 1, 32) f32, f32 cache (2, 4, 2, 256, 32), "
        "lengths 0/7/100/250, staged_n 3", randn(4, 4, 1, 32, dtype=torch.float32), caches, (),
        (randn(4, 2, 2, 32, 32), randn(4, 2, 2, 32, 32)), lengths, 3, 1, main=True)
    torch.cuda.empty_cache()


def phase_verify_kernels(p3, gen, randn):
    """Kernel D's speculative-verify mode (T > 1) at the spec path's
    shapes: Llama-3-8B (bf16 and int8 caches, T 5 at spec_k 4), Mistral-7B
    past its window, Gemma-2-2B at head dim 256 with the softcap binding,
    and G 8 at T 9, whose 72 rows split over three z-blocks; each against
    the plain version per 64-row tile, with planted faults (the
    intra-draft mask one staged row too wide, every draft cut at the first
    draft's window edge, the last z-block's rows dropped) that must read
    above the limit; and SDPA over the joined K/V with the same mask as
    the yardstick (with the softcap, compiled flex_attention's forward)."""
    import torch.nn.functional as F

    from nnop_tpu_torch.ops import naive
    from nnop_tpu_torch.ops.attention_decode import decode_attention

    dev = torch.device("cuda")

    def case(name, desc, E, QH, KH, lens, n_st, T, window, softcap, quantized, main=False,
             q_scale=1.0, NL=2, layer=1, S=None, faults=(), lib=True):
        B = len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        S = S or -(-(max(lens) + 32) // 32) * 32
        shape = (NL, B, KH, S, E)
        if quantized:
            caches = tuple(torch.randint(-127, 128, shape, generator=gen, device=dev,
                                         dtype=torch.int8) for _ in range(2))
            scales = tuple(torch.rand(shape[:4], generator=gen, device=dev) * 0.02 + 0.01
                           for _ in range(2))
        else:
            caches, scales = (randn(*shape), randn(*shape)), ()
        stage = (randn(B, NL, KH, 32, E), randn(B, NL, KH, 32, E))
        q = randn(B, QH, T, E, scale=q_scale)
        args = (q, *caches, lengths, *scales)
        kw = dict(k_stage=stage[0], v_stage=stage[1], staged_n=n_st, layer=layer, window=window,
                  softcap=softcap)
        before = decode_attention.verify_launches
        o = decode_attention(*args, **kw)
        check(decode_attention.verify_launches == before + 1, f"{name}: no verify launch counted")
        check(o.shape == q.shape and bool((o[lengths == 0] == 0).all()),
              f"{name}: shape {tuple(o.shape)}, or an idle slot not zero")
        want = naive.naive_decode_attention(*args, **kw)
        cache_rows, staged_rows, pairs = _verify_visible(lens, n_st, T, window)
        moved = (KH * E * 2 * (cache_rows * caches[0].element_size() + staged_rows * 2)
                 + 2 * nbytes(q) + nbytes(lengths) + (KH * 2 * 4 * cache_rows if quantized else 0))
        library = None
        if lib and not quantized:
            kj, vj, mask = _sdpa_verify_inputs(q, *caches, *stage, lengths, layer, n_st, window)
            library = library_ms(name, lambda: F.scaled_dot_product_attention(
                q, kj, vj, attn_mask=mask, scale=E ** -0.5, enable_gqa=True))
            if softcap is not None:  # SDPA has no softcap: information; flex_attention has
                print(f"phase 3 {name} [{desc}]: SDPA without the softcap {library} ms")
                library, flex_o = flex_verify_ms(name, q, kj, vj, mask, softcap)
                if flex_o is not None:
                    print(f"phase 3 {name} [{desc}]: flex_attention {library:.4f} ms, its o "
                          f"against the plain version: tile relative error "
                          f"{tile_rel_err(flex_o, want):.3e}")
            del kj, vj, mask
        p3.report(name, desc, tile_rel_err(o, want), ATTN_REL_TOL, ATTN_REL_WHY,
                  device_ms(lambda: decode_attention(*args, **kw)),
                  device_ms(lambda: naive.naive_decode_attention(*args, **kw), n=3, reps=3),
                  bound(moved, 4 * E * QH * pairs, "bf16"), library, main,
                  measure="tile relative error", abs_err=max_err(o, want))
        for what, wrong in faults:
            _planted(name, what, tile_rel_err(o, wrong(args, kw, want)))

    def one_row_wide(args, kw, want):  # draft t sees staged row own + 1 too
        return naive.naive_decode_attention(*args, **dict(kw, staged_n=kw["staged_n"] + 1))

    def first_edge(args, kw, want):  # every draft cut at draft 0's window edge
        q, T, n_st = args[0], args[0].shape[2], kw["staged_n"]
        return torch.cat([naive.naive_decode_attention(
            q[:, :, t:t + 1], *args[1:], **dict(kw, staged_n=n_st - T + t + 1,
                                                window=kw["window"] + t)) for t in range(T)], 2)

    def last_z_dropped(args, kw, want):  # G 8: a block holds 4 drafts
        out = want.clone()
        out[:, :, (want.shape[2] - 1) // 4 * 4:] = 0
        return out

    llama = [0, 1, 63, 64, 65, 300, 1100, 2100]
    for quantized in (False, True):
        mode = "int8" if quantized else "bf16"
        case("decode_attention_verify" + ("_int8" if quantized else ""),
             f"Llama-3-8B: q (8, 32, {VERIFY_T}, 128), {mode} cache (32, 8, 8, 2144, 128), "
             f"lengths 0..2100, staged_n {VERIFY_T} (spec_k 4)", 128, 32, 8, llama, VERIFY_T,
             VERIFY_T, None, None, quantized, main=True, NL=32, layer=3, S=2144,
             faults=[("the intra-draft mask one staged row too wide", one_row_wide)])
        torch.cuda.empty_cache()
    shape_m = f"q (4, 32, {VERIFY_T}, 128), lengths 300/4500/6100/8000, staged_n {VERIFY_T}"
    case("decode_attention_verify_window", f"Mistral: {shape_m}, bf16 cache, window 4096", 128,
         32, 8, FAMILY_LENS, VERIFY_T, VERIFY_T, WINDOW, None, False, main=True)
    case("decode_attention_verify_window", f"Mistral: {shape_m}, int8 cache, window 4096", 128,
         32, 8, FAMILY_LENS, VERIFY_T, VERIFY_T, WINDOW, None, True)
    case("decode_attention_verify_window", f"window 9 (the drafts' edges 1 key apart), "
         f"q (4, 32, {VERIFY_T}, 128), lengths 0/1/65/200, staged_n 8", 128, 32, 8,
         [0, 1, 65, 200], 8, VERIFY_T, 9, None, False, lib=False,
         faults=[("every draft cut at the first draft's window edge", first_edge),
                 ("the intra-draft mask one staged row too wide", one_row_wide)])
    shape_g = f"q (4, 8, {VERIFY_T}, 256) x {BIG_Q:g}, KH 4, lengths 300/4500/6100/8000"
    for quantized in (False, True):
        case("decode_attention_verify_e256", f"Gemma-2: {shape_g}, "
             f"{'int8' if quantized else 'bf16'} cache, softcap 50 (binding), window 4096", 256,
             8, 4, FAMILY_LENS, VERIFY_T, VERIFY_T, WINDOW, 50.0, quantized, main=not quantized,
             q_scale=BIG_Q)
    case("decode_attention_verify_e256", f"Gemma-2: {shape_g}, bf16 cache, softcap 50, no window",
         256, 8, 4, FAMILY_LENS, VERIFY_T, VERIFY_T, None, 50.0, False, q_scale=BIG_Q)
    case("decode_attention_verify", "G 8 above the row bound: q (4, 32, 9, 128), KH 4, "
         "lengths 0/1/65/2100, staged_n 9 (72 rows: three z-blocks of 4, 4 and 1 drafts)", 128,
         32, 4, [0, 1, 65, 2100], 9, 9, None, None, False,
         faults=[("the last z-block's rows dropped", last_z_dropped)])
    torch.cuda.empty_cache()


def _bwd_in_groups(q, k, v, o, lse, do, groups, **kw):
    """naive_attention_bwd over `groups` slices of the query heads and
    their KV heads (dq joined along the query heads, dk and dv along the
    KV heads): the plain backward with its f32 (heads, L, L)
    intermediates cut to 1/groups."""
    from nnop_tpu_torch.ops import naive

    parts = [naive.naive_attention_bwd(*a, **kw) for a in zip(
        *(t.chunk(groups, dim=1) for t in (q, k, v, o, lse, do)))]
    return tuple(torch.cat(t, dim=1) for t in zip(*parts))


def _bwd_without_cap_factor(q, k, v, o, lse, do, groups, softcap, **kw):
    """A planted fault: the plain backward with P from the capped scores
    but dS without its factor 1 - t^2. The capped scores enter as a pair
    bias, c tanh(s / c) - s, on the uncapped plain backward (kw as for
    naive_attention_bwd, less the softcap)."""
    from nnop_tpu_torch.ops import naive

    parts = []
    for qg, kg, vg, og, lg, dg in zip(*(t.chunk(groups, dim=1) for t in (q, k, v, o, lse, do))):
        s = torch.einsum("bhqe,bhke->bhqk", qg.float(), kg.float().repeat_interleave(
            qg.shape[1] // kg.shape[1], dim=1)) * kw["scale"]
        pair = softcap * torch.tanh(s / softcap) - s
        del s
        parts.append(naive.naive_attention_bwd(qg, kg, vg, og, lg, dg, pair=pair, **kw)[:3])
        del pair
    return tuple(torch.cat(t, dim=1) for t in zip(*parts))


def flex_bwd_ms(name, q, k, v, do, window, softcap, seg=None):
    """The backward of torch's flex_attention (compiled; a yardstick the
    port never calls) on the same q, k, v and do: the score softcap as its
    score_mod, causal plus the window or the documents as its block mask,
    so one PyTorch call computes what dQ and dK/dV compute in softcap mode.
    Its forward runs once, in the warm-up call, as for SDPA's backward.
    Returns (ms or None, flex's dq)."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def score_mod(s, b, h, qi, ki):
        return softcap * torch.tanh(s / softcap)

    def mask_mod(b, h, qi, ki):
        m = qi >= ki
        if window is not None:
            m = m & (qi - ki < window)
        if seg is not None:
            m = m & (seg[0][qi] == seg[0][ki])
        return m

    L, E = q.shape[2], q.shape[3]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    graph, grads = [], []

    def flex_bwd():
        if not graph:  # inside library_ms, which reports a refusal of this torch
            block_mask = create_block_mask(mask_mod, None, None, L, L, device=q.device)
            graph.append(torch.compile(flex_attention, dynamic=False)(
                *leaves, score_mod=score_mod, block_mask=block_mask, scale=E ** -0.5,
                enable_gqa=True))
        out = torch.autograd.grad(graph[0], leaves, do, retain_graph=True)
        grads[:] = out
        return out

    ms = library_ms(f"{name} (flex_attention)", flex_bwd, n=5)
    return ms, (grads[0] if grads else None)


def phase_family_train_kernels(p3, gen, randn):
    """The families' training kernels: A-bwd at Gemma-2's rows (8192, 2304)
    with offset 1, B's backward at head dim 256, then C, dQ and dK/dV at
    their training geometry (B 1, L 8192): Mistral with the window,
    Gemma-2 with the softcap (binding) with and without the window, head
    dim 256 without features (MQA), and segment ids with the softcap; the
    plain backward one group of heads at a time; planted faults (the
    window one key and one 64-key tile too wide, dS without 1 - t^2, dq
    without its upper 128 lanes) and two bit-identical runs."""
    import torch.nn.functional as F

    from nnop_tpu_torch.ops import naive
    from nnop_tpu_torch.ops.flash_attention import flash_fwd
    from nnop_tpu_torch.ops.flash_attention_bwd import flash_bwd_dkv, flash_bwd_dq
    from nnop_tpu_torch.ops.rms_norm import rms_norm_bwd, rms_norm_fwd
    from nnop_tpu_torch.ops.rope import RotaryEmbedding, llama_rope_bwd

    dev = torch.device("cuda")
    bf = torch.bfloat16
    L = 8192

    # A-bwd at Gemma-2's trainer rows (B L = 8192, width 2304, offset 1)
    x, dy = randn(L, 2304), randn(L, 2304)
    w = (0.1 * torch.randn(2304, generator=gen, device=dev)).to(bf)
    _, rstd = rms_norm_fwd(x, w, 1e-6, offset=1.0)
    dx, dw = rms_norm_bwd(x, w, rstd, dy, offset=1.0)
    dx_ref, dw_ref = naive.naive_rms_norm_bwd(x, w, rstd, dy, 1.0)
    p3.report("rms_norm_bwd", "Gemma-2 dw (2304,) f32 over 8192 rows, offset 1",
              ((dw - dw_ref).norm() / dw_ref.norm()).item(), DW_REL_TOL, DW_REL_WHY,
              measure="relative error", abs_err=max_err(dw, dw_ref))
    p3.report("rms_norm_bwd", "Gemma-2 dx (8192, 2304) bf16, offset 1", max_err(dx, dx_ref),
              BF16_TOL, BF16_TOL_WHY, device_ms(lambda: rms_norm_bwd(x, w, rstd, dy, offset=1.0)),
              device_ms(lambda: naive.naive_rms_norm_bwd(x, w, rstd, dy, 1.0)),
              bound(3 * nbytes(x) + nbytes(w, rstd, dw), 8 * x.numel(), "f32"))
    del x, dy, dx, dx_ref
    # B's backward at head dim 256: Gemma-2's q and k gradients at L 8192
    dq, dk = randn(1, 8, L, 256, scale=0.5), randn(1, 4, L, 256, scale=0.5)
    cos, sin = RotaryEmbedding(256, 10000.0)(torch.arange(L, device=dev)[None])
    got, want = llama_rope_bwd(dq, dk, cos, sin), naive.naive_rope(dq, dk, cos, sin, -1.0)
    p3.report("llama_rope_bwd", "Gemma-2 dq (1, 8, 8192, 256), dk (1, 4, 8192, 256) bf16",
              max(max_err(got[0], want[0]), max_err(got[1], want[1])), BF16_TOL, BF16_TOL_WHY,
              device_ms(lambda: llama_rope_bwd(dq, dk, cos, sin)),
              device_ms(lambda: naive.naive_rope(dq, dk, cos, sin, -1.0)),
              bound(2 * nbytes(dq, dk) + nbytes(cos, sin), 3 * (dq.numel() + dk.numel()), "f32"))
    del dq, dk, got, want, cos, sin

    rows = torch.arange(L, device=dev)[:, None]
    cols = torch.arange(L, device=dev)[None]

    def bwd_case(name, case, QH, KH, E, window, softcap, q_scale=1.0, seg=None, main=False,
                 groups=4, faults=(), identical=False, cut_lanes=False):
        """C, then dQ and dK/dV, against the plain forward and backward
        (`groups` head groups at a time, a divisor of KH) per 64-row tile;
        timed, with the bound over the visible (row, key) pairs and SDPA's
        backward (a boolean mask) where there is no softcap, else
        flex_attention's backward (flex_bwd_ms). Each fault is
        (what, the plain backward's wrong arguments or a function giving
        its gradients)."""
        q, do = randn(1, QH, L, E, scale=q_scale), randn(1, QH, L, E)
        k, v = randn(1, KH, L, E), randn(1, KH, L, E)
        kw = dict(causal=True, scale=E ** -0.5, window=window, softcap=softcap,
                  segment_ids=None if seg is None else (seg, seg))
        o, lse = flash_fwd(q, k, v, **kw)
        o_ref = _heads_in_groups(naive.naive_attention, q, k, v, groups, **kw)
        err = tile_rel_err(o, o_ref)
        check(err <= ATTN_REL_TOL, f"{name} [{case}]: C's o tile relative error {err}")
        del o_ref
        dq, delta = flash_bwd_dq(q, k, v, o, lse, do, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, **kw)
        ref = _bwd_in_groups(q, k, v, o, lse, do, groups, **kw)
        if identical:
            again = flash_bwd_dq(q, k, v, o, lse, do, **kw)[0], *flash_bwd_dkv(
                q, k, v, lse, delta, do, **kw)
            check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
                  f"{name} [{case}]: two runs on the same inputs differ")
            print(f"phase 3 {name} [{case}]: two runs of dQ and dK/dV are bit-identical")
            del again
        mask = cols <= rows
        if window is not None:
            mask &= rows - cols < window
        if seg is not None:
            mask &= seg[0][:, None] == seg[0][None, :]
        pairs = QH * int(mask.sum())
        lib = None
        if softcap is None:
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            sdpa_kw = dict(is_causal=True) if window is None and seg is None else dict(
                attn_mask=mask)
            graph = []  # SDPA's forward, run once by the warm-up call

            def sdpa_bwd():
                if not graph:
                    graph.append(F.scaled_dot_product_attention(
                        *leaves, scale=E ** -0.5, enable_gqa=True, **sdpa_kw))
                return torch.autograd.grad(graph[0], leaves, do, retain_graph=True)

            lib = library_ms(name, sdpa_bwd, n=5)
            del leaves, graph
        else:
            lib, flex_dq = flex_bwd_ms(name, q, k, v, do, window, softcap, seg)
            if flex_dq is not None:  # the yardstick computes the same function
                print(f"phase 3 {name} [{case}]: flex_attention's dq against the plain "
                      f"version: tile relative error {tile_rel_err(flex_dq, ref[0]):.3e}")
            del flex_dq
        plain_ms = device_ms(lambda: _bwd_in_groups(q, k, v, o, lse, do, groups, **kw), n=1,
                             reps=3)
        p3.report(name, f"{case}: dq", tile_rel_err(dq, ref[0]), BWD_REL_TOL, BWD_REL_WHY,
                  device_ms(lambda: flash_bwd_dq(q, k, v, o, lse, do, **kw), n=5), plain_ms,
                  bound(nbytes(q, k, v, o, do, lse, dq, delta), 3 * 2 * E * pairs, "bf16"), lib,
                  main, "tile relative error", max_err(dq, ref[0]))
        p3.report(name.replace("_dq", "_dkv"), f"{case}: dk, dv",
                  max(tile_rel_err(dk, ref[1]), tile_rel_err(dv, ref[2])), BWD_REL_TOL,
                  BWD_REL_WHY + " (the larger of dk's and dv's)",
                  device_ms(lambda: flash_bwd_dkv(q, k, v, lse, delta, do, **kw), n=5), plain_ms,
                  bound(nbytes(q, k, v, do, lse, delta, dk, dv), 4 * 2 * E * pairs, "bf16"), lib,
                  main, "tile relative error", max(max_err(dk, ref[1]), max_err(dv, ref[2])))
        for what, wrong in faults:
            bad = (wrong(q, k, v, o, lse, do, groups, **kw) if callable(wrong) else
                   _bwd_in_groups(q, k, v, o, lse, do, groups, **dict(kw, **wrong)))
            _planted(name, what, max(tile_rel_err(g, b) for g, b in zip((dq, dk, dv), bad)))
            del bad
        if cut_lanes:
            half = dq.clone()
            half[..., 128:] = 0
            _planted(name, "dq with its upper 128 lanes zeroed", tile_rel_err(half, ref[0]))
            del half
        del q, k, v, do, o, lse, dq, dk, dv, delta, ref, mask
        torch.cuda.empty_cache()

    def wider(w, by):
        return (f"window {w} against plain {w + by}", dict(window=w + by))

    no_factor = ("dS without the factor 1 - t^2", _bwd_without_cap_factor)

    mistral, gemma2 = "Mistral: q (1, 32, 8192, 128), kv (1, 8, 8192, 128), causal", (
        "Gemma-2: q (1, 8, 8192, 256), kv (1, 4, 8192, 256), causal")
    cap = f"softcap 50 (binding: q x {BIG_Q:g})"
    bwd_case("flash_bwd_dq_window", f"{mistral}, window 4096", 32, 8, 128, WINDOW, None,
             main=True, groups=8, faults=[wider(WINDOW, 64)], identical=True)
    bwd_case("flash_bwd_dq_e256_softcap", f"{gemma2}, {cap}, window 4096 (its even layers)", 8,
             4, 256, WINDOW, 50.0, q_scale=BIG_Q, main=True,
             faults=[no_factor, wider(WINDOW, 64)], identical=True, cut_lanes=True)
    bwd_case("flash_bwd_dq_e256_softcap", f"{gemma2}, {cap}, no window (its odd layers)", 8, 4,
             256, None, 50.0, q_scale=BIG_Q, faults=[no_factor])
    bwd_case("flash_bwd_dq", "Gemma-2B MQA: q (1, 8, 8192, 256), kv (1, 1, 8192, 256), causal",
             8, 1, 256, None, None, groups=1, cut_lanes=True)
    seg = torch.arange(4, device=dev, dtype=torch.int32).repeat_interleave(L // 4)[None]
    moved = seg.clone()
    moved[:, L // 4] = 0  # the first boundary one key later (keys only)
    bwd_case("flash_bwd_dq_segments", f"{gemma2}, {cap}, 4 documents of 2048", 8, 4, 256, None,
             50.0, q_scale=BIG_Q, seg=seg, identical=True,
             faults=[("a document boundary one key later", lambda *a, **kw: _bwd_in_groups(
                 *a, **dict(kw, segment_ids=(seg, moved))))])
    del seg, moved
    # the window one key too wide, where one key is a visible share of a
    # row's keys (at window 4096 it is 1/4096 of them)
    L_small = 1024
    for win in (17, 33):
        q, do = randn(1, 32, L_small, 128), randn(1, 32, L_small, 128)
        k, v = randn(1, 8, L_small, 128), randn(1, 8, L_small, 128)
        kw = dict(causal=True, scale=128 ** -0.5, window=win)
        o, lse = flash_fwd(q, k, v, **kw)
        dq, delta = flash_bwd_dq(q, k, v, o, lse, do, **kw)
        got = (dq, *flash_bwd_dkv(q, k, v, lse, delta, do, **kw))
        ref = naive.naive_attention_bwd(q, k, v, o, lse, do, **kw)
        case = f"window {win}: q (1, 32, 1024, 128), kv (1, 8, 1024, 128)"
        p3.report("flash_bwd_dq_window", f"{case}: dq", tile_rel_err(got[0], ref[0]),
                  BWD_REL_TOL, BWD_REL_WHY, measure="tile relative error")
        p3.report("flash_bwd_dkv_window", f"{case}: dk, dv", max(
            tile_rel_err(got[1], ref[1]), tile_rel_err(got[2], ref[2])), BWD_REL_TOL,
            BWD_REL_WHY, measure="tile relative error")
        bad = naive.naive_attention_bwd(q, k, v, o, lse, do, **dict(kw, window=win + 1))
        _planted("flash_bwd_dq_window", f"window {win} against plain {win + 1}",
                 max(tile_rel_err(g, b) for g, b in zip(got, bad)))
    torch.cuda.empty_cache()


ROW_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
ROW_REL_WHY = ("|got - plain| / |plain| per row (a softmax row of 4096 values near 2.4e-4 passes "
               "any absolute 2e-2): f32 sums in another order (~1e-7), or one bf16 rounding of "
               "the output (<= 2^-9)")
SUM_REL_TOL = 1e-4
SUM_REL_WHY = "|got - plain| / |plain|: f32 sums over 16384 rows taken in another order"
OPSET_ATTN_WHY = ("|got - plain| / |plain| per 64-row query or key tile of each head (dpair per "
                  "64 x 64 tile): bf16 outputs, and P and dS rounded to bf16 where the f32 sums "
                  "before them differ in order (<= 2^-9 each)")


def row_rel_err(got, ref):
    """The largest |got - ref| / |ref| (norms over the last axis) over the
    rows: each row against its own scale."""
    got, ref = got.float().reshape(-1, got.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
    return ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()


def tile2d_rel_err(got, ref, tile=64):
    """tile_rel_err over the tile x tile blocks of (B, H, QL, KL) tensors
    (dpair): a block whose reference is zero (masked, or past the causal
    diagonal) must be zero."""
    def tiles(t):
        t = torch.nn.functional.pad(t.float(), (0, -t.shape[3] % tile, 0, -t.shape[2] % tile))
        B, H, R, C = t.shape
        return t.reshape(B, H, R // tile, tile, C // tile, tile).transpose(3, 4).reshape(
            B, H, R // tile, C // tile, tile * tile)

    dn, rn = tiles(got - ref.to(got.dtype)).norm(dim=-1), tiles(ref).norm(dim=-1)
    zero = rn == 0
    if bool((dn[zero] > 0).any()):
        return float("inf")
    return (dn[~zero] / rn[~zero]).max().item()


def _by_batch(fn, *ts, **kw):
    """fn one batch element at a time (the plain attention's fp32 (QH, QL,
    KL) intermediates are 2.1 GB each at L 4096), outputs concatenated;
    tensors of kw with a batch axis are sliced too."""
    outs = []
    for b in range(ts[0].shape[0]):
        sl = {k: (tuple(t[b:b + 1] for t in v) if isinstance(v, tuple) else
                  v[b:b + 1] if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
        outs.append(fn(*(t[b:b + 1] for t in ts), **sl))
    return tuple(torch.cat(t) for t in zip(*outs))


def phase_opset_kernels(p3, gen, randn):
    """The op set's kernels: softmax and layer norm forward and backward at
    bench.py's (16384, 4096) in f32 and bf16 and softmax at Llama-3-8B's
    vocab (4096, 128256, column chunks); C, dQ (dpair) and dK/dV with the
    pair bias (N(0, 1)) at bench.py's reference grid and at the 8B
    training geometry, and with segment ids at attn8b_seg; head dims 32 and
    96 (padded); planted faults for each."""
    import torch.nn.functional as F

    from nnop_tpu_torch.ops import naive
    from nnop_tpu_torch.ops.flash_attention import flash_attention, flash_fwd
    from nnop_tpu_torch.ops.flash_attention_bwd import flash_bwd_dkv, flash_bwd_dq
    from nnop_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
    from nnop_tpu_torch.ops.softmax import softmax_bwd, softmax_fwd

    dev = torch.device("cuda")
    f32, bf = torch.float32, torch.bfloat16

    # softmax: bytes read and written once each (the bound), ~5 flops an element
    for shape, dt, main in (((16384, 4096), f32, True), ((16384, 4096), bf, False),
                            ((4096, 128256), f32, False)):
        case = f"{shape} {str(dt)[6:]}" + (" (column chunks)" if shape[1] > 16384 else "")
        x, dy = randn(*shape, dtype=dt), randn(*shape, dtype=dt)
        y = softmax_fwd(x)
        ref = naive.naive_softmax(x)
        lib = (library_ms("online_softmax", lambda: torch.softmax(x, dim=-1)) if main else None)
        p3.report("online_softmax", case, row_rel_err(y, ref), ROW_REL_TOL[dt], ROW_REL_WHY,
                  device_ms(lambda: softmax_fwd(x)), device_ms(lambda: naive.naive_softmax(x)),
                  bound(2 * nbytes(x), 5 * x.numel(), "f32"), lib, main,
                  measure="row relative error", abs_err=max_err(y, ref))
        chunk = 8192 if shape[1] > 16384 else shape[1] // 8  # a column chunk left out
        xf = x.float()
        e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
        fault = (e / e[:, :-chunk].sum(dim=-1, keepdim=True)).to(dt)
        _row_fault("online_softmax", f"{case}: the denominator without its last {chunk} "
                   "columns", row_rel_err(y, fault), ROW_REL_TOL[dt])
        del xf, e, fault, ref
        dx = softmax_bwd(y, dy)
        ref = naive.naive_softmax_bwd(y, dy)
        lib = None
        if main:
            xg = x.clone().requires_grad_(True)
            y_lib = torch.softmax(xg, dim=-1)
            lib = library_ms("online_softmax_bwd", lambda: torch.autograd.grad(
                y_lib, xg, dy, retain_graph=True))
            del xg, y_lib
        p3.report("online_softmax_bwd", case, row_rel_err(dx, ref), ROW_REL_TOL[dt],
                  ROW_REL_WHY, device_ms(lambda: softmax_bwd(y, dy)),
                  device_ms(lambda: naive.naive_softmax_bwd(y, dy)),
                  bound(3 * nbytes(x), 4 * x.numel(), "f32"), lib, main,
                  measure="row relative error", abs_err=max_err(dx, ref))
        del x, dy, y, dx, ref
        torch.cuda.empty_cache()

    # layer norm: inputs with a row mean away from 0, so that a kernel
    # without the mean fails
    E = 4096
    for dt, main in ((f32, True), (bf, False)):
        case = f"(16384, {E}) {str(dt)[6:]}"
        x = (2 * torch.randn(16384, E, generator=gen, device=dev) + 0.5).to(dt)
        w = (1 + 0.1 * torch.randn(E, generator=gen, device=dev)).to(dt)
        b = (0.1 * torch.randn(E, generator=gen, device=dev)).to(dt)
        dy = randn(16384, E, dtype=dt)
        y, mu, sigma = layer_norm_fwd(x, w, b, 1e-5)
        ref, mu_ref, sigma_ref = naive.naive_layer_norm_fwd(x, w, b, eps=1e-5)
        stats = max(((mu - mu_ref).abs() / mu_ref.abs().clamp(min=1e-3)).max().item(),
                    ((sigma - sigma_ref).abs() / sigma_ref).max().item())
        check(stats <= 1e-5, f"layer_norm: mu/sigma relative error {stats} > 1e-5")
        xg, wg, bg = (t.clone().requires_grad_(True) for t in (x, w, b))
        lib = library_ms("layer_norm", lambda: F.layer_norm(x, (E,), w, b, 1e-5)) if main else None
        p3.report("layer_norm", f"{case} (mu, sigma relative error {stats:.2e} <= 1e-5)",
                  row_rel_err(y, ref), ROW_REL_TOL[dt], ROW_REL_WHY,
                  device_ms(lambda: layer_norm_fwd(x, w, b, 1e-5)),
                  device_ms(lambda: naive.naive_layer_norm_fwd(x, w, b, eps=1e-5)),
                  bound(2 * nbytes(x) + nbytes(w, b, mu, sigma), 8 * x.numel(), "f32"), lib,
                  main, measure="row relative error", abs_err=max_err(y, ref))
        xf = x.float()
        fault = (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-5) * w.float()
                 + b.float()).to(dt)
        _row_fault("layer_norm", f"{case}: the plain version without the mean",
                   row_rel_err(y, fault), ROW_REL_TOL[dt])
        del xf, fault, ref
        dx, dw, db = layer_norm_bwd(x, w, mu, sigma, dy)
        dx_ref, dw_ref, db_ref = naive.naive_layer_norm_bwd(x, w, mu, sigma, dy)
        for what, got, want in (("dw", dw, dw_ref), ("db", db, db_ref)):
            p3.report("layer_norm_bwd", f"{case}: {what} ({E},) f32, summed over 16384 rows",
                      ((got - want).norm() / want.norm()).item(), SUM_REL_TOL, SUM_REL_WHY,
                      measure="relative error", abs_err=max_err(got, want))
        lib = None
        if main:
            y_lib = F.layer_norm(xg, (E,), wg, bg, 1e-5)
            lib = library_ms("layer_norm_bwd", lambda: torch.autograd.grad(
                y_lib, (xg, wg, bg), dy, retain_graph=True))
            del y_lib
        p3.report("layer_norm_bwd", f"{case}: dx", row_rel_err(dx, dx_ref), ROW_REL_TOL[dt],
                  ROW_REL_WHY, device_ms(lambda: layer_norm_bwd(x, w, mu, sigma, dy)),
                  device_ms(lambda: naive.naive_layer_norm_bwd(x, w, mu, sigma, dy)),
                  bound(3 * nbytes(x) + nbytes(w, mu, sigma, dw, db), 12 * x.numel(), "f32"),
                  lib, main, measure="row relative error", abs_err=max_err(dx, dx_ref))
        del x, w, b, dy, y, mu, sigma, dx, dw, db, dx_ref, xg, wg, bg
        torch.cuda.empty_cache()

    def attn_case(name, case, q, k, v, do, kw, main=False, faults=(), timed=False, lib_kw=None):
        """C, then dQ and dK/dV through autograd (dpair as the pair's
        gradient), against the plain forward and backward one batch
        element at a time; each output per 64-row tile (dpair per 64 x 64
        tile). Returns the kernel's o and gradients."""
        pair, E = kw.get("pair"), q.shape[-1]
        o, lse = flash_fwd(q, k, v, **kw)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        if pair is not None:
            leaves.append(pair.clone().requires_grad_(True))
        out = flash_attention(*leaves[:3], leaves[3] if pair is not None else None,
                              causal=kw["causal"], kpad_mask=kw.get("kpad_mask"),
                              segment_ids=kw.get("segment_ids"))
        check(torch.equal(out, o), f"{name} [{case}]: flash_attention's o differs from C's")
        grads = torch.autograd.grad(out, leaves, do)
        del out, leaves
        o_ref = _by_batch(lambda *t, **k_: naive.naive_attention(*t, return_lse=True, **k_),
                          q, k, v, **kw)[0]
        ref = _by_batch(naive.naive_attention_bwd, q, k, v, o, lse, do, **kw)
        fwd_name = f"flash_fwd_{name}"
        stats = {}
        if timed:
            mask = lib_kw.pop("attn_mask")
            sdpa = functools.partial(F.scaled_dot_product_attention, scale=kw["scale"],
                                     enable_gqa=True, attn_mask=mask, **lib_kw)
            stats = dict(
                fwd=(device_ms(lambda: flash_fwd(q, k, v, **kw), n=5),
                     device_ms(lambda: _by_batch(
                         lambda *t, **k_: naive.naive_attention(*t, return_lse=True, **k_),
                         q, k, v, **kw), n=1, reps=3),
                     library_ms(fwd_name, lambda: sdpa(q, k, v), n=5)),
                dq=device_ms(lambda: flash_bwd_dq(q, k, v, o, lse, do, **kw), n=5),
                plain=device_ms(lambda: _by_batch(naive.naive_attention_bwd, q, k, v, o, lse,
                                                  do, **kw), n=1, reps=3))
            _, delta = flash_bwd_dq(q, k, v, o, lse, do, want_dpair=False, **kw)[:2]
            stats["dkv"] = device_ms(lambda: flash_bwd_dkv(q, k, v, lse, delta, do, **kw), n=5)
            lg = [t.clone().requires_grad_(True) for t in (q, k, v)]
            if mask.is_floating_point():
                mask = mask.clone().requires_grad_(True)
                lg.append(mask)
            graph = []

            def sdpa_bwd():
                if not graph:
                    graph.append(F.scaled_dot_product_attention(
                        *lg[:3], scale=kw["scale"], enable_gqa=True, attn_mask=mask, **lib_kw))
                return torch.autograd.grad(graph[0], lg, do, retain_graph=True)

            stats["lib_bwd"] = library_ms(f"flash_bwd_dq_{name}", sdpa_bwd, n=5)
            del lg, graph, mask, delta
        ms, plain_ms, lib = stats.get("fwd", (None, None, None))
        p3.report(fwd_name, case, tile_rel_err(o, o_ref), ATTN_REL_TOL, OPSET_ATTN_WHY, ms,
                  plain_ms, bound(*timed["fwd"], "bf16") if timed else None, lib, main,
                  measure="tile relative error", abs_err=max_err(o, o_ref))
        for what, over in faults:
            want = _by_batch(lambda *t, **k_: naive.naive_attention(*t, return_lse=True, **k_),
                             q, k, v, **dict(kw, **over))[0]
            _planted(fwd_name, what, tile_rel_err(o, want))
        errs = [tile_rel_err(g, r) for g, r in zip(grads[:3], ref[:3])]
        abs_errs = [max_err(g, r) for g, r in zip(grads[:3], ref[:3])]
        dq_err, dq_abs = errs[0], abs_errs[0]
        if pair is not None:
            dq_err = max(dq_err, tile2d_rel_err(grads[3], ref[3]))
            dq_abs = max(dq_abs, max_err(grads[3], ref[3]))
        p3.report(f"flash_bwd_dq_{name}", case + ": dq" + (", dpair" if pair is not None else ""),
                  dq_err, BWD_REL_TOL, OPSET_ATTN_WHY, stats.get("dq"), stats.get("plain"),
                  bound(*timed["dq"], "bf16") if timed else None, stats.get("lib_bwd"), main,
                  measure="tile relative error", abs_err=dq_abs)
        p3.report(f"flash_bwd_dkv_{name}", case + ": dk, dv", max(errs[1:]), BWD_REL_TOL,
                  OPSET_ATTN_WHY, stats.get("dkv"), stats.get("plain"),
                  bound(*timed["dkv"], "bf16") if timed else None, stats.get("lib_bwd"), main,
                  measure="tile relative error", abs_err=max(abs_errs[1:]))
        return o, grads, ref

    # pair bias at bench.py's reference grid (B 4, H 4, L 2048, E 64; causal
    # x kpad), pair N(0, 1)
    B, H, L, E = 4, 4, 2048, 64
    q, k, v, do = (randn(B, H, L, E) for _ in range(4))
    pair = randn(B, H, L, L)
    kpad = torch.rand(B, L, generator=gen, device=dev) > 0.2
    kpad[:, 0] = True
    for causal in (False, True):
        for use_pad in (False, True):
            kw = dict(causal=causal, scale=E ** -0.5, pair=pair,
                      kpad_mask=kpad if use_pad else None)
            attn_case("pair", f"reference grid (4, 4, 2048, 64), pair N(0, 1), causal {causal}, "
                      f"kpad {use_pad}", q, k, v, do, kw)
    del q, k, v, do, pair, kpad
    torch.cuda.empty_cache()

    # the 8B training geometry with the pair: (2, 32, 4096, 4096) bf16 N(0, 1)
    L, E = 4096, 128
    q, k, v, do = (randn(2, h, L, E) for h in (32, 8, 8, 32))
    pair = randn(2, 32, L, L)
    causal_mask = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
    pairs = 2 * 32 * L * (L + 1) // 2
    live_pair = pairs * pair.element_size()  # the pair elements a causal row reads
    io = nbytes(q, k, v, q) + 2 * 32 * L * 4  # q, k, v, o, lse
    timed = dict(fwd=(io + live_pair, 4 * E * pairs),
                 dq=(io + nbytes(do, q) + 2 * 32 * L * 4 + live_pair + nbytes(pair),
                     3 * 2 * E * pairs),
                 dkv=(io + nbytes(do, k, v) + 2 * 32 * L * 4 + live_pair, 4 * 2 * E * pairs))
    kw = dict(causal=True, scale=E ** -0.5, pair=pair)
    o, grads, ref = attn_case(
        "pair", "8B training geometry: q (2, 32, 4096, 128), kv (2, 8, 4096, 128), causal, "
        "pair (2, 32, 4096, 4096) bf16 N(0, 1)", q, k, v, do, kw, main=True,
        faults=[("the plain version without the pair", dict(pair=None))], timed=timed,
        lib_kw=dict(attn_mask=pair.masked_fill(~causal_mask, float("-inf"))))
    left_out = grads[3].clone()
    left_out[..., 64:128] = 0  # dpair with key tile 1 left out
    _planted("flash_bwd_dq_pair", "dpair with key tile 1 left out",
             tile2d_rel_err(left_out, ref[3]))
    print(f"phase 3 flash_bwd_pair: the whole backward's bound by bytes (dpair written "
          f"whole, pair read by both kernels) "
          f"{(2 * live_pair + nbytes(pair)) / HBM_BYTES_PER_S * 1e3:.4f} ms")
    del o, grads, ref, left_out, pair
    torch.cuda.empty_cache()

    # segment ids at attn8b_seg (bench.py:600-602): four documents of 1024
    seg = torch.arange(4, device=dev, dtype=torch.int32).repeat_interleave(1024).expand(2, L)
    moved = seg.clone()
    moved[:, 1024] = 0  # the first boundary one key later (keys only)
    doc_mask = causal_mask & (seg[0][:, None] == seg[0][None, :])
    visible = 2 * 32 * 4 * 1024 * 1025 // 2
    io = nbytes(q, k, v, q) + 2 * 32 * L * 4 + 2 * nbytes(seg)
    timed = dict(fwd=(io, 4 * E * visible),
                 dq=(io + nbytes(do, q) + 2 * 32 * L * 4, 3 * 2 * E * visible),
                 dkv=(io + nbytes(do, k, v) + 2 * 32 * L * 4, 4 * 2 * E * visible))
    kw = dict(causal=True, scale=E ** -0.5, segment_ids=(seg, seg))
    # C skips the key tiles (64 keys in this mode) whose range of ids misses
    # its block's: a range rule one tile too tight drops each block's first
    # live tile, each document's first 64 keys
    tight = torch.ones((2, L), dtype=torch.bool, device=dev)
    for d in range(4):
        tight[:, d * 1024:d * 1024 + 64] = False
    attn_case("segments", "attn8b_seg: q (2, 32, 4096, 128), kv (2, 8, 4096, 128), causal, "
              "4 documents of 1024", q, k, v, do, kw, main=True,
              faults=[("a document boundary one key later", dict(segment_ids=(seg, moved))),
                      ("the key-tile skip one tile too tight (each document's first 64 keys "
                       "dropped)", dict(kpad_mask=tight))],
              timed=timed, lib_kw=dict(attn_mask=doc_mask))
    # the same documents with their positions shuffled (ids unsorted: every
    # key tile's range meets every block's, nothing may be skipped wrongly)
    perm = torch.randperm(L, generator=gen, device=dev)
    shuffled = seg[:, perm].contiguous()
    kw = dict(causal=True, scale=E ** -0.5, segment_ids=(shuffled, shuffled))
    o = flash_fwd(q, k, v, **kw)[0]

    def plain():
        return _by_batch(lambda *t, **k_: naive.naive_attention(*t, return_lse=True, **k_),
                         q, k, v, **kw)[0]

    o_ref = plain()
    p3.report("flash_fwd_segments", "attn8b_seg's documents shuffled (ids unsorted), causal",
              tile_rel_err(o, o_ref), ATTN_REL_TOL, OPSET_ATTN_WHY,
              device_ms(lambda: flash_fwd(q, k, v, **kw), n=5), device_ms(plain, n=1, reps=3),
              measure="tile relative error", abs_err=max_err(o, o_ref))
    del q, k, v, do, seg, moved, doc_mask, causal_mask, tight, shuffled, o, o_ref
    torch.cuda.empty_cache()

    # head dims the kernels reach by zero-padding: 32 -> 64, 96 -> 128
    for E in (32, 96):
        q, k, v, do = (randn(2, h, 1000, E) for h in (32, 8, 8, 32))
        kw = dict(causal=True, scale=E ** -0.5)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention(*leaves, causal=True)
        grads = torch.autograd.grad(out, leaves, do)
        o_ref, lse_ref = _by_batch(
            lambda *t, **k_: naive.naive_attention(*t, return_lse=True, **k_), q, k, v, **kw)
        ref = _by_batch(naive.naive_attention_bwd, q, k, v, o_ref, lse_ref, do, **kw)
        case = f"head dim {E} (run at {64 if E == 32 else 128}): q (2, 32, 1000, {E}), causal"
        p3.report("flash_fwd", case, tile_rel_err(out, o_ref), ATTN_REL_TOL, OPSET_ATTN_WHY,
                  measure="tile relative error", abs_err=max_err(out, o_ref))
        p3.report("flash_bwd_dq", case, tile_rel_err(grads[0], ref[0]), BWD_REL_TOL,
                  OPSET_ATTN_WHY, measure="tile relative error")
        p3.report("flash_bwd_dkv", case, max(tile_rel_err(g, r) for g, r in
                                            zip(grads[1:], ref[1:])), BWD_REL_TOL,
                  OPSET_ATTN_WHY, measure="tile relative error")
        del q, k, v, do, leaves, out, grads, o_ref, lse_ref, ref
    torch.cuda.empty_cache()


def _row_fault(name, what, err, tol):
    """A planted row fault: the kernel's output against the plain version
    of a wrong computation must read above the row tolerance."""
    print(f"phase 3 {name} [planted fault: {what}]: row relative error {err:.3e} (must "
          f"exceed {tol:g})")
    check(err > tol, f"{name}: the planted fault ({what}) reads {err}")


def phase_products(p3, gen, randn):
    """Kernels F, G, H at the 8B serving shapes."""
    from nnop_tpu_torch.ops import naive
    from nnop_tpu_torch.ops.quantization import QTensor, QTensor4
    from nnop_tpu_torch.ops.quantized_matmul import (
        quantize_act,
        quantized_matmul,
        quantized_matmul4,
        quantized_matmul_w8a8,
    )

    dev = torch.device("cuda")
    bf = torch.bfloat16
    decode = {"wqkv": (4096, 6144), "wo": (4096, 4096), "w_gateup": (4096, 28672),
              "w_down": (14336, 4096), "lm_head": (4096, 128256)}

    def qtensor(K, N, dtype=torch.int8):
        vals = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        if dtype != torch.int8:  # fp8 values of the same magnitude range
            vals = (vals.float() / 127 * 448).to(dtype)
        scale = torch.full((N,), K ** -0.5 / 74.0, device=dev)
        return QTensor(vals, scale, 0)

    def tol(ref):
        return BF16_TOL * max(1.0, ref.float().abs().max().item())

    # F. weight-only int8 / fp8: the five decode products (M = 8), the
    #    prefill lm_head (M = 512), an fp8 case and a ragged-K case
    cases = [(8, name, *kn, torch.int8) for name, kn in decode.items()]
    cases += [(512, "lm_head", 4096, 128256, torch.int8),
              (8, "w_gateup fp8", 4096, 28672, torch.float8_e4m3fn),
              (100, "ragged K=300, N=200", 300, 200, torch.int8)]
    for M, what, K, N, dtype in cases:
        x, w = randn(M, K), qtensor(K, N, dtype)
        got, ref = quantized_matmul(x, w), naive.naive_quantized_matmul(x, w)
        name = "quantized_matmul" if dtype == torch.int8 else "quantized_matmul_fp8"
        is_main = (M, what) == (8, "w_gateup") or dtype != torch.int8
        lib = None
        if is_main:
            wb = w.values.float().to(bf)
            if dtype == torch.int8:
                lib = library_ms(name, lambda: torch.matmul(x, wb))
            else:
                x8, wt = x.to(dtype), w.values.t().contiguous().t()
                one = torch.ones((), device=dev)
                lib = library_ms(name, lambda: torch._scaled_mm(x8, wt, scale_a=one, scale_b=one,
                                                               out_dtype=bf))
        p3.report(name, f"M={M} {what} (K={K}, N={N})", max_err(got, ref), tol(ref),
                  QMM_TOL_WHY, device_ms(lambda: quantized_matmul(x, w)),
                  device_ms(lambda: naive.naive_quantized_matmul(x, w), n=3),
                  bound(nbytes(x, w.values, w.scale, got), 2 * M * K * N, "bf16"), lib, is_main)
        del x, w, got, ref
    torch.cuda.empty_cache()

    # G. W8A8 at prefill rows, bf16 output; exact with f32 output
    for M, what, (K, N) in ((256, "w_gateup", decode["w_gateup"]),
                            (512, "w_gateup", decode["w_gateup"]),
                            (256, "w_down", decode["w_down"]),
                            (512, "w_down", decode["w_down"])):
        xv, xs = quantize_act(randn(M, K))
        w = qtensor(K, N)
        got = quantized_matmul_w8a8((xv, xs), w)
        ref = naive.naive_quantized_matmul_w8a8(xv, xs, w)
        is_main, lib = (M, what) == (512, "w_gateup"), None
        if is_main:
            exact = quantized_matmul_w8a8((xv, xs), w, out_dtype=torch.float32)
            exact_ref = naive.naive_quantized_matmul_w8a8(xv, xs, w, torch.float32)
            check(torch.equal(exact, exact_ref), "W8A8 with f32 output is not exact")
            p3.report("quantized_matmul_w8a8", f"M={M} {what} f32 output", max_err(exact, exact_ref),
                      0.0, "exact int32 sums, the same f32 epilogue: bit-exact")
            lib = library_ms("quantized_matmul_w8a8", lambda: torch._int_mm(xv, w.values))
        p3.report("quantized_matmul_w8a8", f"M={M} {what} (K={K}, N={N})", max_err(got, ref),
                  tol(ref), QMM_TOL_WHY, device_ms(lambda: quantized_matmul_w8a8((xv, xs), w)),
                  device_ms(lambda: naive.naive_quantized_matmul_w8a8(xv, xs, w), n=3),
                  bound(nbytes(xv, xs, w.values, w.scale, got), 2 * M * K * N, "int8"), lib,
                  is_main)
        del xv, xs, w, got, ref
    torch.cuda.empty_cache()

    # H. int4 at decode and prefill rows
    for M, what, (K, N) in ((8, "w_gateup", decode["w_gateup"]),
                            (512, "w_gateup", decode["w_gateup"]),
                            (8, "w_down", decode["w_down"]),
                            (512, "w_down", decode["w_down"])):
        packed = torch.randint(-128, 128, (K // 2, N), generator=gen, device=dev,
                               dtype=torch.int8)
        w = QTensor4(packed, torch.full((K // 128, N), K ** -0.5 / 4.1, device=dev), 128, 1024)
        x = randn(M, K)
        got, ref = quantized_matmul4(x, w), naive.naive_quantized_matmul4(x, w)
        is_main = (M, what) == (8, "w_gateup")
        p3.report("quantized_matmul4", f"M={M} {what} (K={K}, N={N})", max_err(got, ref),
                  tol(ref), QMM_TOL_WHY, device_ms(lambda: quantized_matmul4(x, w)),
                  device_ms(lambda: naive.naive_quantized_matmul4(x, w), n=3),
                  bound(nbytes(x, w.packed, w.scale, got), 2 * M * K * N, "bf16"),
                  _int4pack_ms(x, w) if is_main else None, is_main)
        del packed, w, x, got, ref
    torch.cuda.empty_cache()


MIXTRAL = dict(d=4096, hidden=14336, E=8, k=2)


def _routed_rows(gen, T, k, E, d, bm=None, idx=None):
    """x (Tp, d) bf16 in the MoE layer's sorted layout (padding rows zero)
    for T random tokens routed top-k by random logits (or by `idx`), with
    the layer's block_m policy; returns (x, block_groups, block_rows,
    block_m, the expert offsets for torch._grouped_mm, the experts hit)."""
    from nnop_tpu_torch.models.moe import _block_m, sort_tokens_by_expert

    if idx is None:
        idx = torch.topk(torch.randn((T, E), generator=gen, device="cuda"), k, dim=-1).indices
    bm = bm or _block_m(T, idx.shape[1], E)
    src, dest, groups, Tp, _, rows = sort_tokens_by_expert(idx, E, bm)
    h = torch.randn((T, d), generator=gen, device="cuda").to(torch.bfloat16)
    x = h.new_zeros((Tp, d)).index_copy(0, dest, h[src])
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    offs = torch.cumsum((counts + bm - 1) // bm * bm, 0).to(torch.int32)
    return x, groups, rows, bm, offs, int((counts > 0).sum())


def _grouped_mm_ms(name, x, wb, offs):
    """torch._grouped_mm over the same sorted rows and (bf16) experts: the
    yardstick for kernel I (rows past the last expert's are left out). Its
    weight operand must be column-major on some torch builds: that layout
    is tried when the plain one is refused."""
    try:
        torch._grouped_mm(x, wb, offs=offs)
    except Exception:  # noqa: BLE001 - the yardstick is optional; try the other layout
        wb = wb.transpose(1, 2).contiguous().transpose(1, 2)
    return library_ms(name, lambda: torch._grouped_mm(x, wb, offs=offs))


def phase_grouped(p3, gen, randn):
    """Kernel I's four modes at Mixtral's shapes (d 4096, hidden 14336, E 8,
    top 2): decode (8 tokens, block_m 32, Tp 288) through w_gateup (8, 4096,
    28672) and w_down (8, 14336, 4096), prefill (512 tokens, block_m 128,
    Tp 2048), and edge cases: an expert with no token, every token on one
    expert, W8A8 into f32 bit-exact."""
    from nnop_tpu_torch.ops import naive
    from nnop_tpu_torch.ops.grouped_matmul import (
        _grouped_matmul_q4,
        grouped_matmul,
        grouped_matmul_quantized,
        grouped_matmul_w8a8,
    )
    from nnop_tpu_torch.ops.quantization import QTensor, QTensor4
    from nnop_tpu_torch.ops.quantized_matmul import quantize_act

    dev = torch.device("cuda")
    bf = torch.bfloat16
    d, hidden, E, k = (MIXTRAL[n] for n in ("d", "hidden", "E", "k"))
    shapes = {"w_gateup": (d, 2 * hidden), "w_down": (hidden, d)}

    def tol(ref):
        return BF16_TOL * max(1.0, ref.float().abs().max().item())

    def experts(K, N, mode):
        if mode == "bf16":
            return randn(E, K, N, scale=K ** -0.5)
        if mode == "int4":
            packed = torch.randint(-128, 128, (E, K // 2, N), generator=gen, device=dev,
                                   dtype=torch.int8)
            return QTensor4(packed, torch.full((E, K // 128, N), K ** -0.5 / 4.1, device=dev),
                            128, 1024)
        vals = torch.randint(-127, 128, (E, K, N), generator=gen, device=dev, dtype=torch.int8)
        return QTensor(vals, torch.full((E, N), K ** -0.5 / 74.0, device=dev), 1)

    def dequantized(w):  # the yardstick's bf16 experts
        if isinstance(w, QTensor):
            return (w.values.float() * w.scale[:, None]).to(bf)
        if isinstance(w, QTensor4):
            return torch.stack([naive.unpack4(QTensor4(p, s, w.group, w.pack_block)).float()
                                .mul_(s.repeat_interleave(w.group, dim=0)).to(bf)
                                for p, s in zip(w.packed, w.scale)])
        return w

    def run(mode, x, w, bg, rows, bm, out_dtype=None):
        """(kernel call, plain call) for one mode."""
        if mode == "bf16":
            return (lambda: grouped_matmul(x, w, bg, block_m=bm, block_rows=rows),
                    lambda: naive.naive_grouped_matmul(x, w, bg, bm))
        if mode == "int8":
            return (lambda: grouped_matmul_quantized(x, w, bg, block_m=bm, block_rows=rows),
                    lambda: naive.naive_grouped_matmul_quantized(x, w, bg, bm))
        if mode == "int4":
            return (lambda: _grouped_matmul_q4(x, w, bg, block_m=bm, block_rows=rows),
                    lambda: naive.naive_grouped_matmul4(x, w, bg, bm))
        xv, xs = x
        return (lambda: grouped_matmul_w8a8((xv, xs), w, bg, block_m=bm, block_rows=rows,
                                            out_dtype=out_dtype),
                lambda: naive.naive_grouped_matmul_w8a8(xv, xs, w, bg, bm,
                                                        out_dtype or torch.bfloat16))

    names = {"bf16": "grouped_matmul", "int8": "grouped_matmul_quantized",
             "w8a8": "grouped_matmul_w8a8", "int4": "grouped_matmul4"}
    decode = _routed_rows(gen, 8, k, E, d)
    prefill = _routed_rows(gen, 512, k, E, d)
    check(decode[0].shape[0] == 288 and decode[3] == 32, f"decode Tp {decode[0].shape[0]}")
    check(prefill[0].shape[0] == 2048 and prefill[3] == 128, f"prefill Tp {prefill[0].shape[0]}")
    for mode in ("bf16", "int8", "int4", "w8a8"):
        # W8A8 runs at prefill only (Tp >= 1024); the others at decode and prefill
        for tag, (x, bg, rows, bm, offs, hit) in (() if mode == "w8a8" else
                                                  (("decode", decode),)) + (("prefill", prefill),):
            T = 8 if tag == "decode" else 512
            for what, (K, N) in shapes.items():
                xin = x if K == d else randn(x.shape[0], K) * (rows_mask(rows, bm)[:, None])
                w = experts(K, N, "int8" if mode == "w8a8" else mode)
                if mode == "w8a8":
                    xin = quantize_act(xin)
                kern, plain = run(mode, xin, w, bg, rows, bm)
                got, ref = kern(), plain()
                main = what == "w_gateup" and tag == ("prefill" if mode == "w8a8" else "decode")
                # each expert hit streams its weights and scales once; the
                # real rows are read once and written once
                wbytes = {"bf16": 2 * K * N, "int8": K * N + 4 * N, "w8a8": K * N + 4 * N,
                          "int4": K * N // 2 + 4 * (K // 128) * N}[mode]
                real = T * k
                xbytes = K + 4 if mode == "w8a8" else 2 * K
                bnd = bound(hit * wbytes + real * (xbytes + 2 * N), 2 * real * K * N,
                            "int8" if mode == "w8a8" else "bf16")
                lib = None
                if main:  # on the same bf16 rows, with bf16 (dequantized) experts
                    lib = _grouped_mm_ms(names[mode], x, dequantized(w), offs)
                    if mode == "w8a8":  # bit-exact with f32 output
                        kf, pf = run(mode, xin, w, bg, rows, bm, torch.float32)
                        exact, exact_ref = kf(), pf()
                        check(torch.equal(exact, exact_ref),
                              "grouped W8A8 with f32 output is not exact")
                        p3.report(names[mode], f"prefill {what} f32 output",
                                  max_err(exact, exact_ref), 0.0,
                                  "exact int32 sums, the same f32 epilogue: bit-exact")
                p3.report(names[mode], f"{tag}: {T} tokens, Tp {x.shape[0]}, block_m {bm}, "
                          f"{hit} experts hit, {what} ({E}, {K}, {N}) {mode}",
                          max_err(got, ref), tol(ref), QMM_TOL_WHY, device_ms(kern),
                          device_ms(plain, n=3), bnd, lib, main)
                del w, got, ref, xin
            torch.cuda.empty_cache()

    # edge cases at (4096, 4096): expert 3 gets no token (and expert 7, the
    # clipped trailing blocks' expert, none either); all 512 tokens on expert 5
    no3 = torch.tensor([[0, 1], [1, 2], [2, 0], [4, 5], [5, 6], [6, 4], [0, 2], [1, 4]],
                       device=dev)
    one = torch.full((512, 1), 5, device=dev)
    for case, (x, bg, rows, bm, _, hit) in (("experts 3 and 7 without a token",
                                             _routed_rows(gen, 8, k, E, d, idx=no3)),
                                            ("all 512 tokens on expert 5",
                                             _routed_rows(gen, 512, 1, E, d, idx=one))):
        for mode in ("bf16", "int8", "int4", "w8a8"):
            w = experts(d, d, "int8" if mode == "w8a8" else mode)
            xin = quantize_act(x) if mode == "w8a8" else x
            kern, plain = run(mode, xin, w, bg, rows, bm, torch.float32 if mode == "w8a8" else
                              None)
            got, ref = kern(), plain()
            if mode == "w8a8":
                check(torch.equal(got, ref), f"grouped W8A8 [{case}] with f32 output not exact")
            p3.report(names[mode], f"{case}: Tp {x.shape[0]}, block_m {bm}, (8, 4096, 4096) "
                      f"{mode}", max_err(got, ref), 0.0 if mode == "w8a8" else tol(ref),
                      "bit-exact" if mode == "w8a8" else QMM_TOL_WHY)
            del w, got, ref
    torch.cuda.empty_cache()


DW_TILE_TOL = 1e-3
DW_TILE_WHY = ("the largest |dw - plain| / |plain| over the (expert, 128 x 128) tiles of dw: bf16 "
               "outputs of fp32 sums over ~1024 rows taken in another order (~2e-6 relative), so "
               "the two sides round to different bf16 values (2^-8 relative apart) in few "
               "elements; a tile whose plain dw is zero must be zero")


def dw_tile_rel_err(got, ref, tile=128):
    """The largest |got - ref| / |ref| (Frobenius norms) over the (expert,
    tile x tile) tiles of (E, K, N) tensors; inf if a tile whose reference
    is zero is not zero."""
    def tiles(t):
        E, K, N = t.shape
        t = torch.nn.functional.pad(t.float(), (0, -N % tile, 0, -K % tile))
        return t.reshape(E, t.shape[1] // tile, tile, t.shape[2] // tile, tile).transpose(2, 3)

    dn = tiles(got.float() - ref.float()).pow(2).sum((-1, -2)).sqrt()
    rn = tiles(ref).pow(2).sum((-1, -2)).sqrt()
    zero = rn == 0
    if bool((dn[zero] > 0).any()):
        return float("inf")
    return (dn[~zero] / rn[~zero]).max().item()


def _grouped_mm_dw_ms(x, dy, offs):
    """torch._grouped_mm in its 2-D x 2-D mode with offsets on the shared
    (row) dimension, x^T (K, Tp) by dy (Tp, N) -> (E, K, N): the yardstick
    for the dw kernel, or None with the error printed. The layouts some
    torch builds ask of the operands are tried in turn."""
    errors = []
    for a, b in ((x.t(), dy), (x.t().contiguous(), dy),
                 (x.t().contiguous(), dy.t().contiguous().t())):
        try:
            torch._grouped_mm(a, b, offs=offs)
        except Exception as e:  # noqa: BLE001 - the yardstick is optional; try the next layout
            errors.append(f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
            continue
        return library_ms("grouped_matmul_dw", lambda: torch._grouped_mm(a, b, offs=offs), n=5)
    print(f"phase 3 grouped_matmul_dw: library call torch._grouped_mm (2-D x 2-D, offs on the "
          f"rows) raised for every layout: {errors[-1]}")
    return None


def phase_grouped_bwd(p3, gen, randn):
    """The grouped product's backward at Mixtral's training shapes (B 1, L
    4096, top 2: 8192 assignments, block_m 512, Tp 12288): dw (the new
    kernel) and dx (kernel I on the transposed experts) for w_gate (8,
    4096, 14336) and w_down (8, 14336, 4096); a planted fault against the
    dw gate; two bit-identical dw runs; edge cases: experts without a row
    (dw exactly 0 over memory poisoned with NaN) at decode-sized block_m
    32, and every row on one expert."""
    from nnop_tpu_torch.ops import naive
    from nnop_tpu_torch.ops.grouped_matmul import grouped_matmul, grouped_matmul_dw

    dev = torch.device("cuda")
    d, hidden, E, k = (MIXTRAL[n] for n in ("d", "hidden", "E", "k"))
    T = 4096
    x_d, bg, rows, bm, offs, hit = _routed_rows(gen, T, k, E, d)
    Tp = x_d.shape[0]
    check(Tp == 12288 and bm == 512, f"training Tp {Tp}, block_m {bm}")
    real = rows_mask(rows, bm)[:, None]
    print(f"phase 3 grouped backward routing: {T} tokens, top {k}: {T * k} assignments, Tp {Tp}, "
          f"block_m {bm}, real rows per block {rows.tolist()}")

    def tol(ref):
        return BF16_TOL * max(1.0, ref.float().abs().max().item())

    def poisoned_dw(x, dy, groups, brows, bmm):
        """dw with the allocator's next block of its size filled with NaN
        first, so an unwritten element would show."""
        junk = torch.full((E, x.shape[1], dy.shape[1]), float("nan"), dtype=torch.bfloat16,
                          device=dev)
        del junk
        return grouped_matmul_dw(x, dy, groups, block_m=bmm, n_experts=E, block_rows=brows)

    for what, (K, N) in (("w_gate", (d, hidden)), ("w_down", (hidden, d))):
        x = x_d if K == d else randn(Tp, K) * real
        dy = randn(Tp, N, scale=0.1) * real
        w = randn(E, K, N, scale=K ** -0.5)
        n_real = T * k
        got = poisoned_dw(x, dy, bg, rows, bm)
        ref = naive.naive_grouped_matmul_dw(x, dy, bg, bm, E, rows)
        check(bool(torch.isfinite(got).all()), f"dw {what}: non-finite values")
        if what == "w_gate":
            again = grouped_matmul_dw(x, dy, bg, block_m=bm, n_experts=E, block_rows=rows)
            check(torch.equal(got, again), "dw: two runs on the same inputs differ")
            print("phase 3 grouped_matmul_dw: two runs on the same inputs are bit-identical")
            del again
            # the gate's reach: the plain dw without the last block of the
            # expert whose last block has the fewest real rows
            last = {int(g): i for i, g in enumerate(bg.tolist()) if rows[i] > 0}
            e_f, b_f = min(last.items(), key=lambda kv: int(rows[kv[1]]))
            cut = rows.clone()
            cut[b_f] = 0
            fault = dw_tile_rel_err(naive.naive_grouped_matmul_dw(x, dy, bg, bm, E, cut), ref)
            print(f"phase 3 grouped_matmul_dw: planted fault (expert {e_f} without its last block, "
                  f"{int(rows[b_f])} of its {int(rows[bg == e_f].sum())} rows) reads tile "
                  f"relative error {fault:.3e} (tol {DW_TILE_TOL:g})")
            check(fault > DW_TILE_TOL, f"the planted dw fault passes the gate: {fault}")
        kern = functools.partial(grouped_matmul_dw, x, dy, bg, block_m=bm, n_experts=E,
                                 block_rows=rows)
        p3.report("grouped_matmul_dw", f"training: Tp {Tp}, block_m {bm}, {n_real} real rows, "
                  f"{what} dw ({E}, {K}, {N}) bf16", dw_tile_rel_err(got, ref), DW_TILE_TOL,
                  DW_TILE_WHY, device_ms(kern, n=5),  # bound: each row read once, dw written once
                  device_ms(lambda: naive.naive_grouped_matmul_dw(x, dy, bg, bm, E, rows), n=1,
                            reps=3),
                  bound(n_real * (K + N) * 2 + E * K * N * 2, 2 * n_real * K * N, "bf16"),
                  _grouped_mm_dw_ms(x, dy, offs), what == "w_gate", "tile relative error",
                  max_err(got, ref))
        del got, ref
        # dx: kernel I on dy with the experts transposed (what the backward runs)
        wt = w.transpose(1, 2).contiguous()
        got = grouped_matmul(dy, wt, bg, block_m=bm, block_rows=rows)
        ref = naive.naive_grouped_matmul(dy, wt, bg, bm)
        p3.report("grouped_matmul_dx", f"training: Tp {Tp}, block_m {bm}, {n_real} real rows, "
                  f"{what} dx = dy ({Tp}, {N}) @ ({E}, {N}, {K}) bf16", max_err(got, ref),
                  tol(ref), QMM_TOL_WHY,
                  device_ms(lambda: grouped_matmul(dy, wt, bg, block_m=bm, block_rows=rows), n=5),
                  device_ms(lambda: naive.naive_grouped_matmul(dy, wt, bg, bm), n=1, reps=3),
                  bound(hit * N * K * 2 + n_real * (N + K) * 2, 2 * n_real * N * K, "bf16"),
                  _grouped_mm_ms("grouped_matmul_dx", dy, wt, offs), what == "w_gate")
        print(f"phase 3 grouped_matmul_dx: the backward's transposed copy of {what} "
              f"({E}, {N}, {K}) takes {device_ms(lambda: w.transpose(1, 2).contiguous(), n=5):.4f} "
              "ms (torch copy, not a kernel of the port)")
        del x, dy, w, wt, got, ref
        torch.cuda.empty_cache()

    # edge cases at (4096, 4096): 8 decode tokens with experts 3 and 7
    # without a row (block_m 32); all 4096 training tokens on expert 5
    no3 = torch.tensor([[0, 1], [1, 2], [2, 0], [4, 5], [5, 6], [6, 4], [0, 2], [1, 4]],
                       device=dev)
    one = torch.full((T, 1), 5, device=dev)
    for case, (x, bg, rows, bm, _, hit), empty in (
            ("decode: 8 tokens, experts 3 and 7 without a row",
             _routed_rows(gen, 8, k, E, d, idx=no3), (3, 7)),
            (f"all {T} tokens on expert 5", _routed_rows(gen, T, 1, E, d, idx=one),
             (0, 1, 2, 3, 4, 6, 7))):
        dy = randn(x.shape[0], d, scale=0.1) * rows_mask(rows, bm)[:, None]
        got = poisoned_dw(x, dy, bg, rows, bm)
        check(all(bool((got[e] == 0).all()) for e in empty),
              f"dw [{case}]: an expert without a row has a nonzero dw")
        p3.report("grouped_matmul_dw", f"{case}: Tp {x.shape[0]}, block_m {bm}, (8, 4096, 4096); "
                  f"experts {list(empty)} exactly 0", dw_tile_rel_err(
                      got, naive.naive_grouped_matmul_dw(x, dy, bg, bm, E, rows)), DW_TILE_TOL,
                  DW_TILE_WHY, measure="tile relative error")
        w = randn(E, d, d, scale=d ** -0.5)
        got = grouped_matmul(dy, w, bg, block_m=bm, block_rows=rows)
        ref = naive.naive_grouped_matmul(dy, w, bg, bm)
        p3.report("grouped_matmul_dx", f"{case}: Tp {x.shape[0]}, block_m {bm}, (8, 4096, 4096)",
                  max_err(got, ref), tol(ref), QMM_TOL_WHY)
        del x, dy, w, got, ref
    torch.cuda.empty_cache()


def rows_mask(rows, bm):
    """(Tp,) 1 for a block's real rows, 0 for its padding (bf16)."""
    return (torch.arange(bm, device=rows.device)[None] < rows[:, None]).reshape(-1).to(
        torch.bfloat16)


def _int4pack_ms(x, w):
    """torch._weight_int4pack_mm on the same int4 weights, repacked into
    its tiled layout (unsigned nibbles q + 8, even K in the high nibble; it
    dequantizes (u - 8) * scale + zero, so the zeros are 0), timed as the
    yardstick for kernel H."""
    from nnop_tpu_torch.ops.quantization import unpack4

    try:
        q = (unpack4(w) + 8).to(torch.uint8).t().contiguous()  # (N, K) in [0, 15]
        packed = (q[:, 0::2] << 4 | q[:, 1::2]).contiguous()  # (N, K/2)
        wp = torch._convert_weight_to_int4pack(packed, 8)
        scales = w.scale.to(torch.bfloat16)
        sz = torch.stack([scales, torch.zeros_like(scales)], dim=-1).contiguous()
        return library_ms("quantized_matmul4",
                          lambda: torch._weight_int4pack_mm(x, wp, w.group, sz))
    except Exception as e:  # noqa: BLE001 - the yardstick is optional; report why
        print(f"phase 3 quantized_matmul4: library call raised {type(e).__name__}: "
              f"{str(e).splitlines()[0][:300]}")
        return None


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def _serve(eng, prompts, max_tokens):
    """Post `prompts` concurrently to an EngineServer over `eng`. Returns
    (the answers' bodies, wall seconds, /v1/stats)."""
    from nnop_tpu_torch.runtime.server import EngineServer

    results = [None] * len(prompts)
    srv = EngineServer(eng, port=0).start()
    try:
        def call(i):
            results[i] = _post(srv.port, {"prompt": prompts[i], "max_tokens": max_tokens})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a request did not finish")
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/v1/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        srv.stop()
    for res in results:
        check(res is not None and res[0] == 200, f"answer {res}")
    return [body for _, body in results], wall, stats


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def first_logits(eng, prompt, n_match=0):
    """The engine's own first-token logits for `prompt`: its bucketed
    prefill, its chunked admission (longer than prefill_chunk), or with
    n_match its prefix-hit remainder over the pages the prefix cache
    holds for prompt[:n_match]."""
    dev, cfg, n = eng.device, eng.cfg, len(prompt)
    if n_match:
        pages = eng._prefix_cache[tuple(prompt[:n_match])]
        return eng._prefill_remainder(prompt, n_match, pages)[0][0]
    if n <= eng.prefill_chunk:
        bucket = max(64, 1 << (n - 1).bit_length())
        padded = torch.tensor([prompt + [0] * (bucket - n)], device=dev)
        return eng._prefill(eng.params, padded)[0][0, n - 1]
    C, nl = eng.prefill_chunk, cfg.n_layers
    sbuf = -(-n // C) * C
    ks = torch.zeros((nl, 1, cfg.n_kv_heads, sbuf, cfg.head_dim), dtype=torch.bfloat16,
                     device=dev)
    vs = torch.zeros_like(ks)
    for ci in range(sbuf // C):
        chunk = prompt[ci * C:(ci + 1) * C]
        chunk = torch.tensor([chunk + [0] * (C - len(chunk))], device=dev)
        logits, ks, vs = eng._prefill_chunk_fn(eng.params, chunk, ks, vs, ci * C)
    return logits[0, (n - 1) - (sbuf // C - 1) * C]


class _Routes:
    """Within the block, the expert ids of every router call
    (models/moe.py:router_topk), in call order."""

    def __enter__(self):
        import nnop_tpu_torch.models.moe as moe

        self.mod, self.fn, self.calls = moe, moe.router_topk, []

        def record(*a, **kw):
            out = self.fn(*a, **kw)
            self.calls.append(out[1])
            return out

        moe.router_topk = record
        return self

    def __exit__(self, *exc):
        self.mod.router_topk = self.fn


def serve_and_check(tag, params, cfg, counters, engine_kw, prompts, refs, matmul=None,
                    idle=(), after=None, max_tokens=32, forward_kw=None):
    """Serve `prompts` concurrently through EngineServer on an engine over
    `params` built with `engine_kw`, check every answer, that each of
    `counters` launched and each of `idle` did not, `after(eng, stats)`,
    and the engine's first-token logits against the plain forward (with
    `forward_kw`) for each (index into prompts, n_match) of `refs`; for a
    MoE model, the share of (token, slot) expert assignments in which the
    two differ (prompts of one prefill pass). Returns the counts."""
    from nnop_tpu_torch.models.llama import forward
    from nnop_tpu_torch.runtime.engine import Engine

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    eng = Engine(params, cfg, **engine_kw)
    torch.cuda.synchronize()
    print(f"{tag} setup: engine {engine_kw} in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; cache "
          f"{tuple(eng.state.k.shape)} {eng.state.k.dtype}")
    lens = [len(p) for p in prompts]

    for c in (*counters, *idle):
        c.reset()
    bodies, wall, stats = _serve(eng, prompts, max_tokens)
    launches = {c.name: c.read() for c in (*counters, *idle)}

    outs = []
    for n, body in zip(lens, bodies):
        toks = body["tokens"]
        check(len(toks) == max_tokens, f"prompt {n}: {len(toks)} tokens, expected {max_tokens}")
        check(all(0 <= t < cfg.vocab_size for t in toks), f"prompt {n}: token out of range")
        outs.append(toks)
    check(stats["requests_completed"] >= len(prompts), f"stats: {stats}")
    check(stats["tokens_generated"] >= len(prompts) * max_tokens, f"stats: {stats}")
    print(f"{tag} serve: {len(prompts)} concurrent requests (prompts of {sorted(set(lens))} "
          f"tokens), {len(prompts) * max_tokens} tokens in {wall:.2f} s wall = "
          f"{len(prompts) * max_tokens / wall:.1f} tok/s (observation, not a claim); "
          f"stats {stats}")
    print(f"{tag} launches during serving: {launches}")
    for c in counters:
        check(launches[c.name] > 0, f"kernel {c.name} was not launched on the {tag} path")
    for c in idle:
        check(launches[c.name] == 0, f"kernel {c.name} was launched on the {tag} path")
    if after is not None:
        after(eng, stats)

    # the engine's first-token logits (its own prefill path, on the
    # kernels) against the plain-op forward on the card
    @torch.no_grad()
    def plain(toks):
        return forward(params, torch.tensor([toks], device=dev), cfg, plain=True,
                       matmul=matmul, **(forward_kw or {}))[0, -1]

    for i, n_match in refs:
        with _Routes() as on_kernels:
            got = first_logits(eng, prompts[i], n_match)
        with _Routes() as on_plain:
            want = plain(prompts[i])
        cos = _cosine(got, want)
        how = f"prefix hit of {n_match} tokens" if n_match else "no prefix hit"
        routes = ""
        n = lens[i]
        if on_plain.calls and len(on_kernels.calls) == len(on_plain.calls):
            flips = sum(int((a[:n].sort(-1).values != b.sort(-1).values).sum())
                        for a, b in zip(on_kernels.calls, on_plain.calls))
            total = n * cfg.n_experts_per_token * cfg.n_layers
            routes = (f"; {flips} of {total} (token, slot) expert assignments differ "
                      f"({100 * flips / total:.3f}%, information only)")
        print(f"{tag} reference: prompt {i} ({n} tokens, {how}): first-token logits "
              f"cosine {cos:.6f} (>= 0.99 required), argmax engine {int(got.argmax())} "
              f"plain {int(want.argmax())}{routes}")
        check(cos >= 0.99, f"{tag} prompt {i}: cosine {cos}")
        check(bool(torch.isfinite(got).all()), "non-finite logits")

    first = refs[0][0]
    toks, greedy = list(prompts[first]), []
    for _ in range(8):
        nxt = int(plain(toks).argmax())
        greedy.append(nxt)
        toks.append(nxt)
    agree = sum(a == b for a, b in zip(outs[first][:8], greedy))
    print(f"{tag} greedy agreement with the plain forward over the first 8 tokens: "
          f"{agree}/8 (information only)")
    del eng
    return launches


class Counter:
    """One launch count of a kernel wrapper under its entry name:
    `launches`, a mode's own count such as `int8_launches`, with `minus`,
    `launches` less that mode's (the other mode's launches), or with
    `mode`, a predicate over the keys of the wrapper's `mode_launches`
    (head dim and its flags), the launches of the modes it accepts."""

    def __init__(self, name, fn, attr="launches", minus=None, mode=None):
        self.name, self.fn, self.attr, self.minus, self.mode = name, fn, attr, minus, mode

    def reset(self):
        if self.mode is not None:
            self.fn.mode_launches.clear()
        for attr in (self.attr, self.minus):
            if attr is not None:
                setattr(self.fn, attr, 0)

    def read(self):
        if self.mode is not None:
            return sum(n for key, n in self.fn.mode_launches.items() if self.mode(*key))
        return getattr(self.fn, self.attr) - (getattr(self.fn, self.minus) if self.minus else 0)


def check_pages(eng, stats):
    """Phase 7: the prefix cache served 16 x 384 tokens, and after the
    drain every page it does not hold is free, each held page once."""
    hits = 16 * 384
    check(eng.prefix_hits == hits and stats["prefix_hit_tokens"] == hits,
          f"prefix hits {eng.prefix_hits} (stats {stats['prefix_hit_tokens']}), expected {hits}")
    held = [p for pages in eng._prefix_cache.values() for p in pages]
    free = eng._free_pages
    check(len(set(held)) == len(held) == 16 * 3, f"{len(held)} cached pages, expected 48")
    check(len(set(free)) == len(free) and not set(free) & set(held)
          and len(free) + len(held) == eng.n_pages,
          f"{len(free)} free + {len(held)} cached pages of {eng.n_pages}")
    check(all(eng._page_refs[p] == 1 for p in held), "a cached page has a refcount other than 1")
    check(all(not pages for pages in eng._slot_pages), "a slot still holds pages")
    print(f"phase 7 pages: {hits} prefix-hit tokens; {len(held)} pages held by the prefix "
          f"cache (refcount 1 each), {len(free)} free, of {eng.n_pages}")


LOSS_RTOL = 2e-4
LOSS_RTOL_WHY = ("10x the reading of 1.98e-5 on an H100 80GB HBM3 at 700 W: the two paths round "
                 "activations to bf16 in different places. At random init the loss sits near "
                 "ln(128256) whatever the layers compute, so the gradients carry this check")
GRAD_COS = 0.9995
GRAD_REL = 3e-2
GRAD_WHY = ("bf16 gradients through two layers of bf16 activations rounded in different "
            "places. The worst leaf read cosine 0.999874 on an H100 80GB HBM3 at 700 W: "
            "1 - cosine is held to 4x that, |g - plain| / |plain| to about 2x the "
            "sqrt(2 (1 - cosine)) it implies; both stricter than the minimum cosine of 0.99")


def train_launches(n_layers, moe=False, post_norms=False, tied=False, adamw=True):
    """The kernel launches of one training step: 2 norms per layer (4 with
    Gemma-2's post norms) + the final norm, q and k rotated per layer, one
    attention per layer; a MoE layer's three grouped products, each with
    its dx and dw; with `adamw`, one AdamW launch per parameter leaf (a
    layer's norms, 4 attention projections and 3 MLP matrices, or the
    router and 3 expert stacks; the embedding, the final norm and, unless
    tied, the head)."""
    norms = (4 if post_norms else 2) * n_layers + 1
    per = {"rms_norm_rstd": norms, "rms_norm_bwd": norms,
           "llama_rope": 2 * n_layers, "llama_rope_bwd": 2 * n_layers, "flash_fwd": n_layers,
           "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}
    if moe:
        per.update(grouped_matmul=3 * n_layers, grouped_matmul_dx=3 * n_layers,
                   grouped_matmul_dw=3 * n_layers)
    if adamw:
        layer = (4 if post_norms else 2) + 4 + (4 if moe else 3)
        per["adamw_update"] = layer * n_layers + (2 if tied else 3)
    return per


TRAIN_LAUNCHES_PER_STEP = train_launches(8)  # phase 8b's 8-layer trainer
MOE_TRAIN_LAUNCHES_PER_STEP = train_launches(2, moe=True)  # phase 10b's 2-layer Mixtral


def family_train_launches(cfg):
    """Phase 13's launches per step of Mistral-7B or Gemma-2-2B: the
    trainer's, every C, dQ and dK/dV launch in its family's mode entry
    (Mistral's window at head dim 128, Gemma-2's softcap at head dim 256),
    and their window and softcap launches (Gemma-2's window on its even
    layers only)."""
    n = cfg.n_layers
    n_win = sum(cfg.layer_window(i) is not None for i in range(n))
    n_cap = n if cfg.attn_softcap is not None else 0
    per = train_launches(n, post_norms=cfg.post_norms, tied=cfg.tie_embeddings)
    for op in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        per[f"{op}_{'e256_softcap' if n_cap else 'window'}"] = n
        per[f"{op}.window_launches"] = n_win
        per[f"{op}.softcap_launches"] = n_cap
    return per


def phase_grad_parity(tag, name, cfg, seq):
    """8a and 13a: loss and gradients through the kernels and through the
    plain ops, `cfg` (full width, 2 layers), B=1, L=seq."""
    from nnop_tpu_torch.models.llama import init_params, loss_fn
    from nnop_tpu_torch.parallel.tp_llama import tree_leaves

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = init_params(gen, cfg)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    rng = np.random.default_rng(SEED)
    toks, tgts = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, seq))).to(dev)
                  for _ in range(2))
    results = []
    for plain in (False, True):
        loss = loss_fn(params, toks, tgts, cfg, plain=plain)
        results.append((loss.item(), torch.autograd.grad(loss, leaves)))
        del loss
    (k_loss, k_grads), (p_loss, p_grads) = results
    rel = abs(k_loss - p_loss) / abs(p_loss)
    cos = [_cosine(a, b) for a, b in zip(k_grads, p_grads)]
    grel = [((a.float() - b.float()).norm() / b.float().norm()).item()
            for a, b in zip(k_grads, p_grads)]
    print(f"phase {tag} grads: {name} width, {cfg.n_layers} layers, B=1, L={seq}: loss kernels "
          f"{k_loss:.6f} "
          f"plain {p_loss:.6f} (relative {rel:.2e} <= {LOSS_RTOL:g}: {LOSS_RTOL_WHY}); "
          f"{len(cos)} gradient leaves, cosine min {min(cos):.6f} mean "
          f"{statistics.mean(cos):.6f} (>= {GRAD_COS} each), |g - plain| / |plain| max "
          f"{max(grel):.3e} mean {statistics.mean(grel):.3e} (<= {GRAD_REL:g} each): {GRAD_WHY}")
    check(np.isfinite(k_loss) and rel <= LOSS_RTOL, f"{tag}: loss relative difference {rel}")
    check(all(bool(torch.isfinite(g).all()) for g in k_grads), f"{tag}: a non-finite gradient")
    worst = min(range(len(cos)), key=cos.__getitem__)
    check(min(cos) >= GRAD_COS, f"{tag}: gradient leaf {worst}: cosine {cos[worst]}")
    worst = max(range(len(grel)), key=grel.__getitem__)
    check(max(grel) <= GRAD_REL, f"{tag}: gradient leaf {worst}: relative error {grel[worst]}")
    del params, leaves, results, k_grads, p_grads
    gc.collect()
    torch.cuda.empty_cache()


OPSET_ENTRIES = ("online_softmax", "online_softmax_bwd", "layer_norm", "layer_norm_bwd",
                 "flash_fwd_pair", "flash_bwd_dq_pair", "flash_bwd_dkv_pair",
                 "flash_fwd_segments", "flash_bwd_dq_segments", "flash_bwd_dkv_segments")
PACKED_COS = 0.999
PACKED_WHY = ("bf16 activations: the packed row and the document alone run the same kernels "
              "on the same rows, but the products see other row counts and sum in another "
              "order")


def _exact_launches(tag, counters, expected, fn):
    """Run fn with every counter set to 0 just before and read just after:
    each must read its expected count (0 where none is given)."""
    for c in counters:
        c.reset()
    out = fn()
    torch.cuda.synchronize()
    counts = {c.name: c.read() for c in counters}
    wrong = {n: (v, expected.get(n, 0)) for n, v in counts.items() if v != expected.get(n, 0)}
    check(not wrong, f"{tag}: launches (got, expected) {wrong}")
    print(f"phase {tag} launches: " + ", ".join(f"{n} {v}" for n, v in counts.items() if v)
          + " (exact; every other kernel 0)")
    return out, counts


def phase_opset_autograd(counters):
    """12a: online_softmax, layer_norm and flash_attention with the pair
    and with segment ids through torch.autograd at phase 3's shapes, as a
    user calls them: one launch of each kernel per call."""
    from nnop_tpu_torch import flash_attention, layer_norm, online_softmax

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def grads_of(fn, leaves, dy):
        def run():
            out = fn(*leaves)
            return out, torch.autograd.grad(out, leaves, dy)
        return run

    launches = {}
    x, dy = randn(16384, 4096, dtype=torch.float32), randn(16384, 4096, dtype=torch.float32)
    (y, g), counts = _exact_launches("12a online_softmax", counters, dict(
        online_softmax=1, online_softmax_bwd=1), grads_of(online_softmax,
                                                          [x.requires_grad_(True)], dy))
    check(bool(torch.isfinite(g[0]).all()) and y.dtype == torch.float32, "12a softmax output")
    launches.update({n: c for n, c in counts.items() if c})
    del x, dy, y, g
    leaves = [(2 * randn(16384, 4096, dtype=torch.float32) + 0.5).to(bf),
              (1 + 0.1 * randn(4096, dtype=torch.float32)).to(bf), 0.1 * randn(4096)]
    (y, g), counts = _exact_launches("12a layer_norm", counters, dict(
        layer_norm=1, layer_norm_bwd=1), grads_of(lambda x, w, b: layer_norm(x, w, b, 1e-5),
                                                  [t.requires_grad_(True) for t in leaves],
                                                  randn(16384, 4096)))
    check(all(bool(torch.isfinite(t).all()) and t.dtype == bf for t in g), "12a layer_norm grads")
    launches.update({n: c for n, c in counts.items() if c})
    del leaves, y, g
    q, k, v, do = (randn(2, h, 4096, 128) for h in (32, 8, 8, 32))
    pair = randn(2, 32, 4096, 4096)
    seg = torch.arange(4, device=dev, dtype=torch.int32).repeat_interleave(1024).expand(2, 4096)
    for tag, extra, fn in (
        ("pair", dict(pair=pair), lambda q, k, v, p: flash_attention(q, k, v, p, causal=True)),
        ("segments", {}, lambda q, k, v: flash_attention(q, k, v, causal=True,
                                                         segment_ids=(seg, seg))),
    ):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, *extra.values())]
        (o, g), counts = _exact_launches(f"12a flash_attention({tag})", counters, {
            f"flash_fwd_{tag}": 1, f"flash_bwd_dq_{tag}": 1, f"flash_bwd_dkv_{tag}": 1,
            "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}, grads_of(fn, leaves, do))
        check(all(bool(torch.isfinite(t).all()) for t in (o, *g)), f"12a {tag}: non-finite")
        check(len(g) == len(leaves) and g[-1].shape == leaves[-1].shape, f"12a {tag} grads")
        launches.update({n: c for n, c in counts.items() if c})
        del leaves, o, g
    del q, k, v, do, pair, seg
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_packed(counters, expected):
    """12b: Llama-3-8B at full width, 2 layers, B 1, L 4096, on one row of
    random documents (200-1800 tokens) packed by pack_tokens_segmented,
    positions reset per document: forward(segment_ids=, positions=), the
    mean next-token cross-entropy and its backward through the kernels
    with exact launches; every document's logits against the document
    run alone; every gradient leaf against plain=True."""
    from nnop_tpu_torch.models.llama import LlamaConfig, forward, init_params
    from nnop_tpu_torch.parallel.tp_llama import tree_leaves
    from nnop_tpu_torch.runtime.dataio import pack_tokens_segmented

    dev = torch.device("cuda")
    cfg = LlamaConfig.llama3_8b(n_layers=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = init_params(gen, cfg)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    rng = np.random.default_rng(SEED)
    docs = [rng.integers(1, cfg.vocab_size, rng.integers(200, 1801)).tolist() for _ in range(8)]
    rows, segs, poss = (torch.from_numpy(a[:1]).to(dev) for a in
                        pack_tokens_segmented(docs, seq_len=4096))
    toks, tgts, seg, pos = rows[:, :-1], rows[:, 1:], segs[:, :-1], poss[:, :-1]
    n_docs = int(seg.max())

    def step(plain=False):
        logits = forward(params, toks, cfg, positions=pos, segment_ids=seg, plain=plain)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.gather(logp, -1, tgts.long()[..., None]).mean()
        return logits.detach(), loss.item(), torch.autograd.grad(loss, leaves)

    torch.cuda.reset_peak_memory_stats()
    (logits, loss, k_grads), counts = _exact_launches("12b", counters, expected, step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    # every document inside the packed row against the document alone
    cos, errs = [], []
    with torch.no_grad():
        for d in range(1, n_docs + 1):
            idx = (seg[0] == d).nonzero()[:, 0]
            alone = forward(params, toks[:, idx], cfg, positions=pos[:, idx])
            cos.append(_cosine(logits[0, idx], alone[0]))
            errs.append(max_err(logits[0, idx], alone[0]))
    print(f"phase 12b packed: Llama-3-8B width, 2 layers, B 1, L 4096: {n_docs} documents "
          f"(lengths {[int((seg[0] == d).sum()) for d in range(1, n_docs + 1)]}), loss "
          f"{loss:.6f}; each document's logits against the document alone: cosine min "
          f"{min(cos):.6f} (>= {PACKED_COS}: {PACKED_WHY}), max abs error {max(errs):.4e}; "
          f"step (forward, loss, backward) median {statistics.median(times):.1f} ms of "
          f"{[round(t, 1) for t in times]}; peak {peak:.2f} GiB (max_memory_allocated)")
    check(min(cos) >= PACKED_COS, f"12b: a document's logits read cosine {min(cos)}")
    del logits
    _, p_loss, p_grads = step(plain=True)
    gcos = [_cosine(a, b) for a, b in zip(k_grads, p_grads)]
    worst = min(range(len(gcos)), key=gcos.__getitem__)
    print(f"phase 12b grads: loss kernels {loss:.6f} plain {p_loss:.6f}; {len(gcos)} gradient "
          f"leaves against plain=True, cosine min {min(gcos):.6f} (leaf {worst}) mean "
          f"{statistics.mean(gcos):.6f} (>= {GRAD_COS} each: {GRAD_WHY})")
    check(all(bool(torch.isfinite(g).all()) for g in k_grads), "12b: a non-finite gradient")
    check(min(gcos) >= GRAD_COS, f"12b: gradient leaf {worst}: cosine {gcos[worst]}")
    del params, leaves, k_grads, p_grads
    gc.collect()
    torch.cuda.empty_cache()
    return counts


class _PlainCalls:
    """Within the block, every plain version (`naive_*`) the kernel
    modules and the model can reach is replaced by a wrapper that counts
    its calls."""

    def __init__(self):
        import importlib

        self.calls, self.saved = {}, []
        for name in ("ops.naive", "ops.adamw", "ops.rms_norm", "ops.rope",
                     "ops.flash_attention", "ops.flash_attention_bwd", "ops.grouped_matmul",
                     "models.llama", "models.moe"):
            mod = importlib.import_module(f"nnop_tpu_torch.{name}")
            for attr in dir(mod):
                if attr.startswith("naive_") and callable(getattr(mod, attr)):
                    self.saved.append((mod, attr, getattr(mod, attr)))

    def __enter__(self):
        for mod, attr, fn in self.saved:
            def counted(*a, _fn=fn, _attr=attr, **kw):
                self.calls[_attr] = self.calls.get(_attr, 0) + 1
                return _fn(*a, **kw)
            setattr(mod, attr, counted)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def phase_train(tag, cfg, expected, counters, idle, seq=4096):
    """8b, 10b and 13b-c: cli.train_loop on `cfg` (full width, its depth
    cut), B=1, L=seq, the CLI's synthetic stream, AdamW at lr 1e-4 for 5
    steps, the last step under torch.profiler; `expected` launches per
    step. Returns the launch counts.

    The stream (7*i+3) % vocab has a period of vocab tokens; the script
    counts the (token, next token) pairs of a step's batch that occur in
    an earlier step's (for Llama-3-8B's 128256 none do): the per-step
    losses need not show learning, and they are reported, not checked.
    What the steps learned is checked on step 1's batch instead: its loss,
    evaluated again after the last step, must be below its loss at step 1."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from nnop_tpu_torch.cli import train_loop
    from nnop_tpu_torch.models.llama import init_params, loss_fn
    from nnop_tpu_torch.parallel.tp_llama import tree_leaves
    from nnop_tpu_torch.runtime.dataio import batches, pack_tokens

    steps = 5
    lr = 1e-4  # the CLI's default 1e-3 raises step 1's loss at width 4096 (PERF.md)
    dev = torch.device("cuda")
    rows = pack_tokens([[(7 * i + 3) % cfg.vocab_size for i in range(seq * 64)]], seq_len=seq)
    seen, repeats = set(), 0  # (token, next token) pairs that recur across the steps' batches
    for (toks, tgts), _ in zip(batches(rows, 1, seed=0), range(steps)):
        pairs = set(zip(toks[0].tolist(), tgts[0].tolist()))
        repeats += len(pairs & seen)
        seen |= pairs
    toks, tgts = (torch.from_numpy(a).to(dev) for a in next(batches(rows, 1, seed=0)))

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = init_params(gen, cfg)
    n_params = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ends, starts = [], []  # each step's end, and the next one's start after on_step's work
    per_step = []
    for c in (*counters, *idle):
        c.reset()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=steps - 1, warmup=0, active=1, repeat=1))

    def on_step(n, loss):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        per_step.append({c.name: c.read() for c in counters})
        prof.step()  # the profiler records the last step only
        starts.append(time.perf_counter())

    with _PlainCalls() as plain, prof:
        starts.append(time.perf_counter())
        params, state, losses = train_loop(cfg, params, rows, steps=steps, batch=1, lr=lr,
                                           device=dev, on_step=on_step,
                                           log=lambda s: print(f"{tag} {s}"))
    launches = {c.name: c.read() for c in (*counters, *idle)}
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        first_after = loss_fn(params, toks, tgts, cfg).item()
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{tag} train: {cfg.n_layers} layers ({n_params / 1e9:.3f} B parameters), B=1, "
          f"L={seq}, AdamW lr {lr:g}: losses per step {[round(x, 4) for x in losses]} "
          f"({repeats} of a step's (token, next token) pairs occur in an earlier step's batch); "
          f"step 1's batch after step {steps}: {first_after:.4f} (was {losses[0]:.4f})")
    check(all(np.isfinite(losses)) and np.isfinite(first_after), f"non-finite loss: {losses}")
    check(first_after < losses[0], f"step 1's batch: loss {first_after} after training, "
          f"{losses[0]} before")
    prev = dict.fromkeys(per_step[0], 0)
    for i, counts in enumerate(per_step):
        step = {k: counts[k] - prev[k] for k in counts}
        check(step == expected, f"step {i + 1} launches {step}, expected {expected}")
        prev = counts
    check(all(launches[c.name] == 0 for c in idle),
          f"a kernel off the training path launched: {launches}")
    check(not plain.calls, f"plain versions called on the card: {plain.calls}")
    step_ms = [1e3 * (b - a) for a, b in zip(starts, ends)]
    med = statistics.median(step_ms[1:-1])
    print(f"{tag} launches per step (all {steps} steps): {expected}; "
          f"none of {sorted(c.name for c in idle)}; no plain version called")
    print(f"{tag} time: step ms {[round(x, 1) for x in step_ms]} (step 1 includes the "
          f"first-call set-up, step {steps} runs under the profiler); median of steps "
          f"2-{steps - 1} {med:.1f} ms = {seq / (med / 1e3):.0f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} GiB "
          "(max_memory_allocated)")
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]  # the step's span, not a kernel
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{tag} profile: step {steps} {step_ms[-1]:.1f} ms wall (profiled); device busy "
          f"{busy:.1f} ms = {100 * busy / step_ms[-1]:.1f}% of it, {100 * busy / med:.1f}% of the "
          "median unprofiled step; kernels by device time:")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the twelve longest, and every attention kernel
    for e in ranked[:12] + [e for e in ranked[12:] if "flash_" in e.key]:
        print(f"{tag} profile:   {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d} calls "
              f" {e.key[:90]}")
    return launches


# Phase 13c's depth: Gemma-2-2B has 26 layers. At L 8192 its loss alone
# (f32 logits of 256000 columns, 8.4 GB a copy, with the final softcap
# and log_softmax kept for the backward) peaks at 41.0 GiB with 2 layers,
# and each layer adds 2.06 GiB (weights, gradients, AdamW moments and
# activations; NVIDIA H100 80GB HBM3, PERF.md): 18 layers peaked at 73.85
# GiB of the card's 79.2, 26 would need ~90. 16 layers (even, so windowed
# and global layers both run) leave ~9 GiB for the allocator's
# fragmentation, which differs from run to run
GEMMA2_TRAIN_LAYERS = 16


MOE_GRAD_COS = 0.9999
MOE_GRAD_REL = 1e-2
MOE_GRAD_WHY = ("one layer, the same routing on both sides (the router runs the same torch ops on "
                "the same h): only the bf16 roundings of each product's fp32 sums differ, by one "
                "bf16 ulp (2^-8 relative) in few elements; 1e-2 is ~2.5 ulps over a whole leaf")


def phase_moe_grads():
    """10a: one Mixtral MoE layer at full width (T 4096 tokens, bf16,
    moe_impl="grouped"): the gradients of h, w_router, w_gate, w_up and
    w_down and the aux term through the kernels against the plain
    versions on the card, and the grouped path against the einsum path
    (dropless: the same function)."""
    from nnop_tpu_torch.models.llama import LlamaConfig
    from nnop_tpu_torch.models.moe import init_moe_layer, moe_mlp

    dev = torch.device("cuda")
    cfg = LlamaConfig.mixtral_8x7b(n_layers=1, moe_impl="grouped")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def dense(shape):
        return (torch.randn(shape, generator=gen, device=dev) * shape[0] ** -0.5).to(
            torch.bfloat16)

    layer = {k: v.requires_grad_(True) for k, v in init_moe_layer(cfg, dense).items()}
    T = 4096
    h = torch.randn((T, cfg.dim), generator=gen, device=dev).to(torch.bfloat16).requires_grad_(
        True)
    t = torch.randn((T, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    names = ("h", "w_router", "w_gate", "w_up", "w_down")
    leaves = [h] + [layer[n] for n in names[1:]]
    act = torch.nn.functional.silu
    results = {}
    for path, kw in (("kernels", {}), ("plain", dict(plain=True)), ("einsum", dict(
            impl="einsum"))):
        out, aux = moe_mlp(layer, h, cfg, act=act, **kw)
        loss = (out.float() * t.float()).sum() + aux
        results[path] = (aux.detach(), torch.autograd.grad(loss, leaves))
        del out, aux, loss
        torch.cuda.empty_cache()
    (k_aux, k_g), (p_aux, p_g), (e_aux, e_g) = (results[p] for p in ("kernels", "plain",
                                                                      "einsum"))
    check(torch.equal(k_aux, p_aux), f"aux: kernels {k_aux.item()} plain {p_aux.item()}")

    def agree(a, b):
        return [(_cosine(x, y), ((x.float() - y.float()).norm() / y.float().norm()).item())
                for x, y in zip(a, b)]

    kp, ke = agree(k_g, p_g), agree(k_g, e_g)
    print(f"phase 10a grads: one Mixtral MoE layer, T={T}, bf16, grouped; aux {k_aux.item():.6f} "
          f"(plain {p_aux.item():.6f}: identical, einsum {e_aux.item():.6f}); kernels against "
          f"plain (cosine >= {MOE_GRAD_COS}, |g - plain| / |plain| <= {MOE_GRAD_REL:g}: "
          f"{MOE_GRAD_WHY}): " + ", ".join(f"{n} {c:.6f} / {r:.3e}" for n, (c, r) in
                                            zip(names, kp)))
    print("phase 10a grads: grouped (kernels) against einsum, information (cosine >= 0.99 "
          "required: the same function, the einsum path rounds the combine weights to bf16): "
          + ", ".join(f"{n} {c:.6f} / {r:.3e}" for n, (c, r) in zip(names, ke)))
    check(all(bool(torch.isfinite(g).all()) for g in k_g), "a non-finite gradient")
    for n, (c, r) in zip(names, kp):
        check(c >= MOE_GRAD_COS and r <= MOE_GRAD_REL, f"10a {n}: cosine {c}, relative {r}")
    for n, (c, _) in zip(names, ke):
        check(c >= 0.99, f"10a {n}: grouped against einsum cosine {c}")
    del layer, h, t, leaves, results, k_g, p_g, e_g
    gc.collect()
    torch.cuda.empty_cache()


def check_pages_free(eng, stats):
    """Phase 11b: after the drain every page is free again, each once,
    and no slot holds a page."""
    free = eng._free_pages
    check(len(set(free)) == len(free) == eng.n_pages,
          f"{len(set(free))} distinct free pages of {eng.n_pages} after the drain")
    check(all(not pages for pages in eng._slot_pages), "a slot still holds pages")
    print(f"phase 11b pages: all {eng.n_pages} pages of {eng.page_size} tokens free after the "
          "drain")


def _hf_tensors(params, cfg):
    """A dense params tree as HF names -> tensors: projections stored
    (out, in), Mistral's and Llama's norm names."""
    out = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"],
           "lm_head.weight": params["lm_head"].T.contiguous()}
    for i, layer in enumerate(params["layers"]):
        m = {"attn_norm": "input_layernorm", "mlp_norm": "post_attention_layernorm",
             "wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
        for ours, theirs in m.items():
            t = layer[ours]
            out[f"model.layers.{i}.{theirs}.weight"] = t.T.contiguous() if ours[0] == "w" else t
    return out


def phase_hf_path(cfg, prompts, dev):
    """Phase 11d: a dense Mistral-family `cfg` with random weights written
    as a local HF directory (config.json and two shards of cfg.dtype)
    inside the checkout, read back through config_from_hf and
    load_hf_llama onto `dev`; the greedy streams of the loaded weights
    must be identical to those of the same weights served directly."""
    import os
    import shutil
    import tempfile

    from nnop_tpu_torch.models.llama import init_params
    from nnop_tpu_torch.models.weights import config_from_hf, load_hf_llama, save_safetensors
    from nnop_tpu_torch.runtime.engine import Engine
    from nnop_tpu_torch.utils.build import BUILD_ROOT

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    params = init_params(gen, cfg)
    os.makedirs(BUILD_ROOT, exist_ok=True)
    path = tempfile.mkdtemp(prefix="hf_mistral_", dir=BUILD_ROOT)
    try:
        t0 = time.perf_counter()
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(dict(architectures=["MistralForCausalLM"], vocab_size=cfg.vocab_size,
                           hidden_size=cfg.dim, intermediate_size=cfg.hidden_dim,
                           num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
                           num_key_value_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                           max_position_embeddings=cfg.max_seq_len, rms_norm_eps=cfg.rms_eps,
                           rope_theta=cfg.rope_base, sliding_window=cfg.sliding_window,
                           tie_word_embeddings=False), f)
        tensors = _hf_tensors(params, cfg)
        names = sorted(tensors)
        for i, part in enumerate((names[::2], names[1::2])):
            save_safetensors(os.path.join(path, f"model-{i + 1:05d}-of-00002.safetensors"),
                             {n: tensors[n] for n in part})
        del tensors
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        t1 = time.perf_counter()
        cfg_hf = config_from_hf(path, dtype=cfg.dtype)
        check(cfg_hf == cfg, f"config_from_hf: {cfg_hf} != {cfg}")
        loaded = load_hf_llama(path, cfg_hf, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(path)
    same = all(torch.equal(a, b) for a, b in zip(_hf_tensors(params, cfg).values(),
                                                 _hf_tensors(loaded, cfg).values()))
    check(same and loaded.keys() == params.keys(), "load_hf_llama: the tree differs")
    print(f"phase 11d hf: wrote {size / 2**30:.2f} GiB (config.json + 2 shards of {cfg.dtype}, "
          f"{cfg.n_layers} layers) in {t1 - t0:.1f} s; config_from_hf gives the config; "
          f"load_hf_llama onto {dev} in {t2 - t1:.1f} s, every tensor bit-identical")
    streams = []
    for tree in (params, loaded):
        eng = Engine(tree, cfg_hf, max_batch=4, max_seq=8192)
        reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
        eng.run()
        check(all(r.done and len(r.out) == 32 for r in reqs), "phase 11d: a request did not finish")
        streams.append([r.out for r in reqs])
        del eng
    check(streams[0] == streams[1], "phase 11d: the --hf-path streams differ from the direct ones")
    print(f"phase 11d hf: greedy streams of the loaded weights identical to the direct ones "
          f"({len(prompts)} prompts of {[len(p) for p in prompts]} tokens x 32)")


SPEC_K, SPEC_NEW = 4, 64  # phase 14: drafts per verify step, tokens per request
NEAR_TIE_REL = 1e-2  # a near tie: within 1e-2 x max|logit| of the plain forward's logits
NEAR_TIE_WHY = ("a verify step's products run at M = B * T rows where plain decoding runs T steps at "
                "M = B, so the two paths round their bf16 activations in different places; the "
                "logits leave the lm_head product as bf16, so two tokens' logits differ by whole "
                "ulps (2^-7 of the power of two below |logit|: 0.03125 from 4 to 8) and tie exactly "
                "where they round alike")
WIDE_TIE_ULPS, WIDE_TIES_MAX = 4, 1  # the rare parting past a near tie: its outer limit, its count
WIDE_TIE_WHY = ("each path's logits differ from the plain forward's by ~0.6 ulp rms (cosine ~0.9998), "
                "so the gap of two tokens moves by ~1.2 ulps rms between the engines and a parting "
                "2 ulps apart happens now and then; a wrong token reads ~100 ulps below the top")


def _ulp(x):
    """One bf16 ulp at |x|."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


LOGPROB_STEPS, LOGPROB_RESID = 2, 2e-3  # phase 14e: see LOGPROB_WHY
LOGPROB_WHY = ("engine and plain forward each take an f32 log_softmax of bf16 logits, so engine - "
               "plain is whole bf16 steps of the token's logit less the lse's difference. The "
               "token's logit may move at most 2 steps (the rounding noise of two bf16 paths: "
               "~35% of positions move 1 step, ~2% 2), and what is left off that lattice at most "
               "2e-3. On an H100 80GB HBM3 at 700 W over phase 14's four prompts, twice each "
               "(scripts/torch_logprob_floor.py), the split-KV kernel D, the D before it and D's "
               "plain version moved it 2 steps at most and left 4.1e-4 at most; a bf16-rounded "
               "logprob leaves 1.3e-2 to 1.6e-2 (the control printed below)")
LOGPROB_OWN_TOL = 1e-5  # against log_softmax of the engine's own f32 first-token logits


def _bf16_order(x):
    """bf16 values as integers in their order (adjacent values 1 apart)."""
    i = x.bfloat16().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def logprob_lattice(lps, toks, logits):
    """Each engine logprob against log_softmax of the plain forward's f32
    logits (T, V) (bf16 values) at its token. Both sides take an f32
    log_softmax of bf16 logits, so engine - plain = (l_e - l_p) - (lse_e
    - lse_p): whole bf16 steps of the token's logit l, less the lse's
    difference. Returns |engine - plain|, the steps (l_p + that
    difference, rounded to bf16, is l_e where the lse's moved by less
    than half an ulp of l) and the residual off the bf16 lattice (the
    lse's difference), each (T,) f64."""
    dev = logits.device
    check(torch.equal(logits, logits.bfloat16().float()), "the plain logits are not bf16 values")
    idx = torch.tensor(toks, device=dev)[:, None]
    l_p = logits.gather(1, idx)[:, 0].double()
    diff = (torch.tensor(lps, dtype=torch.float64, device=dev)
            - torch.log_softmax(logits, -1).gather(1, idx)[:, 0].double())
    moved = l_p + diff
    l_e = moved.bfloat16().double()
    steps = (_bf16_order(l_e) - _bf16_order(l_p)).abs()
    return diff.abs(), steps, (moved - l_e).abs()


def span_prompts(rng, vocab, lens, span=64):
    """Prompts of `lens` tokens, each one `span`-token random run repeated,
    so that prompt lookup finds drafts in them."""
    out = []
    for n in lens:
        run = rng.integers(0, vocab, span).tolist()
        out.append((run * -(-n // span))[:n])
    return out


def first_verify_logits(params, cfg, engine_kw, prompts):
    """Each prompt's first verify step, outside any served run: the
    prompts admitted into a fresh Engine(spec_k=SPEC_K), then one verify
    step of make_spec_chunk(with_logits=True) on its state and history.
    Returns [(the prompt, its T input tokens, their logits (T, V) f32)]."""
    from nnop_tpu_torch.runtime.engine import Engine, make_spec_chunk

    eng = Engine(params, cfg, spec_k=SPEC_K, **engine_kw)
    reqs = [eng.submit(p, max_new_tokens=SPEC_NEW) for p in prompts]
    while eng.queue or eng._admitting:
        eng._admit()
    lens = eng.state.lengths.tolist()
    _, _, logits = make_spec_chunk(cfg, 1, SPEC_K, with_logits=True)(
        eng.params, eng.state, eng._history, eng._gen)
    T = SPEC_K + 1
    out = []
    for slot, req in enumerate(eng.slots):
        if req is not None:
            n = lens[slot]
            out.append((req.prompt, eng._history[slot, n:n + T].tolist(), logits[0, slot]))
    check(len(out) == len(reqs), f"{len(out)} of {len(reqs)} prompts admitted")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_cli_defaults(counters):
    """Phase 15a: `python -m nnop_tpu_torch.cli generate --prompt abcabc`
    and `cli train --steps 3` with every other argument at its default
    (the f32 `tiny` config, head dim 32, on cuda), run in this process
    through cli.main with the counts set to 0 just before: C, dQ and dK/dV
    on f32 operands rounded to bf16 at the op boundary, D at E 32 in its
    f32 mode, E's f32 flush. Checks 32 generated tokens and a finite loss
    at step 3, and that each of `counters` launched. Returns the counts."""
    import contextlib
    import io

    from nnop_tpu_torch import cli

    for c in counters:
        c.reset()
    out, t0 = io.StringIO(), time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["generate", "--prompt", "abcabc"])
        cli.main(["train", "--steps", "3"])
    torch.cuda.synchronize()
    launches = {c.name: c.read() for c in counters}
    text = out.getvalue()
    for line in text.strip().splitlines():
        print(f"phase 15a cli: {line}")
    toks = re.search(r"^\[0\] \[(.*)\]$", text, re.M)
    check(toks is not None and len(toks.group(1).split(",")) == 32,
          "phase 15a: cli generate did not give 32 tokens")
    loss = re.search(r"step 3: loss (\S+)", text)
    check(loss is not None and math.isfinite(float(loss.group(1))),
          "phase 15a: cli train gave no finite loss at step 3")
    print(f"phase 15a launches: {launches} ({time.perf_counter() - t0:.1f} s)")
    for c in counters:
        check(launches[c.name] > 0, f"kernel {c.name} was not launched by the CLI's defaults")
    return launches


def phase_spec(tag, params, cfg, engine_kw, prompts, verify, matmul=None):
    """Phase 14a-c: each prompt's first verify step's T rows of logits
    (first_verify_logits, outside the served runs) against forward(plain=
    True) on the prompt and the T input tokens (cosine >= 0.99); then the
    same prompts through EngineServer on the plain engine and on
    Engine(spec_k=SPEC_K) over `params`, SPEC_NEW tokens each, with no
    hook in the served runs. Checks: every answer's length and
    vocabulary; the streams identical, or parted where the plain
    forward's logits of the two tokens tie: within NEAR_TIE_REL of
    max|logit|, or past it at most WIDE_TIES_MAX times a phase and
    within WIDE_TIE_ULPS ulps; D's verify launches (`verify`, the Counter
    of the path's verify mode) equal to layers x verify steps dispatched
    and no T = 1 launch of D. Prints the partings by kind, the tokens
    per verify step and both engines' tokens/s. Returns {the verify
    entry: its launches}."""
    from nnop_tpu_torch.models.llama import forward
    from nnop_tpu_torch.ops.attention_decode import decode_attention
    from nnop_tpu_torch.ops.kv_write import flush_staging
    from nnop_tpu_torch.runtime.engine import Engine

    dev = torch.device("cuda")
    T, n_tok = SPEC_K + 1, len(prompts) * SPEC_NEW

    @torch.no_grad()
    def plain(toks):
        return forward(params, torch.tensor([toks], device=dev), cfg, plain=True,
                       matmul=matmul)[0].float()

    for prompt, toks, logits in first_verify_logits(params, cfg, engine_kw, prompts):
        L = len(prompt)
        ref = plain(prompt + toks)[L:L + T]
        cos = min(_cosine(logits[t], ref[t]) for t in range(T))
        print(f"phase {tag} verify logits: prompt of {L} tokens, first verify step's {T} rows "
              f"against forward(plain=True): min cosine {cos:.6f} (>= 0.99 required), argmax "
              f"{logits.argmax(-1).tolist()} plain {ref.argmax(-1).tolist()}")
        check(cos >= 0.99 and bool(torch.isfinite(logits).all()), f"phase {tag}: cosine {cos}")

    eng = Engine(params, cfg, **engine_kw)
    want, plain_wall, _ = _serve(eng, prompts, SPEC_NEW)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng = Engine(params, cfg, spec_k=SPEC_K, **engine_kw)
    t1 = Counter("decode_attention T = 1", decode_attention, mode=lambda *key: not key[-1])
    for c in (verify, t1):
        c.reset()
    flushes = flush_staging.launches
    got, wall, stats = _serve(eng, prompts, SPEC_NEW)
    n_verify, n_t1 = verify.read(), t1.read()
    # each verify step dispatched ends with one flush of the staging (the
    # engine's only flush: admission writes the cache directly); each
    # dispatched chunk runs chunk_size of them
    steps = flush_staging.launches - flushes
    print(f"phase {tag} serve: {len(prompts)} requests (prompts of {[len(p) for p in prompts]} "
          f"tokens, repeated 64-token runs) x {SPEC_NEW} new, Engine({engine_kw}, spec_k={SPEC_K}) "
          f"through EngineServer; {n_tok} tokens in {wall:.2f} s wall = {n_tok / wall:.1f} tok/s, "
          f"the plain engine {plain_wall:.2f} s = {n_tok / plain_wall:.1f} tok/s (wall with the "
          f"prefill; observations, not claims); stats {stats}")
    print(f"phase {tag} acceptance: {eng.spec_emitted} tokens over {eng.spec_verify_slots} "
          f"metered verify steps = {eng.spec_emitted / eng.spec_verify_slots:.3f} tokens per "
          f"verify step; {steps // eng.chunk_size} chunks of {eng.chunk_size} verify steps "
          "dispatched")
    print(f"phase {tag} launches: D verify {n_verify} (= {cfg.n_layers} layers x {steps} verify "
          f"steps, counted by E's flushes, required), D T = 1 {n_t1} (0 required)")
    check(n_verify == cfg.n_layers * steps and steps % eng.chunk_size == 0 and steps > 0,
          f"phase {tag}: {n_verify} verify launches over {steps} flushes, not {cfg.n_layers} "
          "layers x the verify steps of whole chunks")
    check(n_t1 == 0, f"phase {tag}: {n_t1} launches of D at T = 1 during spec decoding")
    kinds = {"identical": 0, "an exact tie": 0, "a near tie": 0, "a wide tie": 0}
    for prompt, g, w in zip(prompts, got, want):
        g, w = g["tokens"], w["tokens"]
        check(len(g) == SPEC_NEW and all(0 <= t < cfg.vocab_size for t in g),
              f"phase {tag}: {len(g)} tokens, or a token out of range")
        part = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if part is None:
            kinds["identical"] += 1
            print(f"phase {tag} streams: prompt of {len(prompt)} tokens: spec identical to plain "
                  f"over {SPEC_NEW} tokens")
            continue
        lg = plain(prompt + w[:part])[-1]
        top = lg.abs().max().item()
        gap, near, wide = (abs(lg[w[part]] - lg[g[part]]).item(), NEAR_TIE_REL * top,
                           WIDE_TIE_ULPS * _ulp(top))
        kind = "an exact tie" if gap == 0 else "a near tie" if gap <= near else "a wide tie"
        kinds[kind] += 1
        print(f"phase {tag} streams: prompt of {len(prompt)} tokens: parted at token {part} "
              f"(plain {w[part]}, spec {g[part]}) at {kind}: the plain forward's logits there "
              f"differ by {gap:.4f} = {gap / _ulp(top):.2f} bf16 ulps at max|logit| {top:.4f} "
              f"(near tie <= {near:.4f}; wide <= {wide:.4f})")
        check(gap <= wide, f"phase {tag}: the streams part at token {part}, {gap} apart: no tie")
    print(f"phase {tag} partings: {kinds} over {len(prompts)} streams (a near tie is within "
          f"{NEAR_TIE_REL:g} x max|logit|: {NEAR_TIE_WHY}; at most {WIDE_TIES_MAX} wide tie a "
          f"phase, within {WIDE_TIE_ULPS} ulps: {WIDE_TIE_WHY})")
    check(kinds["a wide tie"] <= WIDE_TIES_MAX, f"phase {tag}: {kinds['a wide tie']} wide ties")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {verify.name: n_verify}


def phase_spec_sampled_and_logprobs(params, cfg, prompts, verify):
    """Phase 14d: one sampled spec request (temperature 0.8, top_p 0.9)
    runs to its length in the vocabulary; 14e: Engine(logprobs=True)
    through EngineServer's "logprobs" field, each value against
    log_softmax of forward(plain=True)'s f32 logits (logprob_lattice:
    LOGPROB_STEPS, LOGPROB_RESID; a bf16-rounded copy must fail it), the
    first against log_softmax of the engine's own f32 first-token logits
    (LOGPROB_OWN_TOL, below what a bf16 logprob would read), and the
    refusals of spec decoding with logprobs and with paged pools."""
    from nnop_tpu_torch.models.llama import forward
    from nnop_tpu_torch.runtime.engine import Engine

    dev = torch.device("cuda")
    eng = Engine(params, cfg, max_batch=8, max_seq=2048, spec_k=SPEC_K, temperature=0.8,
                 top_p=0.9, seed=SEED)
    verify.reset()
    req = eng.submit(prompts[0], max_new_tokens=SPEC_NEW)
    eng.run()
    check(req.done and len(req.out) == SPEC_NEW and all(0 <= t < cfg.vocab_size for t in req.out),
          f"phase 14d: {len(req.out)} tokens, or a token out of range")
    check(verify.read() > 0, "phase 14d: no verify launch")
    print(f"phase 14d sampled: temperature 0.8, top_p 0.9, spec_k {SPEC_K}: {len(req.out)} "
          f"tokens in the vocabulary, {eng.spec_emitted / eng.spec_verify_slots:.3f} tokens per "
          f"verify step, {verify.read()} verify launches")
    del eng
    gc.collect()
    eng = Engine(params, cfg, max_batch=8, max_seq=2048, logprobs=True)
    bodies, wall, _ = _serve(eng, prompts[:2], SPEC_NEW)
    steps_worst, resid_worst, own_worst, bf16_least = 0, 0.0, 0.0, math.inf
    control_least = math.inf
    for prompt, body in zip(prompts, bodies):
        toks, lps = body["tokens"], body["logprobs"]
        check(len(lps) == len(toks) == SPEC_NEW, f"phase 14e: {len(lps)} logprobs, "
              f"{len(toks)} tokens")
        with torch.no_grad():
            logits = forward(params, torch.tensor([prompt + toks[:-1]], device=dev), cfg,
                             plain=True)[0, len(prompt) - 1:].float()
            own = torch.log_softmax(first_logits(eng, prompt).float(), -1)
        diff, steps, resid = logprob_lattice(lps, toks, logits)
        # the control: each logprob rounded to bf16 (a bf16 log_softmax's output)
        _, _, c_resid = logprob_lattice(torch.tensor(lps).bfloat16().double().tolist(), toks,
                                        logits)
        steps_worst = max(steps_worst, int(steps.max()))
        resid_worst = max(resid_worst, resid.max().item())
        control_least = min(control_least, c_resid.max().item())
        # the first token's logprob against log_softmax of the engine's own
        # first-token logits: f32 reads ~0, a bf16-rounded logprob or a
        # bf16 log_softmax of the same logits reads its rounding
        own_diff = abs(lps[0] - own[toks[0]].item())
        bf16_diff = min(abs(own[toks[0]].bfloat16().item() - own[toks[0]].item()),
                        abs(torch.log_softmax(first_logits(eng, prompt).bfloat16(), -1)[
                            toks[0]].item() - own[toks[0]].item()))
        own_worst, bf16_least = max(own_worst, own_diff), min(bf16_least, bf16_diff)
        top = diff.topk(3)
        largest = ", ".join(f"{i}: {v:.3e}" for v, i in zip(top.values.tolist(),
                                                            top.indices.tolist()))
        print(f"phase 14e logprobs: prompt of {len(prompt)} tokens: {len(lps)} logprobs (first "
              f"{lps[0]:.4f}, plain {logits[0].log_softmax(-1)[toks[0]].item():.4f}); "
              f"|engine - plain| max {diff.max().item():.3e} mean {diff.mean().item():.3e} "
              f"(largest at positions {largest}); the token's logit moved 0/1/2/more bf16 steps at "
              f"{[int((steps == k).sum()) for k in (0, 1, 2)] + [int((steps > 2).sum())]} "
              f"positions (tol {LOGPROB_STEPS}), residual off the lattice max "
              f"{resid.max().item():.3e} (tol {LOGPROB_RESID:g}), the bf16-rounded control's "
              f"{c_resid.max().item():.3e} ({int((c_resid > LOGPROB_RESID).sum())} positions "
              f"over) ({LOGPROB_WHY}); the first against log_softmax of the engine's own f32 "
              f"logits {own_diff:.3e} (tol {LOGPROB_OWN_TOL:g}), a bf16 logprob there would read "
              f">= {bf16_diff:.3e}")
    check(steps_worst <= LOGPROB_STEPS and resid_worst <= LOGPROB_RESID,
          f"phase 14e: a token's logit moved {steps_worst} bf16 steps, or the logprobs leave "
          f"{resid_worst} off the lattice")
    check(control_least > LOGPROB_RESID,
          f"phase 14e: the check cannot tell a bf16-rounded logprob ({control_least})")
    check(own_worst <= LOGPROB_OWN_TOL < bf16_least,
          f"phase 14e: the first logprob {own_worst} from the engine's own f32 log_softmax, or "
          f"the check cannot tell a bf16 one ({bf16_least})")
    del eng
    gc.collect()
    for kw in (dict(spec_k=2, logprobs=True), dict(spec_k=2, paged=True)):
        try:
            Engine(params, cfg, max_batch=8, max_seq=2048, **kw)
        except ValueError as e:
            print(f"phase 14e refusal: Engine({kw}) raised ValueError: {e}")
        else:
            check(False, f"phase 14e: Engine({kw}) did not raise")
    torch.cuda.empty_cache()


def main():
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this needs an H100")
    # f32 references in full precision (plain versions upcast to f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nnop_tpu_torch.models.llama import LlamaConfig, init_params, init_quantized_params
    from nnop_tpu_torch.models.quantized import qmatmul, quantize_params
    from nnop_tpu_torch.ops.adamw import adamw_update_
    from nnop_tpu_torch.ops.attention_decode import decode_attention
    from nnop_tpu_torch.ops.attention_decode_paged import paged_decode_attention
    from nnop_tpu_torch.ops.flash_attention import flash_fwd
    from nnop_tpu_torch.ops.flash_attention_bwd import flash_bwd_dkv, flash_bwd_dq
    from nnop_tpu_torch.ops.grouped_matmul import (
        _grouped_matmul_q4,
        grouped_matmul,
        grouped_matmul_dw,
        grouped_matmul_quantized,
        grouped_matmul_w8a8,
    )
    from nnop_tpu_torch.ops.kv_write import flush_staging, flush_staging_paged, write_kv_token
    from nnop_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
    from nnop_tpu_torch.ops.quantized_matmul import (
        quantized_matmul,
        quantized_matmul4,
        quantized_matmul_w8a8,
    )
    from nnop_tpu_torch.ops.rms_norm import rms_norm, rms_norm_bwd, rms_norm_fwd
    from nnop_tpu_torch.ops.rope import llama_rope, llama_rope_bwd
    from nnop_tpu_torch.ops.softmax import softmax_bwd, softmax_fwd
    from nnop_tpu_torch.runtime.engine import fuse_decode_weights

    decode_src, flush_src = "nnop_tpu_torch/csrc/decode_attn.cuh", "nnop_tpu_torch/csrc/kv_flush.cu"
    qmm_src, qmm_rep = "nnop_tpu_torch/csrc/qmm.cu", "nnop_tpu/ops/quantized_matmul.py"
    paged_rep, flush_rep = "nnop_tpu/ops/attention_decode_paged.py:430", "nnop_tpu/ops/kv_write.py"
    gmm_src, gmm_rep = "nnop_tpu_torch/csrc/gmm.cu", "nnop_tpu/ops/grouped_matmul.py"
    flash_src, flash_rep = "nnop_tpu_torch/csrc/flash_fwd.cuh", "nnop_tpu/ops/flash_attention.py"
    decode_rep = "nnop_tpu/ops/attention_decode.py:753"
    bwd_src, bwd_rep = "nnop_tpu_torch/csrc/flash_bwd.cuh", "nnop_tpu/ops/flash_attention_bwd.py"
    # entry name -> (counter, route, source, the TPU kernel it replaces);
    # a bf16 entry of a kernel with an int8 mode counts the bf16 launches
    entries = {
        "rms_norm": (Counter("rms_norm", rms_norm), "triton", "nnop_tpu_torch/ops/rms_norm.py",
                     "nnop_tpu/ops/rms_norm.py:120"),
        "llama_rope": (Counter("llama_rope", llama_rope), "triton", "nnop_tpu_torch/ops/rope.py",
                       "nnop_tpu/ops/rope.py:102"),
        "flash_fwd": (Counter("flash_fwd", flash_fwd), "cuda", "nnop_tpu_torch/csrc/flash_fwd.cuh",
                      "nnop_tpu/ops/flash_attention.py:1309"),
        "decode_attention": (Counter("decode_attention", decode_attention, minus="int8_launches"),
                             "cuda", decode_src, "nnop_tpu/ops/attention_decode.py:753"),
        "flush_staging": (Counter("flush_staging", flush_staging, minus="int8_launches"), "cuda",
                          flush_src, f"{flush_rep}:266"),
        "decode_attention_int8": (Counter("decode_attention_int8", decode_attention,
                                          "int8_launches"), "cuda", decode_src,
                                  "nnop_tpu/ops/attention_decode.py:753"),
        "flush_staging_int8": (Counter("flush_staging_int8", flush_staging, "int8_launches"),
                               "cuda", flush_src, f"{flush_rep}:266"),
        "quantized_matmul": (Counter("quantized_matmul", quantized_matmul), "cuda", qmm_src,
                             f"{qmm_rep}:108"),
        "quantized_matmul_w8a8": (Counter("quantized_matmul_w8a8", quantized_matmul_w8a8),
                                  "cuda", qmm_src, f"{qmm_rep}:256"),
        "quantized_matmul4": (Counter("quantized_matmul4", quantized_matmul4), "cuda", qmm_src,
                              f"{qmm_rep}:383"),
        "paged_decode_attention": (Counter("paged_decode_attention", paged_decode_attention,
                                           minus="int8_launches"), "cuda", decode_src, paged_rep),
        "paged_decode_attention_int8": (Counter("paged_decode_attention_int8",
                                                paged_decode_attention, "int8_launches"), "cuda",
                                        decode_src, paged_rep),
        "flush_staging_paged": (Counter("flush_staging_paged", flush_staging_paged,
                                        minus="int8_launches"), "cuda", flush_src,
                                f"{flush_rep}:529"),
        "flush_staging_paged_int8": (Counter("flush_staging_paged_int8", flush_staging_paged,
                                             "int8_launches"), "cuda", flush_src,
                                     f"{flush_rep}:529"),
        "write_kv_token": (Counter("write_kv_token", write_kv_token), "cuda", flush_src,
                           f"{flush_rep}:85"),
        "adamw_update": (Counter("adamw_update", adamw_update_), "triton",
                         "nnop_tpu_torch/ops/adamw.py",
                         "nnop_tpu/parallel/tp_llama.py:264 (AdamW.update; XLA, no Pallas kernel)"),
        "rms_norm_rstd": (Counter("rms_norm_rstd", rms_norm_fwd), "triton",
                          "nnop_tpu_torch/ops/rms_norm.py", "nnop_tpu/ops/rms_norm.py:120"),
        "rms_norm_bwd": (Counter("rms_norm_bwd", rms_norm_bwd), "triton",
                         "nnop_tpu_torch/ops/rms_norm.py", "nnop_tpu/ops/rms_norm.py:145"),
        "llama_rope_bwd": (Counter("llama_rope_bwd", llama_rope_bwd), "triton",
                           "nnop_tpu_torch/ops/rope.py", "nnop_tpu/ops/rope.py:102"),
        "flash_bwd_dq": (Counter("flash_bwd_dq", flash_bwd_dq), "cuda", bwd_src,
                         f"{bwd_rep}:678"),
        "flash_bwd_dkv": (Counter("flash_bwd_dkv", flash_bwd_dkv), "cuda", bwd_src,
                          f"{bwd_rep}:724"),
        "grouped_matmul": (Counter("grouped_matmul", grouped_matmul, minus="dx_launches"),
                           "cuda", gmm_src, f"{gmm_rep}:111"),
        "grouped_matmul_dx": (Counter("grouped_matmul_dx", grouped_matmul, "dx_launches"), "cuda",
                              gmm_src, f"{gmm_rep}:111"),
        "grouped_matmul_dw": (Counter("grouped_matmul_dw", grouped_matmul_dw), "cuda",
                              "nnop_tpu_torch/csrc/gmm_dw.cu", f"{gmm_rep}:177"),
        "grouped_matmul_quantized": (Counter("grouped_matmul_quantized",
                                             grouped_matmul_quantized), "cuda", gmm_src,
                                     f"{gmm_rep}:323"),
        "grouped_matmul_w8a8": (Counter("grouped_matmul_w8a8", grouped_matmul_w8a8), "cuda",
                                gmm_src, f"{gmm_rep}:425"),
        "grouped_matmul4": (Counter("grouped_matmul4", _grouped_matmul_q4), "cuda", gmm_src,
                            f"{gmm_rep}:524"),
        # the families' modes, each counted by its own (head dim, flags) in
        # the phases that run it: 11a (linear bf16, E 128), 11b (paged
        # int8, E 128), 11c (linear bf16, E 256); the modes no serving
        # phase runs read 0
        "flash_fwd_window": (Counter("flash_fwd_window", flash_fwd, mode=lambda E, win, cap:
                                     E == 128 and win and not cap), "cuda", flash_src,
                             f"{flash_rep}:833"),
        "flash_fwd_e256_softcap": (Counter("flash_fwd_e256_softcap", flash_fwd,
                                           mode=lambda E, win, cap: E == 256 and cap), "cuda",
                                   flash_src, f"{flash_rep}:1309"),
        **{f"{pre}_{kind}{sfx}": (Counter(f"{pre}_{kind}{sfx}", fn, mode=functools.partial(
            _decode_mode, 128 if kind == "window" else 256, bool(sfx))), "cuda", decode_src, rep)
           for pre, fn, rep in (("decode_attention", decode_attention, decode_rep),
                                ("paged_decode_attention", paged_decode_attention, paged_rep))
           for kind in ("window", "e256") for sfx in ("", "_int8")},
        # the speculative-verify mode of D (T > 1; phase 14): 8B bf16 (14a),
        # int8 (14b), Mistral's window (no phase serves it with spec_k),
        # Gemma-2's head dim 256 with the softcap (14c)
        **{f"decode_attention_verify{sfx}": (Counter(f"decode_attention_verify{sfx}",
                                                      decode_attention, mode=mode), "cuda",
                                              decode_src, decode_rep)
           for sfx, mode in (
               ("", lambda E, q8, win, cap, v: v and E == 128 and not q8 and not win),
               ("_int8", lambda E, q8, win, cap, v: v and E == 128 and q8),
               ("_window", lambda E, q8, win, cap, v: v and E == 128 and win and not q8),
               ("_e256", lambda E, q8, win, cap, v: v and E == 256))},
        # head dims 64 and 32: TinyLlama-1.1B's widths served (15b)
        # and verified (15c), the CLI's f32 `tiny` (15a); the int8 and paged
        # modes at E 64 run in phase 3 only
        **{name: (Counter(name, fn, mode=mode), "cuda", decode_src, rep)
           for name, fn, rep, mode in (
               ("decode_attention_e64", decode_attention, decode_rep,
                lambda E, q8, win, cap, v: E == 64 and not q8 and not v),
               ("decode_attention_e64_int8", decode_attention, decode_rep,
                lambda E, q8, win, cap, v: E == 64 and q8 and not v),
               ("paged_decode_attention_e64", paged_decode_attention, paged_rep,
                lambda E, q8, win, cap, v: E == 64 and not q8),
               ("decode_attention_verify_e64", decode_attention, decode_rep,
                lambda E, q8, win, cap, v: v and E == 64),
               ("decode_attention_e32_f32", decode_attention, decode_rep,
                lambda E, q8, win, cap, v: E == 32 and not q8 and not v))},
        "flush_staging_e256": (Counter("flush_staging_e256", flush_staging,
                                       mode=lambda E, q8: E == 256 and not q8), "cuda", flush_src,
                               f"{flush_rep}:266"),
        # the op set (phase 12): the row kernels, and the pair and segment
        # modes of C, dQ and dK/dV, each counted by its own mode's count
        "online_softmax": (Counter("online_softmax", softmax_fwd), "triton",
                           "nnop_tpu_torch/ops/softmax.py", "nnop_tpu/ops/softmax.py:74"),
        "online_softmax_bwd": (Counter("online_softmax_bwd", softmax_bwd), "triton",
                               "nnop_tpu_torch/ops/softmax.py", "nnop_tpu/ops/softmax.py:90"),
        "layer_norm": (Counter("layer_norm", layer_norm_fwd), "triton",
                       "nnop_tpu_torch/ops/layer_norm.py", "nnop_tpu/ops/layer_norm.py:109"),
        "layer_norm_bwd": (Counter("layer_norm_bwd", layer_norm_bwd), "triton",
                           "nnop_tpu_torch/ops/layer_norm.py", "nnop_tpu/ops/layer_norm.py:138"),
        **{f"{name}_{kind}": (Counter(f"{name}_{kind}", fn, attr), "cuda", src, rep)
           for kind, attr in (("pair", "pair_launches"), ("segments", "segment_launches"))
           for name, fn, src, rep in (
               ("flash_fwd", flash_fwd, flash_src, f"{flash_rep}:1309"),
               ("flash_bwd_dq", flash_bwd_dq, bwd_src, f"{bwd_rep}:678"),
               ("flash_bwd_dkv", flash_bwd_dkv, bwd_src, f"{bwd_rep}:724"))},
        # the families' training modes of dQ and dK/dV (phase 13): Mistral's
        # window at head dim 128 and Gemma-2's softcap at head dim 256, each
        # counted by its own (head dim, flags)
        **{f"{name}_{kind}": (Counter(f"{name}_{kind}", fn, mode=mode), "cuda", bwd_src, rep)
           for kind, mode in (("window", lambda E, win, cap: E == 128 and win and not cap),
                              ("e256_softcap", lambda E, win, cap: E == 256 and cap))
           for name, fn, rep in (("flash_bwd_dq", flash_bwd_dq, f"{bwd_rep}:1223"),
                                 ("flash_bwd_dkv", flash_bwd_dkv, f"{bwd_rep}:1324"))},
    }
    seconds, t_start = {}, [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        seconds[name] = round(now - t_start[0], 1)
        t_start[0] = now

    phase_device()
    phase_build()
    done("1-2")
    measured = phase_kernels()
    torch.cuda.empty_cache()
    done("3")

    dev = torch.device("cuda")
    cfg = LlamaConfig.llama3_8b()
    launches = dict.fromkeys(entries, 0)

    def record(counts):
        """Each kernel's launches from the first phase that launched it (a
        phase reads 0 for a kernel off its path)."""
        launches.update({k: v for k, v in counts.items() if not launches.get(k)})

    def counters(*names):
        return [entries[n][0] for n in names]

    def features(*ops, attrs=("window_launches",)):
        """Counters of C's and D's features (window_launches,
        softcap_launches), whatever the mode, read around a phase."""
        return [Counter(f"{op.__name__}.{attr}", op, attr) for op in ops for attr in attrs]

    # phases 4-6: 4 (or 2) prompts, one through chunked admission (1100
    # tokens: 3 chunks of 512), on Engine(max_batch=8, max_seq=2048)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (150, 280, 400, 1100)]
    linear = dict(max_batch=8, max_seq=2048)

    # 4. bf16 weights, bf16 cache
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = init_params(gen, cfg)
    launches.update(serve_and_check("phase 4", params, cfg, counters(
        "rms_norm", "llama_rope", "flash_fwd", "decode_attention", "flush_staging"), linear,
        prompts, [(1, 0), (3, 0)]))
    done("4")
    # 14a, d, e on phase 4's weights: speculative decoding (prompts of
    #     repeated 64-token runs), a sampled spec request, logprobs
    spec_rng = np.random.default_rng(SEED + 14)  # leaves the other phases' prompts as they were
    spec_prompts = span_prompts(spec_rng, cfg.vocab_size, (200, 450, 700, 1100))
    record(phase_spec("14a", params, cfg, linear, spec_prompts,
                      entries["decode_attention_verify"][0]))
    phase_spec_sampled_and_logprobs(params, cfg, spec_prompts, entries[
        "decode_attention_verify"][0])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    done("14a, d, e")

    # 5. int8 weights (W8A8 prefill, weight-only decode), int8 cache
    gen.manual_seed(SEED)
    params = init_quantized_params(gen, cfg, wbits=8)
    head = params["lm_head"]

    def w8a8_plain(x, w):  # the engine's routing: W8A8 for >= 256 rows, not the lm_head
        return qmatmul(x, w, plain=True, w8a8=w is not head)

    counts = serve_and_check("phase 5", params, cfg, counters(
        "rms_norm", "llama_rope", "flash_fwd", "decode_attention_int8", "flush_staging_int8",
        "quantized_matmul", "quantized_matmul_w8a8"),
        dict(linear, quantized_kv=True, w8a8=True), prompts, [(1, 0), (3, 0)],
        matmul=w8a8_plain)
    record(counts)
    done("5")
    # 14b: speculative decoding on phase 5's weights and the int8 cache;
    #      the verify step's products (M = B * T < 256 rows) are weight-only
    record(phase_spec("14b", params, cfg, dict(linear, quantized_kv=True, w8a8=True),
                      spec_prompts, entries["decode_attention_verify_int8"][0],
                      matmul=functools.partial(qmatmul, plain=True)))
    done("14b")

    # 7. the paged deployment (scripts/bench_engine.py --paged) on the same
    #    int8 weights: 32 requests of 512 tokens; requests 16-31 repeat the
    #    first 384 tokens (3 pages of 128) of requests 0-15
    fresh = [rng.integers(0, cfg.vocab_size, 512).tolist() for _ in range(16)]
    paged_prompts = fresh + [p[:384] + rng.integers(0, cfg.vocab_size, 128).tolist()
                             for p in fresh]
    paged_kw = dict(max_batch=32, max_seq=648, chunk_size=16, quantized_kv=True, paged=True,
                    prefix_cache=True)
    counts = serve_and_check("phase 7", params, cfg, counters(
        "rms_norm", "llama_rope", "flash_fwd", "paged_decode_attention_int8",
        "flush_staging_paged_int8", "quantized_matmul", "quantized_matmul_w8a8"), paged_kw,
        paged_prompts, [(0, 0), (16, 384)], matmul=w8a8_plain,
        idle=counters("decode_attention", "decode_attention_int8", "flush_staging",
                      "flush_staging_int8", "paged_decode_attention", "flush_staging_paged",
                      "write_kv_token"),
        after=check_pages)
    record(counts)
    del params, head
    gc.collect()
    torch.cuda.empty_cache()
    done("7")

    # 6. int4 weights, int8 cache: the 280- and 1100-token prompts
    gen.manual_seed(SEED)
    params = init_quantized_params(gen, cfg, wbits=4)
    counts = serve_and_check("phase 6", params, cfg, counters(
        "rms_norm", "llama_rope", "flash_fwd", "decode_attention_int8", "flush_staging_int8",
        "quantized_matmul4"), dict(linear, quantized_kv=True), prompts[1::2], [(0, 0), (1, 0)],
        matmul=functools.partial(qmatmul, plain=True))
    record(counts)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    done("6")

    # 9. Mixtral-8x7B at full width: phase 4's prompt lengths from its
    #    vocabulary of 32000; the engine's fused tree built in place, so no
    #    unfused copy of the experts is held
    mix_prompts = [rng.integers(0, 32000, n).tolist() for n in (150, 280, 400, 1100)]
    moe_counters = ("rms_norm", "llama_rope", "flash_fwd")
    # 9a. full depth, int8 projections and experts, W8A8 prefill, int8 cache
    mcfg = LlamaConfig.mixtral_8x7b()
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    params = fuse_decode_weights(init_quantized_params(gen, mcfg, wbits=8), in_place=True)
    head = params["lm_head"]
    print(f"phase 9a setup: Mixtral-8x7B, {mcfg.n_layers} layers, int8 weights (experts "
          f"(8, 4096, 28672) | (8, 14336, 4096), per-(E, N) scales): "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    counts = serve_and_check("phase 9a", params, mcfg, counters(
        *moe_counters, "decode_attention_int8", "flush_staging_int8", "quantized_matmul",
        "quantized_matmul_w8a8", "grouped_matmul_quantized", "grouped_matmul_w8a8"),
        dict(linear, quantized_kv=True, w8a8=True), mix_prompts, [(1, 0), (3, 0)],
        matmul=lambda x, w: qmatmul(x, w, plain=True, w8a8=w is not head),
        forward_kw=dict(w8a8=True))
    record(counts)
    print(f"phase 9a memory: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} GiB "
          "(max_memory_allocated)")
    del params, head
    gc.collect()
    torch.cuda.empty_cache()
    done("9a")

    # 9b. 12 layers (93 GB of bf16 weights at full depth do not fit), bf16
    #     weights and cache; then the same weights as int4 with the int8 cache
    mcfg = LlamaConfig.mixtral_8x7b(n_layers=12)
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    params = fuse_decode_weights(init_params(gen, mcfg), in_place=True)
    counts = serve_and_check("phase 9b", params, mcfg, counters(
        *moe_counters, "decode_attention", "flush_staging", "grouped_matmul"), linear,
        mix_prompts, [(1, 0), (3, 0)])
    record(counts)
    params = quantize_params(params, wbits=4)
    gc.collect()
    torch.cuda.empty_cache()
    counts = serve_and_check("phase 9b int4", params, mcfg, counters(
        *moe_counters, "decode_attention_int8", "flush_staging_int8", "quantized_matmul4",
        "grouped_matmul4"), dict(linear, quantized_kv=True), mix_prompts[1::2],
        [(0, 0), (1, 0)], matmul=functools.partial(qmatmul, plain=True))
    record(counts)
    print(f"phase 9b memory: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          "(max_memory_allocated)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    done("9b")

    # 8. training, on the memory the serving phases freed
    phase_grad_parity("8a", "Llama-3-8B", LlamaConfig.llama3_8b(n_layers=2), 2048)
    counts = phase_train("phase 8b", LlamaConfig.llama3_8b(n_layers=8), TRAIN_LAUNCHES_PER_STEP,
                         counters(*TRAIN_LAUNCHES_PER_STEP),
                         [c for name, (c, *_) in entries.items()
                          if name not in TRAIN_LAUNCHES_PER_STEP])
    record(counts)
    done("8")

    # 10. MoE training: one Mixtral layer's gradients, then a 2-layer
    #     Mixtral at full width through the grouped path
    phase_moe_grads()
    counts = phase_train("phase 10b", LlamaConfig.mixtral_8x7b(n_layers=2, moe_impl="grouped"),
                         MOE_TRAIN_LAUNCHES_PER_STEP, counters(*MOE_TRAIN_LAUNCHES_PER_STEP),
                         [c for name, (c, *_) in entries.items()
                          if name not in MOE_TRAIN_LAUNCHES_PER_STEP])
    record(counts)
    done("10")

    # 11. the families at full width and full depth, greedy, random bf16
    #     weights: prompts of 300, 4600 and 6200 tokens (two through chunked
    #     admission past the window, two decoding past it), 32 new each
    fam_lens, fam_linear = (300, 4600, 6200), dict(max_batch=4, max_seq=8192)
    # 11a. Mistral-7B (window 4096 on every layer), linear bf16 cache
    mcfg = LlamaConfig.mistral_7b()
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(gen, mcfg)
    m_prompts = [rng.integers(0, mcfg.vocab_size, n).tolist() for n in fam_lens]
    counts = serve_and_check("phase 11a", params, mcfg, counters(
        "rms_norm", "llama_rope", "flash_fwd", "flash_fwd_window", "decode_attention",
        "decode_attention_window", "flush_staging") + features(flash_fwd, decode_attention),
        fam_linear, m_prompts, [(0, 0), (1, 0), (2, 0)])
    record(counts)
    print(f"phase 11a memory: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          "(max_memory_allocated)")
    gc.collect()  # the 11a engine and its cache
    torch.cuda.empty_cache()
    done("11a")
    # 11b. the same weights paged, int8 cache: the two long prompts
    torch.cuda.reset_peak_memory_stats()
    counts = serve_and_check("phase 11b", params, mcfg, counters(
        "flash_fwd_window", "paged_decode_attention_int8", "paged_decode_attention_window_int8",
        "flush_staging_paged_int8") + features(flash_fwd, paged_decode_attention),
        dict(fam_linear, paged=True, quantized_kv=True),
        m_prompts[1:], [(0, 0), (1, 0)],
        idle=counters("decode_attention", "decode_attention_int8", "flush_staging",
                      "flush_staging_int8"), after=check_pages_free)
    record(counts)
    print(f"phase 11b memory: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          "(max_memory_allocated)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    done("11b")
    # 11c. Gemma-2-2B (head dim 256, window 4096 on every other layer,
    #      softcaps 50 and 30, post norms, GeGLU, tied 256000-row embedding)
    gcfg = LlamaConfig.gemma2_2b()
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(gen, gcfg)
    g_prompts = [rng.integers(0, gcfg.vocab_size, n).tolist() for n in fam_lens]
    counts = serve_and_check("phase 11c", params, gcfg, counters(
        "rms_norm", "llama_rope", "flash_fwd_e256_softcap", "decode_attention_e256",
        "flush_staging_e256") + features(flash_fwd, decode_attention,
                                         attrs=("window_launches", "softcap_launches")),
        fam_linear, g_prompts, [(0, 0), (1, 0), (2, 0)],
        idle=counters("flash_fwd_window", "decode_attention_window"))
    record(counts)
    print(f"phase 11c memory: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          "(max_memory_allocated)")
    done("11c")
    # 14c: speculative decoding on 11c's weights, prompts of its lengths
    record(phase_spec("14c", params, gcfg, fam_linear,
                      span_prompts(spec_rng, gcfg.vocab_size, fam_lens),
                      entries["decode_attention_verify_e256"][0]))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    done("14c")
    # 11d. --hf-path: a 2-layer Mistral-7B directory, loaded and served
    phase_hf_path(LlamaConfig.mistral_7b(n_layers=2, max_seq_len=32768), m_prompts[:2], dev)
    gc.collect()
    torch.cuda.empty_cache()
    done("11d")

    # 12. the op set through torch.autograd as a user calls it (12a), then
    #     packed-document training of a 2-layer Llama-3-8B (12b)
    every = [c for c, *_ in entries.values()]
    record({n: v for n, v in phase_opset_autograd(every).items() if "segments" not in n})
    record(phase_packed(every, dict(train_launches(2, adamw=False), flash_fwd_segments=2,
                                    flash_bwd_dq_segments=2, flash_bwd_dkv_segments=2)))
    done("12")

    # 13. the families trained: (a) gradients against the plain path at
    #     full width, 2 layers, L 4608 (the window binds past 4096); (b)
    #     Mistral-7B with 8 layers and (c) Gemma-2-2B with
    #     GEMMA2_TRAIN_LAYERS through cli.train_loop at L 8192
    for name, fcfg in (("Mistral-7B", LlamaConfig.mistral_7b(n_layers=2)),
                       ("Gemma-2-2B", LlamaConfig.gemma2_2b(n_layers=2))):
        phase_grad_parity("13a", name, fcfg, 4608)
    done("13a")
    for tag, fcfg in (("13b", LlamaConfig.mistral_7b(n_layers=8)),
                      ("13c", LlamaConfig.gemma2_2b(n_layers=GEMMA2_TRAIN_LAYERS))):
        expected = family_train_launches(fcfg)
        counts = phase_train(
            f"phase {tag}", fcfg, expected,
            counters(*(n for n in expected if n in entries)) + features(
                flash_fwd, flash_bwd_dq, flash_bwd_dkv,
                attrs=("window_launches", "softcap_launches")),
            [c for name, (c, *_) in entries.items() if name not in expected], seq=8192)
        record(counts)
        done(tag)

    # 15. the CLI's defaults on the card (f32 `tiny`, head dim 32), then a
    #     head-dim-64 model at TinyLlama-1.1B's published widths (random
    #     bf16 weights), served and verified speculatively
    record(phase_cli_defaults(counters("decode_attention_e32_f32", "flush_staging", "flash_fwd",
                                       "flash_bwd_dq", "flash_bwd_dkv", "adamw_update")))
    done("15a")
    tcfg = LlamaConfig(vocab_size=32000, dim=2048, n_layers=22, n_heads=32, n_kv_heads=4,
                       head_dim=64, hidden_dim=5632, rope_base=10000.0, max_seq_len=2048)
    gen.manual_seed(SEED)
    params = init_params(gen, tcfg)
    t_prompts = [rng.integers(0, tcfg.vocab_size, n).tolist() for n in (150, 280, 400, 1100)]
    record(serve_and_check("phase 15b", params, tcfg, counters(
        "rms_norm", "llama_rope", "flash_fwd", "decode_attention_e64", "flush_staging"), linear,
        t_prompts, [(0, 0), (3, 0)]))
    record(phase_spec("15c", params, tcfg, linear,
                      span_prompts(spec_rng, tcfg.vocab_size, (200, 450, 700, 1100)),
                      entries["decode_attention_verify_e64"][0]))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    done("15b-c")
    print(f"phase seconds: {seconds}; total {sum(seconds.values()):.1f}")

    line = {"kernels": [
        dict(name=name, route=route, source=src, replaces=rep, launches=launches[name],
             **measured[name])
        for name, (_, route, src, rep) in entries.items()
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
