"""Drive the port's Llama-3-8B serving path once on one H100.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure raises and exits
non-zero:
  1. device: require an sm_90 card; print its name and power limit.
  2. build: compile nnop_tpu_torch/csrc/*.cu from this checkout (nvcc).
  3. kernels: each of the five Hopper kernels on the card at the serving
     path's shapes (plus edge cases), held against its plain PyTorch
     version on the same inputs, with both timed by CUDA events.
  4. main path: Llama-3-8B at full width and depth (random bf16 weights
     from a seeded torch.Generator on the card) behind the port's
     EngineServer; 4 concurrent /v1/completions requests (one through
     chunked admission), launch counters, and the engine's first-token
     logits against models.llama.forward on the plain ops.
The second-to-last line is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import torch

BF16_TOL = 2e-2
BF16_TOL_WHY = ("bf16 output: one bf16 ulp is <= 1.6e-2 below magnitude 4, "
                "and both sides accumulate in fp32 in a different order")
SEED = 0


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


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


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
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"  ptxas: {line.strip()}")


def phase_kernels():
    """Returns {kernel name: {max_abs_err, ms, plain_ms}} at the main
    shape of each kernel, after checking every case."""
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

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    results = {}

    def report(name, case, err, tol, why, ms=None, plain_ms=None, main=False):
        timing = "" if ms is None else f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        print(f"phase 3 {name} [{case}]: max_abs_err {err:.3e} (tol {tol:g}: {why}){timing}")
        check(err <= tol, f"{name} [{case}] error {err} > {tol}")
        if main:
            results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # A. rms_norm: decode rows (8) and a prefill chunk (512), width 4096
    w = (0.5 + 0.1 * torch.randn(4096, generator=gen, device=dev)).to(bf)
    for rows, main in ((8, True), (512, False)):
        x = randn(rows, 4096)
        err = max_err(rms_norm(x, w, 1e-5), naive.naive_rms_norm(x, w, eps=1e-5))
        report("rms_norm", f"({rows}, 4096) bf16", err, BF16_TOL, BF16_TOL_WHY,
               device_ms(lambda: rms_norm(x, w, 1e-5)),
               device_ms(lambda: naive.naive_rms_norm(x, w, eps=1e-5)), main)

    # B. llama_rope: decode (8 slots at ragged positions) and a 512-row chunk
    rope = RotaryEmbedding(128, 500000.0)
    for (B, L, pos), main in (((8, 1, [[0], [1], [63], [64], [65], [300], [1100], [2100]]), True),
                              ((1, 512, [list(range(100, 612))]), False)):
        q, k = randn(B, 32, L, 128, scale=0.5), randn(B, 8, L, 128, scale=0.5)
        cos, sin = rope(torch.tensor(pos, device=dev))
        got, want = llama_rope(q, k, cos, sin), naive.naive_rope(q, k, cos, sin)
        err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        report("llama_rope", f"q ({B}, 32, {L}, 128) bf16", err, BF16_TOL, BF16_TOL_WHY,
               device_ms(lambda: llama_rope(q, k, cos, sin)),
               device_ms(lambda: naive.naive_rope(q, k, cos, sin)), main)

    # C. flash forward: chunked prefill (offset + kpad), bucketed causal,
    #    an offset that is not a tile multiple, a length that is not one
    scale = 128 ** -0.5
    for case, QL, KL, causal, offset, n_valid, main in (
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
        report("flash_fwd", case, err, BF16_TOL, BF16_TOL_WHY + " (o bf16, lse f32)",
               device_ms(lambda: flash_fwd(q, k, v, **kw)),
               device_ms(lambda: naive.naive_attention(q, k, v, **kw), n=5), main)

    # D/E share the engine's cache: (32, 8, 8, 2144, 128) bf16, staging
    # (8, 32, 8, 32, 128) bf16, ragged lengths with an empty slot
    NL, B, KH, S, W = 32, 8, 8, 2144, 32
    lengths = torch.tensor([0, 1, 63, 64, 65, 300, 1100, 2100], dtype=torch.int32, device=dev)
    k_cache, v_cache = randn(NL, B, KH, S, 128), randn(NL, B, KH, S, 128)
    k_stage, v_stage = randn(B, NL, KH, W, 128), randn(B, NL, KH, W, 128)

    # D. decode attention, T=1, layer 3, 5 staged rows
    q = randn(B, 32, 1, 128)
    dkw = dict(k_stage=k_stage, v_stage=v_stage, staged_n=5, layer=3)
    o = decode_attention(q, k_cache, v_cache, lengths, **dkw)
    o_ref = naive.naive_decode_attention(q, k_cache, v_cache, lengths, **dkw)
    check(o[0].abs().max().item() == 0.0, "decode: the empty slot must give zeros")
    report("decode_attention", "q (8, 32, 1, 128), lengths 0..2100, staged_n 5",
           max_err(o, o_ref), BF16_TOL, BF16_TOL_WHY,
           device_ms(lambda: decode_attention(q, k_cache, v_cache, lengths, **dkw)),
           device_ms(lambda: naive.naive_decode_attention(q, k_cache, v_cache, lengths, **dkw)),
           True)
    for n in (0, 32):
        o = decode_attention(q, k_cache, v_cache, lengths, **{**dkw, "staged_n": n})
        o_ref = naive.naive_decode_attention(q, k_cache, v_cache, lengths,
                                             **{**dkw, "staged_n": n})
        report("decode_attention", f"staged_n {n}", max_err(o, o_ref), BF16_TOL, BF16_TOL_WHY)

    # E. flush: bit-exact against the plain flush
    kc, vc = k_cache.clone(), v_cache.clone()
    flush_staging(kc, vc, None, None, k_stage, v_stage, lengths)
    naive.naive_flush_staging(k_cache, v_cache, k_stage, v_stage, lengths)
    err = max(max_err(kc, k_cache), max_err(vc, v_cache))
    check(torch.equal(kc, k_cache) and torch.equal(vc, v_cache), "flush is not bit-exact")
    report("flush_staging", "(8, 32, 8, 32, 128) -> (32, 8, 8, 2144, 128)", err, 0.0,
           "a copy: bit-exact",
           device_ms(lambda: flush_staging(kc, vc, None, None, k_stage, v_stage, lengths)),
           device_ms(lambda: naive.naive_flush_staging(k_cache, v_cache, k_stage, v_stage,
                                                       lengths), n=3),
           True)
    return results


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def phase_main_path(counters):
    import numpy as np

    from nnop_tpu_torch.models.llama import Llama, LlamaConfig, init_params
    from nnop_tpu_torch.runtime.engine import Engine
    from nnop_tpu_torch.runtime.server import EngineServer

    dev = torch.device("cuda")
    cfg = LlamaConfig.llama3_8b()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    model = Llama(cfg, init_params(gen, cfg))
    eng = Engine(model.params, cfg, max_batch=8, max_seq=2048)
    torch.cuda.synchronize()
    print(f"phase 4 setup: Llama-3-8B random bf16 weights + engine in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
          f"allocated; cache {tuple(eng.state.k.shape)}")

    rng = np.random.default_rng(SEED)
    lens = (150, 280, 400, 1100)  # the 1100-token prompt admits in 3 chunks of 512
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    max_tokens = 32

    for c in counters:
        c.launches = 0
    results = [None] * len(prompts)
    srv = EngineServer(eng, port=0).start()
    try:
        def call(i):
            results[i] = _post(srv.port, {"prompt": prompts[i], "max_tokens": max_tokens})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
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
    launches = {c.__name__: c.launches for c in counters}

    outs = []
    for n, res in zip(lens, results):
        check(res is not None, f"prompt {n}: no response")
        status, body = res
        toks = body["tokens"]
        check(status == 200, f"status {status}")
        check(len(toks) == max_tokens, f"prompt {n}: {len(toks)} tokens, expected {max_tokens}")
        check(all(0 <= t < cfg.vocab_size for t in toks), f"prompt {n}: token out of range")
        outs.append(toks)
    check(stats["requests_completed"] >= len(prompts), f"stats: {stats}")
    check(stats["tokens_generated"] >= len(prompts) * max_tokens, f"stats: {stats}")
    print(f"phase 4 serve: {len(prompts)} concurrent requests (prompts {lens}), "
          f"{len(prompts) * max_tokens} tokens in {wall:.2f} s wall = "
          f"{len(prompts) * max_tokens / wall:.1f} tok/s (observation, not a claim); "
          f"stats {stats}")
    print(f"phase 4 launches during serving: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    # the engine's first-token logits (its bucketed and chunked prefill,
    # on the kernels) against the plain-op forward on the card
    for n, prompt in ((280, prompts[1]), (1100, prompts[3])):
        ids = torch.tensor([prompt], device=dev)
        if n <= eng.prefill_chunk:
            padded = torch.tensor([prompt + [0] * (512 - n)], device=dev)
            got = eng._prefill(eng.params, padded)[0][0, n - 1]
        else:
            C, nl = eng.prefill_chunk, cfg.n_layers
            sbuf = -(-n // C) * C
            ks = torch.zeros((nl, 1, cfg.n_kv_heads, sbuf, cfg.head_dim), dtype=torch.bfloat16,
                             device=dev)
            vs = torch.zeros_like(ks)
            for ci in range(sbuf // C):
                chunk = prompt[ci * C:(ci + 1) * C]
                chunk = torch.tensor([chunk + [0] * (C - len(chunk))], device=dev)
                logits, ks, vs = eng._prefill_chunk_fn(eng.params, chunk, ks, vs, ci * C)
            got = logits[0, (n - 1) - (sbuf // C - 1) * C]
        want = model(ids, plain=True)[0, -1]
        cos = _cosine(got, want)
        print(f"phase 4 reference: prompt {n}: first-token logits cosine {cos:.6f} "
              f"(>= 0.99 required), argmax engine {int(got.argmax())} plain {int(want.argmax())}")
        check(cos >= 0.99, f"prompt {n}: cosine {cos}")
        check(bool(torch.isfinite(got).all()), "non-finite logits")

    toks, greedy = list(prompts[1]), []
    for _ in range(8):
        nxt = int(model(torch.tensor([toks], device=dev), plain=True)[0, -1].argmax())
        greedy.append(nxt)
        toks.append(nxt)
    agree = sum(a == b for a, b in zip(outs[1][:8], greedy))
    print(f"phase 4 greedy agreement with the plain forward over the first 8 tokens: "
          f"{agree}/8 (information only)")
    return launches


def main():
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this needs an H100")
    # f32 references in full precision (plain versions upcast to f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nnop_tpu_torch.ops.attention_decode import decode_attention
    from nnop_tpu_torch.ops.flash_attention import flash_fwd
    from nnop_tpu_torch.ops.kv_write import flush_staging
    from nnop_tpu_torch.ops.rms_norm import rms_norm
    from nnop_tpu_torch.ops.rope import llama_rope

    kernels = [
        (rms_norm, "triton", "nnop_tpu_torch/ops/rms_norm.py", "nnop_tpu/ops/rms_norm.py:120"),
        (llama_rope, "triton", "nnop_tpu_torch/ops/rope.py", "nnop_tpu/ops/rope.py:102"),
        (flash_fwd, "cuda", "nnop_tpu_torch/csrc/flash_fwd.cu",
         "nnop_tpu/ops/flash_attention.py:1309"),
        (decode_attention, "cuda", "nnop_tpu_torch/csrc/decode_attn.cu",
         "nnop_tpu/ops/attention_decode.py:753"),
        (flush_staging, "cuda", "nnop_tpu_torch/csrc/kv_flush.cu",
         "nnop_tpu/ops/kv_write.py:266"),
    ]
    phase_device()
    phase_build()
    measured = phase_kernels()
    torch.cuda.empty_cache()
    launches = phase_main_path([fn for fn, *_ in kernels])
    line = {"kernels": [
        dict(name=fn.__name__, route=route, source=src, replaces=rep,
             launches=launches[fn.__name__], **measured[fn.__name__])
        for fn, route, src, rep in kernels
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
