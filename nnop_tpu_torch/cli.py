"""Command-line entry points of the port: train / generate / serve /
profile on the dense and the MoE configs (`tiny_moe`, `mixtral`), with
floating-point weights or, with `--wbits 8|4`, int8 or packed int4
weights, and with `--int8-kv`, an int8 KV cache. Usage:

    python -m nnop_tpu_torch.cli train --model tiny --device cpu --steps 50 --seq 128
    python -m nnop_tpu_torch.cli train --model tiny_moe --device cpu
    python -m nnop_tpu_torch.cli generate --model tiny --device cpu --prompt "abcabc"
    python -m nnop_tpu_torch.cli serve --model 8b --port 8080
    python -m nnop_tpu_torch.cli serve --model 8b --wbits 8 --int8-kv
    python -m nnop_tpu_torch.cli serve --model mixtral --wbits 8 --int8-kv
    python -m nnop_tpu_torch.cli profile --model 8b --wbits 8 --int8-kv --batch 8

Weights are random from `--seed` unless `--hf-path` names a local HF
checkpoint directory (its .safetensors shards, read by
models.weights.load_hf_llama straight onto the device; the config still
comes from `--model`, as in the JAX CLI) or `--checkpoint` names an npz
written by save_checkpoint (this package's or the JAX package's);
`--hf-path` wins over `--checkpoint`. Loaded weights are quantized after
loading, as the JAX package's CLI does;
random quantized weights are drawn quantized (init_quantized_params: a
MoE layer's experts int8 whatever --wbits is), so that a model whose
floating-point weights do not fit one card is served from its int8
weights: Mixtral-8x7B takes 93 GB in bf16, 47 GB with `--wbits 8`.

`train` is the JAX CLI's single-device training (nnop_tpu/cli.py:cmd_train
without --mesh, --fsdp and --remat, which need the mesh): AdamW on a
loss whose gradients run through the backward kernels, for the dense and
the MoE configs (`tiny_moe`, `mixtral`: the router's aux term in the
loss; the config's `moe_impl`, "einsum" by default as in JAX, or
"grouped", whose products' backward runs kernel I and the dw kernel).
Neither 8B nor Mixtral fits one 80 GB card at full depth, as neither
fits one chip without a mesh in JAX: at 2 bytes a parameter (bf16
weight) + 2 (bf16 gradient) + 8 (f32 AdamW moments), Llama-3-8B's 8.03 B
parameters take 96 GB and Mixtral-8x7B's 46.7 B take 560 GB before any
activation, so `--model 8b` and `--model mixtral` end in a CUDA
out-of-memory error. At full width they train on one card with their
depth cut (chip_smoke.py phase 8 runs train_loop on 8 layers of
Llama-3-8B, phase 10 on 2 layers of Mixtral).
"""

from __future__ import annotations

import argparse
import time

import torch

_CONFIGS = ("tiny", "tiny_moe", "8b", "mixtral")


def _config(name):
    from nnop_tpu_torch.models.llama import LlamaConfig

    return {
        "8b": LlamaConfig.llama3_8b,
        "tiny": lambda: LlamaConfig.tiny(dtype=torch.float32),
        "tiny_moe": lambda: LlamaConfig.tiny_moe(dtype=torch.float32),
        "mixtral": LlamaConfig.mixtral_8x7b,
    }[name]()


def train_loop(cfg, params, rows, *, steps: int, batch: int, lr, device, on_step=None,
               log=print):
    """Train `params` in place with AdamW(lr) for `steps` steps over the
    packed rows (N, L+1), as the JAX CLI's loop does (nnop_tpu/cli.py:35-83):
    epochs of `batches(rows, batch, seed=n)` with n the step count, one
    loss, backward and update per batch. The params' leaves get
    requires_grad. on_step(n, loss) runs after each step (loss a 0-d
    tensor). Returns (params, optimizer state, the losses as floats)."""
    from nnop_tpu_torch.models.llama import loss_fn
    from nnop_tpu_torch.parallel.tp_llama import AdamW, tree_leaves
    from nnop_tpu_torch.runtime.dataio import batches, prefetch_to_device

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = AdamW(lr=lr)
    state = opt.init(params)
    losses = []
    n = 0
    t0 = time.time()
    while n < steps:
        for toks, tgts in prefetch_to_device(batches(rows, batch, seed=n), device):
            loss = loss_fn(params, toks, tgts, cfg)
            grads = torch.autograd.grad(loss, leaves)
            params, state = opt.update(grads, state, params)
            del grads
            n += 1
            losses.append(loss.item())
            if on_step is not None:
                on_step(n, loss)
            if n % 10 == 0 or n == steps:
                log(f"step {n}: loss {losses[-1]:.4f} ({(time.time() - t0) / n:.2f} s/step)")
            if n >= steps:
                break
    return params, state, losses


def cmd_train(args):
    from nnop_tpu_torch.models.llama import init_params
    from nnop_tpu_torch.models.weights import save_checkpoint
    from nnop_tpu_torch.runtime.dataio import pack_tokens

    cfg = _config(args.model)
    device = torch.device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_params(gen, cfg)
    # synthetic corpus when no data file is given
    if args.data:
        import numpy as np

        stream = list(np.fromfile(args.data, dtype=np.int32) % cfg.vocab_size)
    else:
        stream = [(7 * i + 3) % cfg.vocab_size for i in range(args.seq * 64)]
    rows = pack_tokens([stream], seq_len=args.seq)
    params, _, _ = train_loop(cfg, params, rows, steps=args.steps, batch=args.batch,
                              lr=args.lr, device=device)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params)
        print(f"saved {args.checkpoint}")


def _build_engine(args, **engine_kw):
    from nnop_tpu_torch.models.llama import init_params, init_quantized_params
    from nnop_tpu_torch.models.quantized import quantize_params
    from nnop_tpu_torch.models.weights import load_checkpoint, load_hf_llama
    from nnop_tpu_torch.runtime.engine import Engine, fuse_decode_weights
    from nnop_tpu_torch.runtime.tokenizer import BPETokenizer, VocabBPETokenizer

    cfg = _config(args.model)
    device = torch.device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    hf_path = getattr(args, "hf_path", None)  # generate and serve have it, as in JAX
    if hf_path or args.checkpoint:
        params = (load_hf_llama(hf_path, cfg, device=device) if hf_path
                  else load_checkpoint(args.checkpoint, device))
        if args.wbits < 16:
            params = quantize_params(params, wbits=args.wbits)
    elif args.wbits < 16:
        params = init_quantized_params(gen, cfg, wbits=args.wbits)
    else:
        params = init_params(gen, cfg)
    tokenizer = (VocabBPETokenizer.from_file(args.tokenizer)
                 if getattr(args, "tokenizer", None) else BPETokenizer([]))
    # fused here, one layer at a time: the engine holds no unfused copy
    return Engine(fuse_decode_weights(params, in_place=True), cfg, max_batch=args.batch,
                  max_seq=cfg.max_seq_len, quantized_kv=args.int8_kv, tokenizer=tokenizer,
                  **engine_kw)


def cmd_generate(args):
    eng = _build_engine(args)
    reqs = [eng.submit_text(p, args.max_new) for p in args.prompt]
    t0 = time.time()
    eng.run()
    dt = time.time() - t0
    total = sum(len(r.out) for r in reqs)
    for r in reqs:
        print(f"[{r.rid}] {r.out}")
    print(f"{total} tokens in {dt:.2f}s = {total / dt:.1f} tok/s")


def cmd_serve(args):
    from nnop_tpu_torch.runtime.server import EngineServer

    eng = _build_engine(args, temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p)
    srv = EngineServer(eng, host=args.host, port=args.port).start()
    print(f"serving {args.model} on http://{args.host}:{srv.port} "
          f"(POST /v1/completions, GET /v1/stats)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


def cmd_profile(args):
    """Profile `--steps` engine steps (one decode chunk each) with every
    slot live, under torch.profiler: host ms per step, the device's busy
    share (kernel time over the window) and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    eng = _build_engine(args)
    gen = torch.Generator().manual_seed(args.seed)
    for _ in range(args.batch):
        prompt = torch.randint(0, eng.cfg.vocab_size, (args.prompt_len,), generator=gen)
        eng.submit(prompt.tolist(), max_new_tokens=(args.steps + 4) * eng.chunk_size)
    while eng.queue or eng._admitting or not eng._inflight:
        eng.step()  # admit every prompt, then fill the pipeline
    eng.step()
    cuda = eng.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        sync()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3  # ms
    per_step = wall * 1e3 / args.steps
    print(f"{args.steps} steps x {eng.chunk_size} tokens x {args.batch} slots: "
          f"{per_step:.1f} ms per step = {args.batch * eng.chunk_size / (per_step / 1e3):.0f} "
          f"tok/s; device busy {busy:.1f} ms of {wall * 1e3:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:100]}")


def _common(p):
    p.add_argument("--model", default="tiny", choices=_CONFIGS)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None, help="npz from save_checkpoint")
    p.add_argument("--wbits", type=int, default=16, choices=(4, 8, 16),
                   help="weight bits: 16 floating point, 8 int8, 4 packed int4")
    p.add_argument("--int8-kv", action="store_true", help="int8 KV cache")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="nnop_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    t.add_argument("--model", default="tiny", choices=_CONFIGS)
    t.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    t.add_argument("--steps", type=int, default=50)
    t.add_argument("--batch", type=int, default=4)
    t.add_argument("--seq", type=int, default=128)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--data", default=None, help="int32 token file")
    t.add_argument("--checkpoint", default=None, help="npz to save the trained params to")
    t.set_defaults(fn=cmd_train)

    g = sub.add_parser("generate")
    _common(g)
    g.add_argument("--prompt", nargs="+", default=["hello world"])
    g.add_argument("--max-new", type=int, default=32)
    g.add_argument("--batch", type=int, default=4)
    g.add_argument("--hf-path", default=None, help="local HF checkpoint directory")
    g.set_defaults(fn=cmd_generate)

    sv = sub.add_parser("serve")
    _common(sv)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8080)
    sv.add_argument("--batch", type=int, default=8)
    sv.add_argument("--temperature", type=float, default=0.0)
    sv.add_argument("--top-k", type=int, default=0)
    sv.add_argument("--top-p", type=float, default=1.0)
    sv.add_argument("--tokenizer", default=None,
                    help="HF tokenizer.json path (default: raw bytes)")
    sv.add_argument("--hf-path", default=None, help="local HF checkpoint directory")
    sv.set_defaults(fn=cmd_serve)

    pr = sub.add_parser("profile")
    _common(pr)
    pr.add_argument("--batch", type=int, default=8)
    pr.add_argument("--prompt-len", type=int, default=400)
    pr.add_argument("--steps", type=int, default=2)
    pr.add_argument("--top", type=int, default=15, help="kernels to list")
    pr.set_defaults(fn=cmd_profile)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
