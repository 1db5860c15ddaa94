"""Command-line entry points of the port: generate / serve on the dense
configs with floating-point (16-bit) weights; quantized weights are not
ported yet. Usage:

    python -m nnop_tpu_torch.cli generate --model tiny --device cpu --prompt "abcabc"
    python -m nnop_tpu_torch.cli serve --model 8b --port 8080

Weights are random from `--seed` unless `--checkpoint` names an npz
written by the JAX package's save_checkpoint.
"""

from __future__ import annotations

import argparse
import time

import torch

_CONFIGS = ("tiny", "8b")


def _build_engine(args, **engine_kw):
    from nnop_tpu_torch.models.llama import LlamaConfig, init_params
    from nnop_tpu_torch.models.weights import load_checkpoint
    from nnop_tpu_torch.runtime.engine import Engine
    from nnop_tpu_torch.runtime.tokenizer import BPETokenizer, VocabBPETokenizer

    if args.wbits != 16:
        raise NotImplementedError(f"--wbits {args.wbits}: quantized weights are not ported yet")
    cfg = {
        "8b": LlamaConfig.llama3_8b,
        "tiny": lambda: LlamaConfig.tiny(dtype=torch.float32),
    }[args.model]()
    device = torch.device(args.device)
    if args.checkpoint:
        params = load_checkpoint(args.checkpoint, device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        params = init_params(gen, cfg)
    tokenizer = (VocabBPETokenizer.from_file(args.tokenizer)
                 if getattr(args, "tokenizer", None) else BPETokenizer([]))
    return Engine(params, cfg, max_batch=args.batch, max_seq=cfg.max_seq_len,
                  quantized_kv=args.int8_kv, tokenizer=tokenizer, **engine_kw)


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


def _common(p):
    p.add_argument("--model", default="tiny", choices=_CONFIGS)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None, help="npz from the JAX package")
    p.add_argument("--wbits", type=int, default=16, choices=(4, 8, 16),
                   help="weight bits (only 16 is ported)")
    p.add_argument("--int8-kv", action="store_true", help="int8 KV cache (not ported yet)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="nnop_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate")
    _common(g)
    g.add_argument("--prompt", nargs="+", default=["hello world"])
    g.add_argument("--max-new", type=int, default=32)
    g.add_argument("--batch", type=int, default=4)
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
    sv.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
