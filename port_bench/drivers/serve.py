"""Serving cells: the program's `runtime/engine.py:Engine` behind its own
HTTP server (`runtime/server.py:EngineServer`, port 0 on localhost),
loaded by a closed loop of clients (generators/closed_loop.py) that run
in a process of their own (pbench/loadgen.py).

Set-up builds the engine on the seed's weights, starts the server and
sends the traffic's warm-up requests through it. The window is `seconds`
long: the clients send from its start and send nothing after its end. A
request counts in the window's numbers when its answer arrived inside
the window; one that fails, or never arrives within a minute of the
close, counts as failed.

What is compared, once the clients are done, the server is stopped and
the engine freed: a sample drawn from the seed of the requests that
finished (the one with the longest prompt always in it); the reference
computes each sampled prompt's first-token logits in f32, and the number
is the widest gap by which a served token's reference logit lies below
the reference's best (pbench/checks.py:logit_gap), and, where the engine
answers with log-probabilities, the widest gap between a served token's
log-probability and the reference's (checks.logprob_gap).

With routed experts the program's router is wrapped: the experts each
layer chose for a request's prompt rows stay on the card (uint8) until
the window has closed; the reference takes the same experts, and the
routing is checked apart (checks.route_checks). A configuration that
states "weights": "int8" is served as the program's quantize_params makes
it, and the reference dequantizes the same values by its own rule; the
control, one precision below the configuration's, is the program's own
path at the workload's `control_precision` (int8 unless it says
otherwise)."""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from pbench import checks, spec
from pbench.stats import rate
from pbench.trace import WINDOW_RANGE, Trace, start_profiler
from pbench.weights import derive
from pbench import weights as W
from drivers._program import Patch, port_config, program_params, record_routes

LOADGEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "pbench",
                       "loadgen.py")


class _Clients:
    """The load generator's process (pbench/loadgen.py), driven by lines."""

    def __init__(self, port, job):
        c = job.cell
        self.proc = subprocess.Popen(
            [sys.executable, LOADGEN, "--port", str(port), "--seed", str(job.seed),
             "--traffic", json.dumps(c.traffic), "--config", json.dumps(c.config)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def send(self, line):
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def read(self):
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the load generator ended (rc {self.proc.poll()})")
        return json.loads(line)

    def close(self):
        try:
            self.send("quit")
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


class _EngineThreadTrace:
    """Traces the later part of the window on the thread that runs the
    engine's steps (the profiler records host ops only on the thread that
    started it). The window's first `untraced_s` are not traced: the
    profiler costs the host time on every op it records, so the host's
    own numbers are read there. Then host and device together for
    `host_s` (the breakdown's idle gaps by host op); then, once that
    profiler has stopped (its stop holds the engine for a while), the
    device alone to the window's close (the per-layer metrics, busy_s and
    window_s)."""

    def __init__(self, eng, dev):
        self.dev = dev
        self.t_host = self.host_s = self.t_close = None  # set when the window opens
        self.done = {}  # kind -> (profiler, perf_counter start, stop, unix ns start, stop)
        self._cur = None
        self._next = "host"
        self._lock = threading.Lock()
        self._step = eng.step

    def open(self, t_open, seconds, untraced_s, host_s):
        self.host_s, self.t_close = host_s, t_open + seconds
        self.t_host = t_open + untraced_s

    def step(self):
        now = time.perf_counter()
        if self._next == "host" and self.t_host is not None and now >= self.t_host:
            self._switch("host")
            self._next = "device"
        elif self._next == "device" and now >= self._cur[3] + self.host_s:
            late = now >= self.t_close  # no room left for the card's stretch
            self._switch(None if late else "device")
            self._next = None if late else "close"
        elif self._next == "close" and now >= self.t_close:
            self._switch(None)
            self._next = None
        return self._step()

    def _switch(self, kind):
        with self._lock:
            # the card drains first, so a stretch's trace holds the whole
            # of the prefill calls made in it and nothing of those before
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            if self._cur is not None:
                k, prof, rng, t0, u0 = self._cur
                t1, u1 = time.perf_counter(), time.time_ns()
                rng.__exit__(None, None, None)
                prof.stop()
                self.done[k] = (prof, t0, t1, u0, u1)
                self._cur = None
            if kind is not None:
                prof = start_profiler(self.dev, host=kind == "host")
                rng = torch.profiler.record_function(WINDOW_RANGE)
                rng.__enter__()
                self._cur = (kind, prof, rng, time.perf_counter(), time.time_ns())

    def finish(self):
        """Stop what still traces, where the step loop went idle before it could."""
        self._next = None
        self._switch(None)


def _instrument(patch, eng, rec, job):
    """Wrap the engine's two prefill functions (the chunk step for prompts
    longer than a chunk, the one-shot bucket for the rest) with a host
    timer and a harness range, recording each call's (start, end, offset,
    rows launched, prompt rows in it, whether it holds the prompt's last
    row), and, for routed experts, the experts each layer chose for the
    call's prompt rows (rec["routes"]: id(request) -> (request, [per call,
    per layer])); plant a fault where asked."""
    from nnop_tpu_torch.runtime import engine as port_engine

    chunk_fn, prefill_fn, admit_one = eng._prefill_chunk_fn, eng._prefill, eng._admit_one
    C = eng.prefill_chunk
    one_shot = {}
    routed = bool(W.n_experts(job.cell.config))

    def timed(fn, *args, req=None, rows=0):
        if routed:
            rec["route_call"] = (rows, [])
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.prefill_chunk"):
            out = fn(*args)
        t1 = time.perf_counter()
        if routed:
            rec["routes"].setdefault(id(req), (req, []))[1].append(rec.pop("route_call")[1])
        return t0, t1, out

    def keep(idx):  # a layer's experts for the prompt rows of the call in flight
        call = rec.get("route_call")
        if call is not None:
            call[1].append(idx[:call[0]].to(torch.uint8))

    def chunk(params, tokens_c, ks, vs, offset):
        st = eng._admitting.get(eng._admit_rr)
        L = st["L"] if st is not None else offset + C
        req, rows = (st["req"] if st is not None else None), min(C, L - offset)
        if job.plant == "state":  # the step leaves the K/V buffers as they were
            t0, t1, (logits, _, _) = timed(chunk_fn, params, tokens_c, ks.clone(), vs.clone(),
                                           offset, req=req, rows=rows)
            out = (logits, ks, vs)
        else:
            t0, t1, out = timed(chunk_fn, params, tokens_c, ks, vs, offset, req=req, rows=rows)
        rec["chunks"].append((t0, t1, offset, tokens_c.shape[1], rows, offset + C >= L))
        return out

    def admit(slot, req, L, *a, **kw):
        one_shot.update(L=L, req=req)
        return admit_one(slot, req, L, *a, **kw)

    def prefill(params, tokens):
        t0, t1, out = timed(prefill_fn, params, tokens, req=one_shot["req"], rows=one_shot["L"])
        rec["chunks"].append((t0, t1, 0, tokens.shape[1], one_shot["L"], True))
        return out

    patch.set(eng, "_prefill_chunk_fn", chunk)
    patch.set(eng, "_prefill", prefill)
    patch.set(eng, "_admit_one", admit)
    if job.plant == "token":  # the served token altered where it is produced
        orig_sample = port_engine.sample_tokens

        def sample(logits, *a, **kw):
            return (orig_sample(logits, *a, **kw) + 1) % logits.shape[-1]

        patch.set(port_engine, "sample_tokens", sample)
    if routed:
        record_routes(patch, keep, job.plant)


def _build_engine(job, cfg, wl):
    from nnop_tpu_torch.runtime.engine import Engine, fuse_decode_weights

    e = wl["engine"]
    pcfg = port_config(cfg, max_seq=e["max_seq"])
    weights = cfg.get("weights")
    if job.plant == "control":  # the program's own path one precision below the configuration's
        weights = wl.get("control_precision", "int8")
    params = program_params(cfg, job.seed, job.device, weights)
    return Engine(fuse_decode_weights(params, in_place=True), pcfg, max_batch=e["max_batch"],
                  max_seq=e["max_seq"], seed=job.seed, **e.get("options", {}))


def _traced(tracer, rec, t_open):
    """The per-layer readers' context and the result's trace parts."""
    dev = tracer.done.get("device")
    host = tracer.done.get("host")
    if dev is None:
        return {}
    prof, t0, t1, u0, u1 = dev
    trace = Trace.from_profiler(prof, wall=(u0 * 1e-9, u1 * 1e-9))
    out = {"trace": trace,
           "ctx": {"trace": trace,
                   "chunks": [c for c in rec["chunks"]
                              if t_open <= c[0] and c[1] <= tracer.t_host],
                   "untraced_s": tracer.t_host - t_open,
                   "traced_chunks": [c for c in rec["chunks"] if t0 <= c[0] < t1]}}
    parts = [("untraced", t_open, tracer.t_host), ("device", t0, t1)]
    if host is not None:
        h = Trace.from_profiler(host[0], wall=(host[3] * 1e-9, host[4] * 1e-9))
        out["breakdown"] = {"device_ops": trace.breakdown()["device_ops"],
                            "idle_gaps": h.breakdown()["idle_gaps"]}
        parts.insert(1, ("host", host[1], host[2]))
    # what the profiler costs the host: the prefill calls' host time in each part
    say = []
    for name, a, b in parts:
        calls = [c[1] - c[0] for c in rec["chunks"] if a <= c[0] < b]
        say.append(f"{name} {b - a:.3f} s, {len(calls)} prefill calls"
                   + (f" of {1e3 * sum(calls) / len(calls):.3f} ms" if calls else ""))
    print(f"port_bench: {'; '.join(say)}; the card's window from {trace.window_from}",
          file=sys.stderr, flush=True)
    return out


def run(job):
    from nnop_tpu_torch.runtime.server import EngineServer

    cfg, wl = job.cell.config, job.cell.workload
    dev = job.device
    rec = {"chunks": [], "routes": {}}
    eng = _build_engine(job, cfg, wl)
    tracer = _EngineThreadTrace(eng, dev) if job.trace else None
    with Patch() as patch:
        _instrument(patch, eng, rec, job)
        if tracer is not None:
            patch.set(eng, "step", tracer.step)
        srv = EngineServer(eng, host="127.0.0.1", port=0).start()
        clients = _Clients(srv.port, job)
        try:
            clients.send("warm")
            warm = clients.read()
            if warm["failed"]:
                raise RuntimeError(f"{warm['failed']} warm-up requests failed")
            rec["routes"].clear()  # the window's requests alone are checked
            if tracer is not None:
                for host in (False, True):  # the profiler's own start-up stays out of the window
                    start_profiler(dev, host=host).stop()
            clients.send(f"run {job.seconds}")
            t_open = clients.read()["open"]
            if tracer is not None:
                tracer.open(t_open, job.seconds, min(job.seconds / 3, wl["untraced_seconds"]),
                            min(job.seconds / 6, wl["host_trace_seconds"]))
            t_close = clients.read()["close"]
            records = []
            while True:
                msg = clients.read()
                if "r" in msg:
                    records.append(msg["r"])
                else:
                    issued = msg["issued"]
                    break
            if tracer is not None:
                tracer.finish()
            peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        finally:
            clients.close()
            srv.stop()
    ok_in_window = [r for r in records if r[3] <= t_close and r[4] is not None]
    failed = issued - sum(1 for r in records if r[4] is not None)
    seconds = t_close - t_open
    out = {
        "e2e": {"serve_tokens_per_s": rate(sum(r[1] + len(r[4]) for r in ok_in_window), seconds),
                "setup_s": t_open - job.t0},
        "attempted": issued,
        "failed": failed,
        "memory_peak_bytes": peak,
        "window_s": seconds,
        "completed": len(ok_in_window),
    }
    if tracer is not None:
        out.update(_traced(tracer, rec, t_open))
    finished = [r for r in records if r[4]]
    del eng, srv, patch, tracer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out.update(_compare(job, finished, failed, rec["routes"]))
    return out


def _sample(job, finished):
    """The check's sample of the finished requests: the longest prompt and
    others drawn from the seed."""
    k = job.cell.traffic["sample"]
    by_len = sorted(finished, key=lambda r: (-r[1], r[0]))
    rest = by_len[1:]
    rng = np.random.default_rng(derive(job.seed, "check:sample"))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [by_len[0]] + [rest[j] for j in sorted(pick)] if by_len else []


def _prompt_routes(recorded, prompts, n_layers):
    """Each prompt's experts as the program chose them, (layers, L, k), or
    None where the record does not cover every row of the prompt."""
    by_prompt = {tuple(req.prompt): calls for req, calls in recorded.values() if req is not None}
    out = []
    for p in prompts:
        calls = by_prompt.get(tuple(p))
        if not calls or any(len(c) != n_layers for c in calls):
            return None
        t = torch.stack([torch.cat([c[i] for c in calls]) for i in range(n_layers)])
        if t.shape[1] != len(p):
            return None
        out.append(t)
    return out


def _compare(job, finished, failed, recorded):
    from reference import model as ref

    cfg, traffic, wl = job.cell.config, job.cell.traffic, job.cell.workload
    gen = spec.generator(traffic["kind"])
    sample = _sample(job, finished)
    limits = wl["limits"]
    if not sample:
        return {"checks": [checks.Check("logit_gap", math.inf, limits["logit_gap"])]}
    prompts = [gen.request(traffic, cfg, job.seed, r[0])[0] for r in sample]
    served = torch.tensor([r[4][0] for r in sample], device=job.device)
    routing = routes = None
    if W.n_experts(cfg):
        routing = ref.Routing()
        routes = _prompt_routes(recorded, prompts, cfg["num_hidden_layers"])
    recorded.clear()
    logits = ref.last_logits(cfg, job.seed, prompts, job.device, routes=routes, routing=routing)
    gaps = checks.logit_gap(logits, served)
    found = [checks.Check("logit_gap", max(gaps), limits["logit_gap"])]
    readings = {"gaps": gaps, "lengths": [r[1] for r in sample]}
    if "logprob_gap" in limits:
        lps = [r[5][0] if r[5] else math.nan for r in sample]
        lp_gaps = checks.logprob_gap(logits, served, lps)
        found.append(checks.Check("logprob_gap", max(lp_gaps), limits["logprob_gap"]))
        readings["logprob_gaps"] = lp_gaps
    if routing is not None:
        more, reading = checks.route_checks(limits, routing, routes is not None)
        found += more
        readings.update(reading)
    found.append(checks.Check("failed", float(failed), 0.0))
    return {"checks": found, "readings": readings}
