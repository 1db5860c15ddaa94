"""Training cells: the program's `cli.train_loop` (AdamW on
`models/llama.py:loss_fn`, the backward kernels) on rows packed from
seeded documents.

Set-up builds the one trainer the window uses: the weights from the seed,
then `train_loop`'s own first steps through its own feed; the first
`checked_steps` of them are the ones the reference follows. The window
opens at the end of step `warmup_steps` and closes at the end of the
first step that ends `seconds` or more after it opened; `on_step` ends
the loop there.

What is compared (pbench/checks.py:train_checks): each checked step's
loss; step 1's gradient, read back from AdamW's first moment after one
step (mu = (1 - b1) g); the parameters' change after the checked steps,
taken before the next step moves them. The reference runs the same steps
from the same weights and rows once the program's state is freed.

With routed experts the program's router is wrapped: each layer's chosen
experts of the checked steps stay on the card (uint8), the reference
takes the same experts, and the routing is checked apart
(checks.route_checks)."""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from pbench import checks, spec
from pbench.stats import rate
from pbench import weights as W
from pbench.trace import WINDOW_RANGE, Trace, start_profiler
from drivers._program import Patch, port_config, record_routes


class _Closed(Exception):
    """Raised from on_step to end train_loop when the window closes."""


def _gap_norm(p, p0):
    """||p - p0|| in f32; a stacked expert leaf a slab at a time."""
    if p.ndim < 3:
        return (p.detach().float() - p0.float()).norm().item()
    return math.sqrt(sum((a.detach().float() - b.float()).norm().item() ** 2
                         for a, b in zip(p, p0)))


def _change_norms(params, cfg, seed, device):
    """Each leaf's ||p - p0||, p0 made again from the seed a leaf at a time."""
    flat = W.flatten(params)
    return {n: _gap_norm(flat[n], p0) for n, p0 in W.leaves(cfg, seed, device)}


def run(job):
    from nnop_tpu_torch import cli
    from nnop_tpu_torch.models import llama as port_llama
    from nnop_tpu_torch.parallel import tp_llama
    from nnop_tpu_torch.runtime import dataio

    cfg, traffic, wl = job.cell.config, job.cell.traffic, job.cell.workload
    dev = job.device
    B, L = traffic["batch"], traffic["seq_len"]
    checked, warm = wl["checked_steps"], wl["warmup_steps"]
    lr = wl["lr"]
    docs = spec.generator(traffic["kind"])
    rows = docs.make_rows(traffic, cfg, job.seed)
    rec = {"losses": [], "steps": 0, "grad1": None, "change": None, "calls": 0, "routes": []}

    if job.plant == "control":  # the reference in lower precision takes the program's place
        return dict(_compare(job, docs, rows, rec, precision=wl["control_precision"]), e2e={},
                    attempted=0, failed=0, memory_peak_bytes=0)

    pcfg = port_config(cfg, max_seq=L)
    params = W.make_model(cfg, job.seed, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    prof = [None]
    window = {}
    orig_update = tp_llama.AdamW.update
    orig_loss = port_llama.loss_fn
    orig_batches = dataio.batches

    def update(self, grads, state, params_):
        with torch.profiler.record_function("bench.adamw"):
            if job.plant == "state":  # a step that leaves the state as it was
                new = (params_, dict(state, count=state["count"] + 1))
            else:
                new = orig_update(self, grads, state, params_)
        count = new[1]["count"]
        if count == 1:
            mu = W.flatten(new[1]["mu"])
            rec["grad1"] = {n: (m / (1.0 - self.b1)).norm().item() for n, m in mu.items()}
        if count == checked:
            rec["change"] = _change_norms(params_, cfg, job.seed, dev)
        return new

    def loss_fn(params_, tokens, targets, cfg_, **kw):
        rec["calls"] += 1
        if rec["calls"] <= checked:
            rec["routes"].append([])
        if job.plant == "half":  # half of the batch's tokens left out, the mean over the rest
            tokens, targets = tokens[:, : L // 2], targets[:, : L // 2]
        with torch.profiler.record_function("bench.loss"):
            return orig_loss(params_, tokens, targets, cfg_, **kw)

    def keep(idx):  # the experts of a checked step, a layer at a time
        if rec["calls"] <= checked:
            rec["routes"][-1].append(idx.to(torch.uint8))

    def batches(rows_, batch, **kw):
        for toks, tgts in orig_batches(rows_, batch, **kw):
            if job.plant == "token":  # the feed alters the targets it produces
                tgts = np.roll(tgts, 1, axis=1)
            yield toks, tgts

    def on_step(n, loss):
        t = time.perf_counter()
        if n <= checked:
            rec["losses"].append(float(loss.detach()))
        if n == warm - 1 and job.trace:
            start_profiler(dev).stop()  # the profiler's own start-up stays out of the window
        if n == warm:
            if job.trace:
                prof[0] = start_profiler(dev)
                window["range"] = torch.profiler.record_function(WINDOW_RANGE)
                window["range"].__enter__()
            window["open"] = time.perf_counter()
            return
        if n > warm:
            rec["steps"] += 1
            if t - window["open"] >= job.seconds:
                sync()
                window["close"] = time.perf_counter()
                if job.trace:
                    window["range"].__exit__(None, None, None)
                    prof[0].stop()
                raise _Closed

    with Patch() as patch:
        patch.set(tp_llama.AdamW, "update", update)
        patch.set(port_llama, "loss_fn", loss_fn)
        patch.set(dataio, "batches", batches)
        if W.n_experts(cfg):
            record_routes(patch, keep, job.plant)
        try:
            cli.train_loop(pcfg, params, rows, steps=10**9, batch=B, lr=lr, device=dev,
                           on_step=on_step, log=lambda s: None)
        except _Closed:
            pass
    seconds = window["close"] - window["open"]
    tokens = rec["steps"] * B * L
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out = {
        "e2e": {"train_tokens_per_s": rate(tokens, seconds), "setup_s": window["open"] - job.t0},
        "attempted": rec["steps"],
        "failed": 0 if np.isfinite(rec["losses"]).all() else 1,
        "memory_peak_bytes": peak,
        "window_s": seconds,
        "steps": rec["steps"],
    }
    if job.trace:
        trace = Trace.from_profiler(prof[0])
        out["trace"] = trace
        out["ctx"] = {"steps": rec["steps"], "batch": B, "seq_len": L, "trace": trace}
    del params, prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out.update(_compare(job, docs, rows, rec))
    return out


def _covers(routes, n_layers, rows, steps):
    """Whether the recorded choices give each checked step's every layer
    one choice a row of the reference's batch."""
    return len(routes) == steps and all(
        len(step) == n_layers and all(t.shape[0] == rows for t in step) for step in routes)


def _compare(job, docs, rows, rec, precision=None):
    """The reference's steps against the program's (or, with `precision`,
    the reference in that precision in the program's place, its routing
    taken as the program's)."""
    from reference import model as ref

    cfg, wl = job.cell.config, job.cell.workload
    B = job.cell.traffic["batch"]
    checked = wl["checked_steps"]
    routed = bool(W.n_experts(cfg))

    def batch(step):
        r = torch.from_numpy(docs.step_rows(rows, B, step)).to(job.device)
        return r[:, :-1], r[:, 1:]

    steps = [batch(s) for s in range(1, checked + 1)]
    if precision is not None:
        control = ref.Routing() if routed else None
        rec["losses"], rec["grad1"], rec["change"] = ref.train_steps(
            cfg, job.seed, steps, wl["lr"], job.device, precision=precision, routing=control)
        if routed:
            rec["routes"] = control.passes(cfg["num_hidden_layers"])
        del control
        gc.collect()
        if job.device.type == "cuda":
            torch.cuda.empty_cache()
    routing = ref.Routing() if routed else None
    replay = routed and _covers(rec["routes"], cfg["num_hidden_layers"], steps[0][0].numel(),
                                checked)
    losses, grad1, change = ref.train_steps(cfg, job.seed, steps, wl["lr"], job.device,
                                            routes=rec["routes"] if replay else None,
                                            routing=routing)
    found = checks.train_checks(wl["limits"], rec["losses"], losses, rec["grad1"] or {},
                                grad1, rec["change"] or {}, change) if (
        rec["grad1"] and rec["change"]) else [checks.Check("steps_checked", float("inf"), 0.0)]
    readings = {"losses": rec["losses"], "ref_losses": losses}
    if rec["grad1"] and rec["change"]:
        names = sorted(grad1)
        med = sorted(grad1.values())[len(names) // 2]
        moving = [n for n in names if grad1[n] >= checks.STILL_LEAF * med]
        readings["grad1"] = checks.leaf_detail(rec["grad1"], grad1, names)
        readings["update"] = checks.leaf_detail(rec["change"], change, moving)
    if routed:
        more, reading = checks.route_checks(wl["limits"], routing, replay)
        found += more
        readings.update(reading)
    return {"checks": found, "readings": readings}
