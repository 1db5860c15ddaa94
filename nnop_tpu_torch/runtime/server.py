"""HTTP serving front-end over the continuous-batching Engine.

Counterpart of nnop_tpu/runtime/server.py with the same endpoints and
behaviour, over the port's Engine. Stdlib-only (http.server): one
process per card, a threaded stdlib server in front of the single
engine-step loop.

Threading model: HTTP handler threads only enqueue requests (the Engine
is NOT thread-safe — its host scheduler mutates slot state); a single
background loop thread owns every `engine.step()` call. Completion is
signaled per-request via threading.Event, so handlers block without
polling and the step loop never blocks on the network.

Endpoints:
  POST /v1/completions   {"prompt": str | [int], "max_tokens": int,
                          "stream": bool}
                         -> {"id", "tokens", "text"?, "logprobs"?}
                         ("logprobs": one per token, when the engine
                         has logprobs=True), or
                         with "stream": true, Server-Sent Events — one
                         `data: {"tokens": [...]}` event per decode
                         chunk as tokens land, then `data: [DONE]`
  POST /v1/cancel        {"id": int} -> {"id", "cancelled": bool} —
                         drops a queued request or frees an active slot
  GET  /v1/stats         engine/serving counters (queue depth, active
                         slots, tokens generated, prefix hits, uptime)
  GET  /health           {"status": "ok"}

Backpressure: when the engine queue is at max_queue, /v1/completions
returns 429 with Retry-After instead of buffering unboundedly.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from nnop_tpu_torch.runtime.engine import QueueFullError


class EngineServer:
    """Owns the engine-step loop and an HTTP server bound to (host, port).

    Use as a context manager or call start()/stop(). port=0 picks a free
    port (read it back from `.port` after start()).
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 default_max_tokens: int = 64):
        self.engine = engine
        self.host = host
        self.port = port
        self.default_max_tokens = default_max_tokens
        self._lock = threading.Lock()  # guards engine scheduler state
        self._wake = threading.Event()  # new work for the step loop
        self._stop = threading.Event()
        self._events: dict[int, threading.Event] = {}
        self._requests: dict[int, object] = {}
        # rid -> (queue of newly-landed token lists, n tokens sent)
        self._streams: dict[int, tuple[queue.Queue, int]] = {}
        self._threads: list[threading.Thread] = []
        self._httpd = None
        self.stats = {
            "requests_submitted": 0,
            "requests_completed": 0,
            "tokens_generated": 0,
            "started_at": time.time(),
        }

    # ---- request lifecycle -------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, stream: bool = False):
        """Thread-safe submit; returns (request, completion_event,
        stream_queue or None). The stream queue receives a list of new
        tokens after each decode chunk and a None sentinel at the end."""
        ev = threading.Event()
        sq = queue.Queue() if stream else None
        with self._lock:
            if isinstance(prompt, str):
                req = self.engine.submit_text(prompt, max_new_tokens)
            else:
                req = self.engine.submit([int(t) for t in prompt],
                                         max_new_tokens)
            self._events[req.rid] = ev
            self._requests[req.rid] = req
            if stream:
                self._streams[req.rid] = (sq, 0)
            self.stats["requests_submitted"] += 1
        self._wake.set()
        return req, ev, sq

    def cancel(self, rid: int) -> bool:
        """Thread-safe cancel; wakes any handler blocked on the request."""
        with self._lock:
            ok = self.engine.cancel(rid)
            if ok:
                if rid in self._streams:
                    sq, _ = self._streams.pop(rid)
                    sq.put(None)
                ev = self._events.pop(rid, None)
                self._requests.pop(rid, None)
                if ev is not None:
                    ev.set()
        return ok

    def _loop(self):
        while not self._stop.is_set():
            with self._lock:
                eng = self.engine
                busy = bool(
                    eng.queue
                    or any(s is not None for s in eng.slots)
                    or eng._inflight
                )
                if busy:
                    eng.step()
                    self._flush_streams()
                    done = [
                        rid for rid in self._events
                        if self._find_done(rid)
                    ]
                    for rid in done:
                        self._events.pop(rid).set()
                        self.stats["requests_completed"] += 1
            if not busy:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def _flush_streams(self):
        """Push tokens that landed this step to streaming clients
        (called under self._lock)."""
        for rid in list(self._streams):
            req = self._requests.get(rid)
            if req is None:
                continue
            sq, sent = self._streams[rid]
            if len(req.out) > sent:
                sq.put(list(req.out[sent:]))
                self._streams[rid] = (sq, len(req.out))
            if req.done:
                sq.put(None)
                del self._streams[rid]

    def _find_done(self, rid: int):
        req = self._requests.get(rid)
        if req is not None and req.done:
            self.stats["tokens_generated"] += len(req.out)
            self._requests.pop(rid)
            return True
        return False

    # ---- server ------------------------------------------------------------

    def start(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    return self._json(200, {"status": "ok"})
                if self.path == "/v1/stats":
                    return self._json(200, server.snapshot_stats())
                return self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/v1/cancel":
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        payload = json.loads(self.rfile.read(n) or b"{}")
                        rid = int(payload["id"])
                    except (KeyError, ValueError, TypeError) as e:
                        return self._json(400, {"error": str(e)})
                    ok = server.cancel(rid)
                    return self._json(200 if ok else 404,
                                      {"id": rid, "cancelled": ok})
                if self.path != "/v1/completions":
                    return self._json(404, {"error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    prompt = payload["prompt"]
                    max_tokens = int(
                        payload.get("max_tokens",
                                    server.default_max_tokens)
                    )
                    stream = bool(payload.get("stream", False))
                    req, ev, sq = server.submit(prompt, max_tokens,
                                                stream=stream)
                except QueueFullError as e:
                    # queue-depth backpressure: reject loudly instead of
                    # buffering unboundedly
                    self.send_response(429)
                    self.send_header("Retry-After", "1")
                    body = json.dumps({"error": str(e)}).encode()
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return None
                except (KeyError, ValueError, TypeError) as e:
                    return self._json(400, {"error": str(e)})
                if stream:
                    # Server-Sent Events; HTTP/1.0 close-delimited body
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    while True:
                        item = sq.get()
                        if item is None:
                            break
                        self.wfile.write(
                            b"data: "
                            + json.dumps({"tokens": item}).encode()
                            + b"\n\n"
                        )
                        self.wfile.flush()
                    self.wfile.write(b"data: [DONE]\n\n")
                    return None
                ev.wait()
                out = {"id": req.rid, "tokens": req.out}
                if server.engine.tokenizer is not None:
                    out["text"] = server.engine.decode_text(req)
                if server.engine.logprobs:
                    out["logprobs"] = req.logprobs
                return self._json(200, out)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        for target in (self._loop, self._httpd.serve_forever):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def snapshot_stats(self):
        with self._lock:
            eng = self.engine
            s = dict(self.stats)
            s.update(
                queue_depth=len(eng.queue),
                active_slots=sum(x is not None for x in eng.slots),
                max_batch=eng.max_batch,
                uptime_s=round(time.time() - s.pop("started_at"), 3),
                prefix_hit_tokens=getattr(eng, "prefix_hits", 0),
            )
        return s

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
