"""The clients of a serving cell, in a process of their own, so that their
work (building and parsing the requests, the HTTP calls) takes no time
from the server's process.

    python3 port_bench/pbench/loadgen.py --port P --seed S --traffic JSON --config JSON

reads commands on standard input, one a line, and answers on standard
output with JSON lines:
  warm              send the traffic's warm-up requests, all of them;
                    answer {"done": "warm", "failed": n}
  run SECONDS       a closed loop of the traffic's clients for SECONDS:
                    {"open": t} when the clients start, {"close": t} when
                    they stop sending, then, once every answer has come (or
                    a minute has passed), one {"r": [i, prompt tokens, sent,
                    answered, tokens or null, logprobs or null]} a request,
                    and {"done": "run",
                    "issued": n}
  quit              exit
Times are time.perf_counter(), the system's monotonic clock, which the
server's process reads too."""

from __future__ import annotations

import argparse
import http.client
import json
import os
import sys
import threading
import time

DRAIN_S = 60.0


def _client(port, feed, make, log):
    while True:
        i = feed.take()
        if i is None:
            return
        prompt, max_tokens = make(i)
        body = json.dumps({"prompt": prompt, "max_tokens": max_tokens})
        t0 = time.perf_counter()
        tokens = logprobs = None
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            conn.request("POST", "/v1/completions", body, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            if resp.status == 200:
                answer = json.loads(data)
                tokens, logprobs = answer["tokens"], answer.get("logprobs")
        except (OSError, ValueError, KeyError, http.client.HTTPException):
            tokens = None
        log.append([i, len(prompt), t0, time.perf_counter(), tokens, logprobs])


def closed_loop(port, clients, feed, make, seconds=None, say=None):
    """Run `clients` threads over the feed; with `seconds`, close the feed
    that long after they start. Returns the records."""
    log = []
    threads = [threading.Thread(target=_client, args=(port, feed, make, log), daemon=True)
               for _ in range(clients)]
    t_open = time.perf_counter()
    for t in threads:
        t.start()
    if say:
        say({"open": t_open})
    if seconds is not None:
        time.sleep(max(0.0, seconds - (time.perf_counter() - t_open)))
        feed.close()
        t_close = time.perf_counter()
        if say:
            say({"close": t_close})
        for t in threads:
            t.join(timeout=max(0.0, t_close + DRAIN_S - time.perf_counter()))
    else:
        for t in threads:
            t.join()
    return list(log)


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [here, os.path.dirname(here)]
    from pbench import spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--traffic", required=True, help="the traffic file's parameters, as JSON")
    ap.add_argument("--config", required=True, help="the configuration, as JSON")
    args = ap.parse_args(argv)
    traffic, cfg = json.loads(args.traffic), json.loads(args.config)
    gen = spec.generator(traffic["kind"])

    def say(obj):
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()

    for line in sys.stdin:
        cmd = line.split()
        if not cmd:
            continue
        if cmd[0] == "warm":
            warm = gen.warmup_requests(traffic, cfg, args.seed)
            log = closed_loop(args.port, traffic["clients"], gen.Feed(len(warm)),
                              lambda i: warm[i])
            say({"done": "warm", "failed": sum(r[4] is None for r in log)})
        elif cmd[0] == "run":
            feed = gen.Feed()
            log = closed_loop(args.port, traffic["clients"], feed,
                              lambda i: gen.request(traffic, cfg, args.seed, i),
                              seconds=float(cmd[1]), say=say)
            for r in log:
                say({"r": r})
            say({"done": "run", "issued": feed.issued})
        elif cmd[0] == "quit":
            return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
