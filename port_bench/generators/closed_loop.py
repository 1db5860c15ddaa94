"""Requests for a closed loop of clients (each sends its next request when
its answer arrives).

Parameters (the traffic file): clients; prompt_len {"min", "max"}, drawn
log-uniform; max_tokens; grid: every seed serves the same set of prompt
lengths, `grid` lengths spaced evenly in log from the least to the most,
in an order of its own (shuffled anew every `grid` requests), so that a
window of some hundred requests serves nearly the same mix on every
seed; warmup_requests; sample: how many finished requests the check
compares. Token ids are uniform over [1, vocab)."""

from __future__ import annotations

import threading

import numpy as np

from pbench.weights import derive


def length_grid(traffic: dict) -> np.ndarray:
    pl = traffic["prompt_len"]
    g = traffic["grid"]
    q = np.arange(g) / (g - 1)
    return np.rint(np.exp(np.log(pl["min"]) + q * (np.log(pl["max"]) - np.log(pl["min"]))
                          )).astype(np.int64)


def prompt_len(traffic: dict, seed: int, i: int, stream: str = "run") -> int:
    g = traffic["grid"]
    order = np.random.default_rng(derive(seed, f"{stream}:order:{i // g}")).permutation(g)
    return int(length_grid(traffic)[order[i % g]])


def request(traffic: dict, cfg: dict, seed: int, i: int, stream: str = "run"):
    """Request i of a stream: (prompt token ids, max_tokens)."""
    n = prompt_len(traffic, seed, i, stream)
    rng = np.random.default_rng(derive(seed, f"{stream}:ids:{i}"))
    return rng.integers(1, cfg["vocab_size"], n).tolist(), int(traffic["max_tokens"])


def warmup_requests(traffic: dict, cfg: dict, seed: int):
    """Set-up's requests: first a full batch of the longest prompts of the
    grid (the largest buffers), then requests of the traffic's own mix."""
    longest = int(length_grid(traffic)[-1])
    rng = np.random.default_rng(derive(seed, "warm:longest"))
    out = [(rng.integers(1, cfg["vocab_size"], longest).tolist(), int(traffic["max_tokens"]))
           for _ in range(traffic["clients"])]
    out += [request(traffic, cfg, seed, i, "warm") for i in range(traffic["warmup_requests"])]
    return out


class Feed:
    """Hands out request indices to the clients until closed."""

    def __init__(self, limit=None):
        self._lock = threading.Lock()
        self._next = 0
        self._open = True
        self.limit = limit

    def take(self):
        with self._lock:
            if not self._open or (self.limit is not None and self._next >= self.limit):
                return None
            i = self._next
            self._next += 1
            return i

    @property
    def issued(self) -> int:
        return self._next

    def close(self):
        with self._lock:
            self._open = False
