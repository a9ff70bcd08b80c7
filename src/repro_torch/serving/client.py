"""Closed-loop load generator (paper §III-B: each client sends requests in a
closed loop)."""

from __future__ import annotations

import time

import numpy as np

from repro_torch.serving.request import Request


class ClosedLoopClient:
    """One client of a closed loop. ``prompt_len`` is a fixed length, or a
    ``(lo, hi)`` pair from which each prompt's length is drawn uniformly
    (a ragged load)."""

    def __init__(self, client_id: int, vocab: int, *, prompt_len=32,
                 max_new_tokens: int = 8, priority: int = 0, seed: int = 0):
        self.client_id = client_id
        self.vocab = vocab
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.priority = priority
        self.rng = np.random.default_rng(seed + client_id)
        self.inflight = None
        self.completed = []

    def make_request(self) -> Request:
        if isinstance(self.prompt_len, tuple):
            lo, hi = self.prompt_len
            n = int(self.rng.integers(lo, hi + 1))
        else:
            n = self.prompt_len
        toks = self.rng.integers(0, self.vocab, n, dtype=np.int32)
        req = Request(
            prompt_tokens=toks,
            max_new_tokens=self.max_new_tokens,
            priority=self.priority,
            client_id=self.client_id,
        )
        self.inflight = req.request_id
        return req

    def complete(self, response):
        if response.request_id != self.inflight:
            raise RuntimeError(
                f"client {self.client_id} got response {response.request_id} "
                f"while waiting for {self.inflight}")
        self.inflight = None
        self.completed.append(response)


def run_closed_loop(engine, clients, requests_per_client: int):
    """Drive the engine with closed-loop clients until all finish."""
    remaining = {c.client_id: requests_per_client for c in clients}
    by_req = {}
    for c in clients:
        req = c.make_request()
        by_req[req.request_id] = c
        engine.submit(req, time.perf_counter())
        remaining[c.client_id] -= 1
    while True:
        done = engine.step()
        for rsp in done:
            c = by_req.pop(rsp.request_id)
            c.complete(rsp)
            if remaining[c.client_id] > 0:
                req = c.make_request()
                by_req[req.request_id] = c
                engine.submit(req, time.perf_counter())
                remaining[c.client_id] -= 1
        if not by_req and not engine.queue:
            break
    return clients
