"""Seeded traffic for the serving engines and the cluster tier (a copy of
the JAX package's ``serving/loadgen.py``).

Every schedule is deterministic in ``seed``: the same seed gives the same
arrival offsets and the same prompt token arrays as the JAX package's, so
the two packages can be fed one workload.

* **Open-loop Poisson** (:func:`poisson_schedule`) -- exponential
  interarrival gaps at ``rate_rps``; arrivals never wait for completions.
* **Shared-prefix Poisson** (:func:`shared_prefix_schedule`) -- the same
  arrival process over Zipf-distributed shared system prompts, the
  workload the paged engine's radix prefix reuse and the router's
  ``prefix_cache`` policy serve.
* **Trace replay** (:func:`trace_schedule` / :func:`load_trace` /
  :func:`save_trace`) -- explicit per-request arrival offsets, prompt
  lengths, budgets and priorities from a JSON-lines trace file or a list
  of dicts.
* **Closed-loop baseline** (:func:`run_closed_loop_baseline`) -- N
  clients, each submitting its next request when the last completes
  (``serving/client.py``), the paper's SS-III-B workload model.

:func:`run_open_loop` submits each request when its offset comes due and
steps the engine (or cluster, or a Gateway over either) in between, so
pre-admission backlog lands in each request's 'queue' stage.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled submission: ``t`` seconds after the run starts."""

    t: float
    request: Request


def _make_request(rng, vocab: int, prompt_len: int, max_new: int,
                  client_id: int = 0, priority: int = 0) -> Request:
    return Request(
        prompt_tokens=rng.integers(0, vocab, int(prompt_len),
                                   dtype=np.int32),
        max_new_tokens=int(max_new),
        client_id=int(client_id),
        priority=int(priority),
    )


def poisson_schedule(vocab: int, *, rate_rps: float, n_requests: int,
                     prompt_lens=(8, 16, 32, 64), max_new: int = 8,
                     seed: int = 0, client_id: int = 0) -> list:
    """Open-loop Poisson arrivals: exponential gaps at ``rate_rps``,
    prompt lengths drawn uniformly from ``prompt_lens``. Gaps, lengths and
    token contents all come from one ``default_rng(seed)`` stream."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0: {rate_rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, n_requests)
    times = np.cumsum(gaps)
    lens = rng.choice(np.asarray(prompt_lens, np.int64), size=n_requests)
    return [
        Arrival(float(times[i]),
                _make_request(rng, vocab, lens[i], max_new, client_id))
        for i in range(n_requests)
    ]


def shared_prefix_schedule(vocab: int, *, rate_rps: float, n_requests: int,
                           n_prefixes: int = 4, prefix_len: int = 64,
                           suffix_len: int = 16, zipf_a: float = 1.1,
                           max_new: int = 8, seed: int = 0,
                           client_id: int = 0) -> list:
    """Open-loop Poisson arrivals over Zipf-distributed SHARED system
    prompts: each prompt is one of ``n_prefixes`` fixed prefix token arrays
    (popularity ``p(k) ∝ 1/k^zipf_a``) followed by ``suffix_len`` fresh
    tokens unique to the request. With a page-aligned ``prefix_len``,
    repeats of a prefix are what the paged engine's radix index turns into
    cached pages. ``prefix_len=0`` gives independent prompts. Prefix
    contents, Zipf draws, gaps and suffixes all come from one
    ``default_rng(seed)`` stream.
    """
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0: {rate_rps}")
    if n_prefixes < 1:
        raise ValueError(f"n_prefixes must be >= 1: {n_prefixes}")
    if suffix_len < 1:
        raise ValueError(
            f"suffix_len must be >= 1 (a request needs at least one "
            f"uncached token to produce first logits): {suffix_len}"
        )
    rng = np.random.default_rng(seed)
    prefixes = [
        rng.integers(0, vocab, int(prefix_len), dtype=np.int32)
        for _ in range(n_prefixes)
    ]
    weights = 1.0 / np.arange(1, n_prefixes + 1, dtype=np.float64) ** zipf_a
    weights /= weights.sum()
    which = rng.choice(n_prefixes, size=n_requests, p=weights)
    gaps = rng.exponential(1.0 / rate_rps, n_requests)
    times = np.cumsum(gaps)
    out = []
    for i in range(n_requests):
        suffix = rng.integers(0, vocab, int(suffix_len), dtype=np.int32)
        prompt = np.concatenate([prefixes[which[i]], suffix])
        out.append(Arrival(
            float(times[i]),
            Request(prompt_tokens=prompt, max_new_tokens=int(max_new),
                    client_id=int(client_id)),
        ))
    return out


def trace_schedule(entries, vocab: int, *, seed: int = 0) -> list:
    """Arrival schedule from trace entries (dicts with ``t`` seconds,
    ``prompt_len``, and optional ``max_new``/``client_id``/``priority``).
    Prompt token contents are drawn from ``seed``; the entries give timing
    and shape, so a saved trace replays identically."""
    rng = np.random.default_rng(seed)
    out = []
    for e in entries:
        out.append(Arrival(
            float(e["t"]),
            _make_request(rng, vocab, e["prompt_len"], e.get("max_new", 8),
                          e.get("client_id", 0), e.get("priority", 0)),
        ))
    if any(out[i].t > out[i + 1].t for i in range(len(out) - 1)):
        raise ValueError("trace arrival times must be non-decreasing")
    return out


def load_trace(path: str) -> list:
    """Read a JSON-lines trace file (one entry dict per line; blank lines
    and ``#`` comment lines skipped)."""
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                entries.append(json.loads(line))
    return entries


def save_trace(path: str, entries) -> None:
    """Write trace entries as JSON lines (the :func:`load_trace` format)."""
    with open(path, "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")


def run_open_loop(engine, schedule: list, *, max_steps: int = 1_000_000,
                  poll_s: float = 0.002) -> list:
    """Drive ``engine`` (a ServingEngine, DisaggregatedEngine,
    EnginePipeline, ServingCluster, or a Gateway over any of them) with
    wall-clock open-loop arrivals: each request is submitted when its
    offset comes due, never gated on completions, and the engine steps in
    between. Returns responses in completion order; raises if the drain
    exceeds ``max_steps`` (a stuck engine, not a slow one)."""
    sched = sorted(schedule, key=lambda a: a.t)
    out = []
    i = 0
    steps = 0
    t0 = time.perf_counter()
    while i < len(sched) or not engine.idle:
        now = time.perf_counter() - t0
        while i < len(sched) and sched[i].t <= now:
            engine.submit(sched[i].request, time.perf_counter())
            i += 1
        if engine.idle and i < len(sched):
            # nothing to step: sleep up to the next arrival (capped so a
            # long gap still polls the clock)
            time.sleep(min(max(sched[i].t - now, 0.0), poll_s))
            continue
        got = engine.step()
        out.extend(got)
        if not got and getattr(engine, "async_draining", False):
            # engines that drain on their own (the threaded pipeline,
            # process replicas) make progress without stepping: spinning
            # here would only charge polling to the driver's CPU. Sleep
            # until the next arrival, capped at poll_s so completions are
            # still collected promptly
            now = time.perf_counter() - t0
            wait = poll_s if i >= len(sched) else min(
                max(sched[i].t - now, 0.0), poll_s)
            if wait > 0.0:
                time.sleep(wait)
        steps += 1
        if steps > max_steps:
            raise RuntimeError(
                f"open-loop drain exceeded {max_steps} steps with "
                f"{len(out)}/{len(sched)} responses"
            )
    return out


def run_closed_loop_baseline(engine, vocab: int, *, n_clients: int = 4,
                             requests_per_client: int = 4,
                             prompt_len: int = 32, max_new_tokens: int = 8,
                             seed: int = 0) -> list:
    """Closed-loop control: ``n_clients`` clients, each submitting its
    next request only when the previous completes (``serving/client.py``).
    Returns the flat completion list across clients. Concurrency is capped
    at ``n_clients``, so the backlog an open loop measures cannot form."""
    from repro_torch.serving.client import ClosedLoopClient, run_closed_loop

    clients = [
        ClosedLoopClient(i, vocab, prompt_len=prompt_len,
                         max_new_tokens=max_new_tokens, seed=seed)
        for i in range(n_clients)
    ]
    run_closed_loop(engine, clients, requests_per_client)
    return [r for c in clients for r in c.completed]
