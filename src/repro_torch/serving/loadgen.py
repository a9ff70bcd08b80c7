"""Seeded traffic for the serving engine (a copy of the JAX package's
``serving/loadgen.py``: the Poisson and shared-prefix arrival processes and
the open-loop runner).

Both schedules are deterministic in ``seed``: the same seed gives the same
arrival offsets and the same prompt token arrays as the JAX package's, so
the two engines can be fed one workload.

* **Open-loop Poisson** (:func:`poisson_schedule`) -- exponential
  interarrival gaps at ``rate_rps``; arrivals never wait for completions.
* **Shared-prefix Poisson** (:func:`shared_prefix_schedule`) -- the same
  arrival process over Zipf-distributed shared system prompts, the
  workload the paged engine's radix prefix reuse serves.

:func:`run_open_loop` submits each request when its offset comes due and
steps the engine in between, so pre-admission backlog lands in each
request's 'queue' stage.
"""

from __future__ import annotations

import dataclasses
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


def run_open_loop(engine, schedule: list, *, max_steps: int = 1_000_000,
                  poll_s: float = 0.002) -> list:
    """Drive ``engine`` with wall-clock open-loop arrivals: each request is
    submitted when its offset comes due, never gated on completions, and
    the engine steps in between. Returns responses in completion order;
    raises if the drain exceeds ``max_steps`` (a stuck engine, not a slow
    one)."""
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
        out.extend(engine.step())
        steps += 1
        if steps > max_steps:
            raise RuntimeError(
                f"open-loop drain exceeded {max_steps} steps with "
                f"{len(out)}/{len(sched)} responses"
            )
    return out
