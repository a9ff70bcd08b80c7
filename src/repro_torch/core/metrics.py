"""Aggregation helpers for the profiler (Table I metrics) and the serving
SLO telemetry (TTFT/TPOT/E2E percentiles). A copy of the JAX package's
``core/metrics.py``, cut to what the port's serving path uses."""

from __future__ import annotations

import math


def mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else 0.0


def std(xs):
    xs = list(xs)
    if len(xs) < 2:
        return 0.0
    m = mean(xs)
    return math.sqrt(sum((x - m) ** 2 for x in xs) / (len(xs) - 1))


def cov(xs):
    """Coefficient of variation sigma/mu (paper Fig. 15c)."""
    m = mean(xs)
    return std(xs) / m if m else 0.0


def percentile(xs, p: float):
    xs = sorted(xs)
    if not xs:
        return 0.0
    k = (len(xs) - 1) * p
    lo = int(math.floor(k))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def summarize(xs) -> dict:
    xs = list(xs)
    return {
        "mean": mean(xs),
        "p50": percentile(xs, 0.50),
        "p95": percentile(xs, 0.95),
        "p99": percentile(xs, 0.99),
        "std": std(xs),
        "cov": cov(xs),
        "n": len(xs),
    }


def slo_summary(responses, *, warmup: int = 0) -> dict:
    """Warmup-aware serving SLO percentiles over Response objects.

    The first ``warmup`` responses (in completion order) are dropped.
    ``ttft_s`` is time to first token, ``tpot_s`` time per output token
    after the first, ``(total - ttft) / (tokens - 1)`` (single-token
    responses excluded), ``e2e_s`` the end-to-end latency, and ``stages``
    one :func:`summarize` dict per charged stage name.
    """
    responses = list(responses)
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0: {warmup}")
    rs = responses[warmup:]
    tpots = [
        (r.total_s - r.ttft_s) / (len(r.tokens) - 1)
        for r in rs if len(r.tokens) > 1
    ]
    stage_names = sorted({s for r in rs for s in r.stage_s})
    return {
        "n": len(rs),
        "warmup_dropped": min(warmup, len(responses)),
        "ttft_s": summarize(r.ttft_s for r in rs),
        "tpot_s": summarize(tpots),
        "e2e_s": summarize(r.total_s for r in rs),
        "queue_s": summarize(r.stage_s.get("queue", 0.0) for r in rs),
        "stages": {
            s: summarize(r.stage_s.get(s, 0.0) for r in rs)
            for s in stage_names
        },
    }
