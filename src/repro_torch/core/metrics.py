"""Aggregation helpers for the profiler (Table I metrics) and the serving
SLO telemetry the cluster tier reports (TTFT/TPOT/E2E percentiles,
per-replica balance). A copy of the JAX package's ``core/metrics.py``."""

from __future__ import annotations

import dataclasses
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


def jain_index(xs) -> float:
    """Jain's fairness index (sum x)^2 / (n * sum x^2) over per-replica
    load shares: 1.0 means perfectly balanced, 1/n means one replica took
    everything. The cluster tier reports it over per-replica busy-slot
    time and routed-request counts."""
    xs = [float(x) for x in xs]
    if not xs:
        return 1.0
    sq = sum(x * x for x in xs)
    if sq == 0.0:
        return 1.0  # nothing routed anywhere: vacuously balanced
    tot = sum(xs)
    return tot * tot / (len(xs) * sq)


def merge_record_streams(streams, offsets=None) -> list:
    """Merge per-process :class:`~repro_torch.core.profiler.RequestRecord`
    streams into one timeline, tolerating clock skew.

    Each replica process stamps ``t_issue``/``t_done`` with its own
    ``time.perf_counter``, whose epoch differs between processes.
    ``offsets[i]`` is stream i's estimated ``child_clock -
    reference_clock`` skew (the socket handshake's
    ``ipc.ReplicaClient.clock_offset``); subtracting it rebases every
    absolute stamp onto the reference (parent) clock. Durations
    (``stage_s``, ``cpu_s``, ``t_done - t_issue``) are differences of
    same-clock stamps, so they pass through untouched.

    Returns ONE list sorted by rebased ``t_done``, with rebased copies:
    source records are never mutated. ``offsets=None`` means all streams
    already share the reference clock.
    """
    streams = [list(s) for s in streams]
    if offsets is None:
        offsets = [0.0] * len(streams)
    if len(offsets) != len(streams):
        raise ValueError(
            f"offsets length {len(offsets)} != streams length {len(streams)}"
        )
    merged = []
    for recs, off in zip(streams, offsets):
        for rec in recs:
            merged.append(
                rec if off == 0.0 else dataclasses.replace(
                    rec, t_issue=rec.t_issue - off, t_done=rec.t_done - off
                )
            )
    merged.sort(key=lambda r: r.t_done)
    return merged


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
