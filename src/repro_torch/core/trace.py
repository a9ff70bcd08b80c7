"""Span-based tracing: timestamped pipeline hops on one merged timeline
(a copy of the JAX package's ``core/trace.py``).

The profiler (:mod:`repro_torch.core.profiler`) charges stage *durations*
to ``RequestRecord.stage_s``: enough for the paper's Table-I breakdown
means, but blind to *when* each stage ran. This module adds that axis:
every pipeline hop (gateway submit/response, router decision, queue wait,
prefill dispatch, KV handoff, decode windows, pipeline threads, IPC RPC
frames) emits a :class:`Span` with ``perf_counter`` start/end stamps into
a process-global ring buffer, and the whole multi-process timeline exports
as Chrome trace-event JSON (loadable at https://ui.perfetto.dev) or a text
stage summary.

Design constraints, in order:

* **Hot-path safe.** ``emit`` is a guarded no-op when tracing is off (one
  attribute read); when on it builds a small dataclass and appends to a
  bounded deque under a short lock: no device synchronisation, no I/O, no
  allocation proportional to history (the ring drops the oldest span).
  Stamps come from the host clock only; nothing here touches the device.
* **Cross-process mergeable.** Worker processes stamp spans with their
  OWN ``perf_counter`` epoch; spans ship over the RPC frames as primitive
  tuples and are rebased onto the parent clock by subtracting the socket
  handshake's ``clock_offset``, the same rebase
  :func:`repro_torch.core.metrics.merge_record_streams` applies to records.
* **Self-verifying.** :meth:`Trace.reconcile` checks every request's span
  tree against its charged ``stage_s`` (root span present, span walls
  cover each charge within epsilon) and :meth:`Trace.tree_problems`
  checks per-thread non-overlap of process-level spans.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.metrics import mean, percentile

__all__ = [
    "Span", "TraceBuffer", "Trace", "tracer", "enable_tracing",
    "disable_tracing", "tracing_enabled", "spans_to_wire",
    "spans_from_wire", "validate_stamps",
]

DEFAULT_CAPACITY = 65536


@dataclass
class Span:
    """One timestamped pipeline hop.

    ``t_start``/``t_end`` are ``time.perf_counter`` stamps in the clock
    of the process named by ``process`` (after rebasing: the parent
    clock). ``request_id`` is None for process-level spans (decode
    windows, RPC frames, router decisions); request-scoped spans carry
    the id so :meth:`Trace.by_request` can build per-request trees.
    ``attrs`` holds primitive metadata only (mechanism, wire bytes,
    modeled-vs-measured charge provenance, ...).
    """

    name: str
    t_start: float
    t_end: float
    process: str = "main"
    thread: str = "main"
    request_id: Optional[int] = None
    attrs: dict = field(default_factory=dict)

    @property
    def wall(self) -> float:
        return max(self.t_end - self.t_start, 0.0)


def _span_to_wire(s: Span) -> tuple:
    return (s.name, s.t_start, s.t_end, s.process, s.thread,
            s.request_id, dict(s.attrs))


def spans_to_wire(spans) -> list:
    """Primitive-tuple wire form (the RPC payload)."""
    return [_span_to_wire(s) for s in spans]


def spans_from_wire(wire, offset: float = 0.0,
                    process: Optional[str] = None) -> list:
    """Rehydrate wire tuples, rebasing child-clock stamps onto the
    reference clock by subtracting ``offset`` (``child - parent``, the
    :class:`~repro_torch.serving.ipc.ReplicaClient` handshake estimate),
    the span analogue of
    :func:`repro_torch.core.metrics.merge_record_streams`.
    Durations are skew-invariant; only absolute placement moves.
    ``process`` overrides the recorded process label (e.g. "replica1").
    """
    out = []
    for (name, t0, t1, proc, thr, rid, attrs) in wire:
        out.append(Span(
            name=name, t_start=t0 - offset, t_end=t1 - offset,
            process=process if process is not None else proc,
            thread=thr, request_id=rid, attrs=dict(attrs),
        ))
    return out


class TraceBuffer:
    """Append-only ring buffer of spans, one per process.

    ``emit`` is the only hot-path entry point: a single ``enabled``
    attribute read when tracing is off. The ring (``deque(maxlen=...)``)
    bounds memory; overflow drops the OLDEST span and counts it in
    ``dropped`` so a truncated export is detectable, never silent.
    """

    # _spans, emitted and dropped are touched only under ``with
    # self._lock``; nothing blocks while the lock is held

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 process: str = "main"):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self.capacity = capacity
        self.process = process
        self.enabled = False
        self.emitted = 0
        self.dropped = 0

    def enable(self, process: Optional[str] = None, *, reset: bool = True):
        if process is not None:
            self.process = process
        if reset:
            self.clear()
        self.enabled = True

    def disable(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._spans.clear()
            self.emitted = 0
            self.dropped = 0

    def emit(self, name: str, t_start: float, t_end: float, *,
             request_id: Optional[int] = None,
             thread: Optional[str] = None, **attrs):
        """Record one span (no-op unless enabled)."""
        if not self.enabled:
            return
        span = Span(
            name=name, t_start=t_start, t_end=t_end, process=self.process,
            thread=(thread if thread is not None
                    else threading.current_thread().name),
            request_id=request_id, attrs=attrs,
        )
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(span)
            self.emitted += 1

    def snapshot(self) -> list:
        with self._lock:
            return list(self._spans)

    def drain(self) -> list:
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
            return out

    def drain_wire(self) -> list:
        """Drain as primitive tuples (what worker RPC replies carry)."""
        return spans_to_wire(self.drain())

    def ingest_wire(self, wire, offset: float = 0.0,
                    process: Optional[str] = None):
        """Fold a child process's drained spans in, rebased onto this
        process's clock. Bypasses the ``enabled`` gate: the spans were
        emitted under the CHILD's enablement and must not be lost just
        because the parent's own emitters are off."""
        spans = spans_from_wire(wire, offset=offset, process=process)
        if not spans:
            return
        with self._lock:
            for s in spans:
                if len(self._spans) == self.capacity:
                    self.dropped += 1
                self._spans.append(s)
            self.emitted += len(spans)

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "buffered": len(self._spans),
                "emitted": self.emitted,
                "dropped": self.dropped,
            }


_GLOBAL = TraceBuffer()


def tracer() -> TraceBuffer:
    """The process-global trace buffer (one per OS process)."""
    return _GLOBAL


def enable_tracing(process: Optional[str] = None,
                   capacity: Optional[int] = None, *,
                   reset: bool = True) -> TraceBuffer:
    if capacity is not None and capacity != _GLOBAL.capacity:
        with _GLOBAL._lock:
            _GLOBAL._spans = deque(_GLOBAL._spans, maxlen=capacity)
            _GLOBAL.capacity = capacity
    _GLOBAL.enable(process, reset=reset)
    return _GLOBAL


def disable_tracing():
    _GLOBAL.disable()


def tracing_enabled() -> bool:
    return _GLOBAL.enabled


def validate_stamps(t_arrival: float, t_first_token: float, t_done: float,
                    *, where: str = "", tol: float = 1e-9):
    """Debug-mode monotonicity check for the engine-filled Request
    stamps: ``t_arrival <= t_first_token <= t_done``. All three come
    from one ``perf_counter`` clock inside a single engine, so any
    violation means a stage clock ran backwards — in practice a bad
    cross-process rebase (wrong sign or stale ``clock_offset``).
    Raises ValueError naming the inversion."""
    ctx = f" ({where})" if where else ""
    if t_first_token and t_first_token + tol < t_arrival:
        raise ValueError(
            f"stamp inversion{ctx}: t_first_token {t_first_token:.6f} < "
            f"t_arrival {t_arrival:.6f}"
        )
    if t_done and t_first_token and t_done + tol < t_first_token:
        raise ValueError(
            f"stamp inversion{ctx}: t_done {t_done:.6f} < "
            f"t_first_token {t_first_token:.6f}"
        )
    if t_done and t_done + tol < t_arrival:
        raise ValueError(
            f"stamp inversion{ctx}: t_done {t_done:.6f} < "
            f"t_arrival {t_arrival:.6f}"
        )


class Trace:
    """Immutable view over a span list: export + self-verification."""

    def __init__(self, spans):
        self.spans = list(spans)

    @classmethod
    def from_buffer(cls, buf: Optional[TraceBuffer] = None) -> "Trace":
        return cls((buf or _GLOBAL).snapshot())

    def __len__(self) -> int:
        return len(self.spans)

    def processes(self) -> list:
        return sorted({s.process for s in self.spans})

    def by_request(self) -> dict:
        out: dict = {}
        for s in self.spans:
            if s.request_id is not None:
                out.setdefault(s.request_id, []).append(s)
        for spans in out.values():
            spans.sort(key=lambda s: (s.t_start, s.t_end))
        return out

    # ------------------------------------------------------------------ #
    # export
    # ------------------------------------------------------------------ #
    def chrome_events(self) -> dict:
        """Chrome trace-event JSON object (the ``export_chrome`` body).

        One "X" (complete) event per span — ``ts``/``dur`` in
        microseconds on the merged parent clock — plus "M" metadata
        events naming each process/thread, so Perfetto renders the
        gateway, router, replica engines and worker pipeline threads as
        labeled tracks."""
        pids: dict = {}
        tids: dict = {}
        events = []
        for proc in self.processes():
            pids[proc] = len(pids) + 1
            events.append({
                "ph": "M", "name": "process_name", "pid": pids[proc],
                "tid": 0, "args": {"name": proc},
            })
        for s in sorted(self.spans, key=lambda s: (s.t_start, s.t_end)):
            key = (s.process, s.thread)
            if key not in tids:
                tids[key] = len(tids) + 1
                events.append({
                    "ph": "M", "name": "thread_name", "pid": pids[s.process],
                    "tid": tids[key], "args": {"name": s.thread},
                })
            args = dict(s.attrs)
            if s.request_id is not None:
                args["request_id"] = s.request_id
            events.append({
                "ph": "X", "name": s.name, "pid": pids[s.process],
                "tid": tids[key], "ts": s.t_start * 1e6,
                "dur": s.wall * 1e6, "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path) -> dict:
        """Write Chrome trace-event JSON to ``path`` (load the file at
        https://ui.perfetto.dev or chrome://tracing). Returns the
        exported object."""
        obj = self.chrome_events()
        with open(path, "w") as f:
            json.dump(obj, f)
        return obj

    def stage_summary(self) -> str:
        """Text flamegraph-style per-span-name rollup: count, total
        wall, mean, p95 — sorted by total wall descending."""
        groups: dict = {}
        for s in self.spans:
            groups.setdefault(s.name, []).append(s.wall)
        rows = sorted(
            ((name, walls) for name, walls in groups.items()),
            key=lambda kv: -sum(kv[1]),
        )
        width = max((len(n) for n, _ in rows), default=4)
        lines = [f"{'span':<{width}}  {'count':>6}  {'total_ms':>9}  "
                 f"{'mean_ms':>8}  {'p95_ms':>8}"]
        for name, walls in rows:
            lines.append(
                f"{name:<{width}}  {len(walls):>6}  "
                f"{sum(walls) * 1e3:>9.3f}  {mean(walls) * 1e3:>8.3f}  "
                f"{percentile(walls, 0.95) * 1e3:>8.3f}"
            )
        return "\n".join(lines)

    # ------------------------------------------------------------------ #
    # self-verification
    # ------------------------------------------------------------------ #
    def tree_problems(self, eps: float = 2e-3) -> list:
        """Structural span-tree checks; returns problem strings.

        * Per request: exactly one root ``request`` span, every other
          span of that request inside the root interval (± eps).
        * Per (process, thread, engine tag): process-level spans
          (request_id None) must not overlap — each thread's timeline is
          sequential, so overlap means a clock went backwards or an
          interval was mis-stamped. Request-scoped spans are exempt: a
          batched admission legitimately gives co-admitted requests
          identical prefill intervals.
        """
        problems = []
        for rid, spans in self.by_request().items():
            roots = [s for s in spans if s.name == "request"]
            if len(roots) != 1:
                problems.append(
                    f"request {rid}: {len(roots)} root 'request' spans "
                    f"(want exactly 1)"
                )
                continue
            root = roots[0]
            for s in spans:
                if s is root:
                    continue
                if (s.t_start < root.t_start - eps
                        or s.t_end > root.t_end + eps):
                    problems.append(
                        f"request {rid}: span '{s.name}' "
                        f"[{s.t_start:.6f}, {s.t_end:.6f}] outside root "
                        f"[{root.t_start:.6f}, {root.t_end:.6f}]"
                    )
        lanes: dict = {}
        for s in self.spans:
            if s.request_id is not None:
                continue
            key = (s.process, s.thread, s.attrs.get("tag", ""))
            lanes.setdefault(key, []).append(s)
        for key, spans in lanes.items():
            spans.sort(key=lambda s: (s.t_start, s.t_end))
            for a, b in zip(spans, spans[1:]):
                if b.t_start < a.t_end - eps:
                    problems.append(
                        f"lane {key}: '{b.name}' starts {a.t_end - b.t_start:.6f}s "
                        f"before '{a.name}' ends"
                    )
        return problems

    def reconcile(self, records, eps: float = 2e-3) -> list:
        """Check span trees against charged ``stage_s``; returns problem
        strings (empty = reconciled).

        For every record whose request has spans: the request's total
        span wall (root included) must cover EACH charged stage within
        ``eps`` — measured stages (queue/preprocess/inference) happen
        inside the root interval by construction, and modeled charges
        (request/response/copy, profile-modeled transfer) are folded
        into ``t_done`` at finish, so the root wall bounds them too. A
        charge exceeding every span the request ever emitted means the
        trace lost a hop or an interval was mis-stamped."""
        by_req = self.by_request()
        problems = []
        n_checked = 0
        for rec in records:
            spans = by_req.get(rec.request_id)
            if spans is None:
                continue
            n_checked += 1
            total_wall = sum(s.wall for s in spans)
            for stage, charge in rec.stage_s.items():
                if total_wall + eps < charge:
                    problems.append(
                        f"request {rec.request_id}: stage '{stage}' charge "
                        f"{charge:.6f}s exceeds total span wall "
                        f"{total_wall:.6f}s"
                    )
        if n_checked == 0:
            problems.append("no record had any spans to reconcile against")
        return problems + self.tree_problems(eps=eps)
