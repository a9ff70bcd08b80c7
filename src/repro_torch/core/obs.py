"""Unified metrics registry: counters, gauges, histograms and a sampler
(a copy of the JAX package's ``core/obs.py``).

The engines keep ad-hoc counter attributes (``prefill_padded_tokens``,
prefix hit counters, IPC byte counters, pipeline conservation counts),
each queryable only by knowing where it lives. This module gives them one
surface: a :class:`Registry` of named instruments with snapshot/delta
semantics, wired into ``ServingCluster.telemetry()`` (each replica's
engine counters are absorbed via :meth:`Registry.ingest_counters`), plus a
background :class:`Sampler` that polls queue depth and slot occupancy into
histograms while a drain runs.

The engines keep charging their plain integer attributes on the hot path
(a bare ``+=``: no lock, nothing that waits on the device); the registry is
the *query* plane, built from those attributes at telemetry time. Only the
sampler's histograms take a lock, and never on an engine hot path.
"""

from __future__ import annotations

import threading
import traceback
from collections import deque
from typing import Callable, Optional

from repro_torch.core.metrics import percentile

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "Sampler"]


class Counter:
    """Monotonic accumulator (events, bytes, tokens)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease: {n}")
        self.value += n


class Gauge:
    """Point-in-time value (queue depth, free slots)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v):
        self.value = v


class Histogram:
    """Bounded-window distribution (sampler output).

    Keeps running count/total plus a sliding window of the last
    ``window`` observations for percentiles — snapshot percentiles are
    over that window, count/total over the full lifetime."""

    # _window, count, total, vmin and vmax are touched only under ``with
    # self._lock``; nothing blocks while the lock is held

    def __init__(self, name: str, window: int = 4096):
        self.name = name
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=window)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._window.append(v)
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v

    def snapshot(self) -> dict:
        with self._lock:
            win = list(self._window)
            count, total = self.count, self.total
            vmin, vmax = self.vmin, self.vmax
        return {
            "count": count,
            "total": total,
            "mean": total / count if count else 0.0,
            "min": vmin if count else 0.0,
            "max": vmax if count else 0.0,
            "p50": percentile(win, 0.50),
            "p95": percentile(win, 0.95),
        }


class Registry:
    """Named instruments behind one get-or-create surface.

    ``snapshot()`` returns plain nested dicts (JSON-safe, what
    ``ServingCluster.telemetry()`` embeds); ``delta(prev, cur)`` gives
    counter increments between two snapshots."""

    # _metrics is touched only under ``with self._lock``; nothing blocks
    # while the lock is held

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self._get(name, Histogram, window=window)

    def ingest_counters(self, mapping: dict, prefix: str = ""):
        """Absorb a plain ``{name: int}`` counter dict (the engines'
        ad-hoc attribute counters) as monotonic counters."""
        for name, value in mapping.items():
            c = self.counter(prefix + name)
            c.inc(max(int(value) - c.value, 0))

    def snapshot(self) -> dict:
        with self._lock:
            metrics = list(self._metrics.values())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in metrics:
            if isinstance(m, Counter):
                out["counters"][m.name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.name] = m.value
            else:
                out["histograms"][m.name] = m.snapshot()
        return out

    @staticmethod
    def delta(prev: dict, cur: dict) -> dict:
        """Counter increments between two ``snapshot()`` dicts."""
        pc = prev.get("counters", {})
        return {
            name: value - pc.get(name, 0)
            for name, value in cur.get("counters", {}).items()
        }


class Sampler:
    """Background poller: every ``interval_s``, call each source and
    observe the value into a same-named histogram in ``registry``.

    Sources are zero-arg callables (queue depth, occupancy, ...) read
    OUTSIDE any registry lock; a failing source is captured into
    ``errors`` (never swallowed, never fatal to the other sources) and
    surfaced by :meth:`stop`."""

    def __init__(self, registry: Registry,
                 sources: dict[str, Callable[[], float]],
                 interval_s: float = 0.005):
        self.registry = registry
        self.sources = dict(sources)
        self.interval_s = interval_s
        self.errors: list = []
        self.samples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run(self):
        try:
            while not self._stop.is_set():
                for name, fn in self.sources.items():
                    try:
                        v = fn()
                    except Exception:
                        self.errors.append(
                            f"sampler source {name!r} failed:\n"
                            f"{traceback.format_exc()}"
                        )
                        continue
                    self.registry.histogram(name).observe(v)
                    self.samples += 1
                self._stop.wait(self.interval_s)
        except BaseException:
            # capture, don't vanish: stop() re-raises for the caller
            self.errors.append(
                f"sampler thread failed:\n{traceback.format_exc()}"
            )

    def start(self) -> "Sampler":
        if self._thread is not None:
            raise RuntimeError("sampler already started")
        self._thread = threading.Thread(
            target=self._run, name="obs-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0, *, check: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        if check and self.errors:
            raise RuntimeError(
                "sampler captured failures:\n" + "\n".join(self.errors)
            )

    def __enter__(self) -> "Sampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(check=exc[0] is None)
