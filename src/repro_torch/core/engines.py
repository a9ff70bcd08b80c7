"""Accelerator engine models (paper §II-D, §VI).

ExecutionEngines — priority-aware processor sharing with bounded effective
parallelism. One inference alone runs at rate 1; concurrent work shares an
aggregate capacity ``C_eff`` (the workload's measured concurrency headroom on
the device — small kernels leave more SM slack than dense ones). Priority
streams are allocated capacity FIRST at fine granularity (the paper's
"priority-accommodating round-robin" at kernel-block level); normal streams
split the remainder. In-flight host<->device copies steal a fraction of
capacity (paper finding 3: issuing copies interferes with execution).

CopyEngines — ``n`` DMA engines serving whole requests FCFS, non-preemptive,
priority-BLIND: the coarse request-granularity interleave that strips
priority clients of their advantage under RDMA (paper Fig. 16) and that GDR
sidesteps entirely.

Stage times are recorded QUEUE-INCLUSIVE (submission -> completion), matching
how the paper measures with CUDA events.

A copy of the JAX package's ``core/engines.py`` (plain Python; it models
the paper's A2 testbed and touches no device).

Sharing modes (paper §VI-C):
  multi-stream : all clients' streams share one context (default).
  multi-context: contexts time-slice the engines (only the active context
                 runs); a context switch costs capacity.
  mps          : stream-like packing; copies issue from separate processes,
                 hiding most of the copy<->exec interference.
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque


class Sim:
    """Minimal discrete-event loop."""

    def __init__(self):
        self.now = 0.0
        self._heap = []
        self._ctr = itertools.count()

    def schedule(self, delay: float, fn, *args):
        heapq.heappush(self._heap, (self.now + delay, next(self._ctr), fn, args))

    def run(self, until: float = float("inf")):
        while self._heap:
            t, _, fn, args = heapq.heappop(self._heap)
            if t > until:
                break
            self.now = max(self.now, t)
            fn(*args)


class ExecutionEngines:
    def __init__(
        self,
        sim: Sim,
        capacity: float = 4.0,  # workload C_eff (aggregate speedup bound)
        mode: str = "multi-stream",
        max_streams: int = 0,  # 0 = one stream per client (unlimited)
        ctx_slice_s: float = 2e-3,
        ctx_switch_penalty: float = 0.85,  # multi-context capacity factor
    ):
        self.sim = sim
        self.capacity = float(capacity)
        self.mode = mode
        self.max_streams = max_streams
        self.ctx_slice_s = ctx_slice_s
        self.ctx_switch_penalty = ctx_switch_penalty
        self.interference = 0.0  # capacity stolen by in-flight copies

        self.active: dict = {}  # job -> remaining solo-seconds
        self._rates: dict = {}
        self._last = 0.0
        self._version = 0
        self._admitted = 0
        self._admit_q: deque = deque()
        # multi-context rotation
        self._contexts: set = set()
        self._active_ctx = None
        self._rotating = False

    # -- public API --------------------------------------------------------- #
    def submit(self, job, work_s: float, cb, *, preprocess_s: float = 0.0):
        job._exec_phases = [
            (n, d) for n, d in (("preprocess", preprocess_s), ("inference", work_s))
            if d > 0
        ]
        job._exec_cb = cb
        if self.max_streams and self._admitted >= self.max_streams:
            self._admit_q.append(job)
        else:
            self._admit(job)

    # -- admission ----------------------------------------------------------- #
    def _admit(self, job):
        self._admitted += 1
        self._contexts.add(job.client_id)
        if self.mode == "multi-context" and not self._rotating:
            self._rotating = True
            self._active_ctx = job.client_id
            self.sim.schedule(self.ctx_slice_s, self._rotate_ctx)
        self._next_phase(job)

    def _next_phase(self, job):
        if not job._exec_phases:
            self._admitted -= 1
            if self._admit_q:
                self._admit(self._admit_q.popleft())
            job._exec_cb()
            return
        stage, dur = job._exec_phases.pop(0)
        job._phase = stage
        job._phase_t0 = self.sim.now
        self._sync()
        self.active[job] = dur
        self._reallocate()

    # -- processor sharing --------------------------------------------------- #
    def _eff_capacity(self) -> float:
        c = self.capacity - self.interference
        if self.mode == "multi-context":
            c *= self.ctx_switch_penalty
        return max(c, 0.05)

    def _runnable(self, job) -> bool:
        if self.mode != "multi-context" or self._active_ctx is None:
            return True
        return job.client_id == self._active_ctx

    def _sync(self):
        dt = self.sim.now - self._last
        if dt > 0:
            for j, r in self._rates.items():
                if j in self.active:
                    self.active[j] = max(0.0, self.active[j] - r * dt)
        self._last = self.sim.now

    def _compute_rates(self) -> dict:
        cap = self._eff_capacity()
        rates = {j: 0.0 for j in self.active}
        for prio in (1, 0):
            jobs = [j for j in self.active if j.priority == prio and self._runnable(j)]
            if not jobs or cap <= 0:
                continue
            # equal split capped at solo rate 1
            share = cap / len(jobs)
            for j in jobs:
                rates[j] = min(1.0, share)
            cap -= sum(rates[j] for j in jobs)
            cap = max(cap, 0.0)
        return rates

    def _reallocate(self):
        self._sync()
        self._rates = self._compute_rates()
        self._version += 1
        nxt = None
        for j, rem in self.active.items():
            r = self._rates.get(j, 0.0)
            if r > 0:
                t = rem / r
                if nxt is None or t < nxt[0]:
                    nxt = (t, j)
        if nxt is not None:
            self.sim.schedule(max(nxt[0], 0.0), self._maybe_finish, self._version)

    def _maybe_finish(self, version):
        if version != self._version:
            return  # stale event
        self._sync()
        done = [j for j, rem in self.active.items() if rem <= 1e-12]
        if not done:
            self._reallocate()
            return
        for j in done:
            del self.active[j]
            self._rates.pop(j, None)
            j.record.add(j._phase, self.sim.now - j._phase_t0)
        self._reallocate()
        for j in done:
            self._next_phase(j)

    def _rotate_ctx(self):
        if not self.active and not self._admit_q:
            self._rotating = False
            self._active_ctx = None
            return
        live = sorted({j.client_id for j in self.active}) or sorted(self._contexts)
        if live:
            if self._active_ctx not in live:
                self._active_ctx = live[0]
            else:
                self._active_ctx = live[(live.index(self._active_ctx) + 1) % len(live)]
        self._reallocate()
        self.sim.schedule(self.ctx_slice_s, self._rotate_ctx)

    def set_interference(self, value: float):
        self.interference = value
        self._reallocate()


class CopyEngines:
    """H2D/D2H DMA FIFO queues with HEAD-OF-LINE blocking (paper §VI).

    CUDA apps enqueue a request's H2D *and* D2H in stream-issue order; the
    copy engines pop strictly FIFO and are non-preemptive, so a D2H whose
    stream's kernels haven't finished BLOCKS the engine — and every copy
    queued behind it, priority or not. This request-granularity interleave is
    exactly what erodes priority clients under RDMA (paper Fig. 16) and what
    GDR sidesteps.

    MPS mode: each client/process gets its own queue (engines round-robin
    across queues), so cross-client head-of-line blocking disappears — the
    paper's hypothesis for why MPS beats multi-stream under RDMA (Fig. 17).

    Recorded copy time is queue-inclusive. In-flight copies steal
    ``interference`` execution capacity each (paper finding 3).
    """

    def __init__(self, sim: Sim, n: int = 2, exec_engines=None,
                 interference: float = 0.35, per_client_queues: bool = False):
        self.sim = sim
        self.n = n
        self.exec = exec_engines
        self.interference = interference
        self.per_client = per_client_queues
        self.busy = 0
        self._queues: dict = {}  # key -> deque of items
        self._rr: deque = deque()  # round-robin order of queue keys
        self._idle_engines = n
        self._waiting: dict = {}  # job -> (engine resume) for blocked D2H

    # -- enqueue ------------------------------------------------------------- #
    def _key(self, job):
        return job.client_id if self.per_client else 0

    def _push(self, item, job):
        k = self._key(job)
        if k not in self._queues:
            self._queues[k] = deque()
            self._rr.append(k)
        self._queues[k].append(item)
        self._drain()

    def enqueue_h2d(self, job, dur: float, cb):
        job._h2d_cb = cb
        if dur <= 0:
            cb()
            return
        self._push(("h2d", job, dur, self.sim.now), job)

    def enqueue_d2h(self, job, dur: float, cb):
        """Issued at submit time (stream order); runs once job._exec_done."""
        job._d2h_cb = cb
        job._d2h_dur = dur
        job._exec_done = False
        self._push(("d2h", job, dur, self.sim.now), job)

    def notify_exec_done(self, job):
        job._exec_done = True
        job._exec_done_t = self.sim.now
        resume = self._waiting.pop(job, None)
        if resume is not None:
            resume()

    # -- engine loop ---------------------------------------------------------- #
    def _next_item(self):
        for _ in range(len(self._rr)):
            k = self._rr[0]
            self._rr.rotate(-1)
            q = self._queues.get(k)
            if q:
                return q.popleft()
        return None

    def _drain(self):
        while self._idle_engines > 0:
            item = self._next_item()
            if item is None:
                return
            self._idle_engines -= 1
            self._start(item)

    def _start(self, item):
        kind, job, dur, t0 = item
        if kind == "d2h" and not job._exec_done:
            # head-of-line block: this engine sits on the copy until the
            # stream's kernels complete
            self._waiting[job] = lambda: self._run(item)
            return
        self._run(item)

    def _run(self, item):
        kind, job, dur, t0 = item
        self.busy += 1
        self._set_interference()
        self.sim.schedule(dur, self._done, item)

    def _done(self, item):
        kind, job, dur, t0 = item
        self.busy -= 1
        self._idle_engines += 1
        self._set_interference()
        # queue-inclusive, but D2H measures from exec completion (the paper's
        # synchronous cudaMemcpy starts there) — not from stream issue time
        if kind == "d2h":
            t0 = max(t0, getattr(job, "_exec_done_t", t0))
        job.record.add("copy_in" if kind == "h2d" else "copy_out",
                       self.sim.now - t0)
        self._drain()
        (job._h2d_cb if kind == "h2d" else job._d2h_cb)()

    def _set_interference(self):
        if self.exec is not None:
            self.exec.set_interference(self.busy * self.interference)
