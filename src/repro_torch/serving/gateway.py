"""Gateway / proxied-connection tier (paper §IV-B), a copy of the JAX
package's ``serving/gateway.py``.

Wraps an engine (or a downstream gateway) and adds the first-hop transport
cost plus the protocol-translation overhead. Composing
``Gateway(TCP) -> engine(GDR)`` is the paper's TCP/GDR configuration — the
"accelerate only the last hop" deployment that captures most of the benefit.
"""

from __future__ import annotations

import time

from repro_torch.core import trace
from repro_torch.core.transport import PAPER_A2, Transport, TransportProfile


class Gateway:
    def __init__(self, engine, *, first_hop: Transport = Transport.TCP,
                 profile: TransportProfile = PAPER_A2,
                 translation_overhead_s: float = 40e-6):
        self.engine = engine
        self.first_hop = first_hop
        self.profile = profile
        self.overhead = translation_overhead_s

    def submit(self, req, now: float):
        self.engine.submit(req, now)
        rec = self.engine._records[req.request_id]
        hop = self.profile.wire_time(self.first_hop, rec.bytes_in)
        rec.add("request", hop + self.overhead)
        # instant span: the hop cost is MODELED (profile wire time), not a
        # measured wall — the duration rides as an attr, not the interval
        trace.tracer().emit(
            "gateway.submit", now, now, request_id=req.request_id,
            hop_s=hop + self.overhead, transport=self.first_hop.name,
            bytes=rec.bytes_in, charge="modeled",
        )
        if self.first_hop is Transport.TCP:
            rec.cpu_s += rec.bytes_in * self.profile.tcp_cpu_per_byte

    def step(self):
        done = self.engine.step()
        for rsp in done:
            nbytes = 4 * len(rsp.tokens)
            hop = self.profile.wire_time(self.first_hop, nbytes) + self.overhead
            rsp.stage_s["response"] = rsp.stage_s.get("response", 0.0) + hop
            rsp.total_s += hop
            tnow = time.perf_counter()
            trace.tracer().emit(
                "gateway.response", tnow, tnow, request_id=rsp.request_id,
                hop_s=hop, transport=self.first_hop.name, bytes=nbytes,
                charge="modeled",
            )
            rec = self._records.get(rsp.request_id)
            if rec is not None:
                # charge the STORED record symmetrically with ``submit``'s
                # request hop: the returned Response alone would leave
                # ProfileStore under-reporting gateway deployments
                # (stage_s["response"] short one hop, t_done stale).
                # Request.t_done keeps the ENGINE-side completion stamp —
                # the gateway only sees Responses, so end-to-end time lives
                # on the record and the Response, not the Request.
                rec.add("response", hop)
                rec.t_done += hop
                if self.first_hop is Transport.TCP:
                    # TCP keeps the CPU on the data path on BOTH hops
                    # (paper Fig. 9)
                    rec.cpu_s += nbytes * self.profile.tcp_cpu_per_byte
        return done

    def run_until_drained(self, max_steps: int = 10_000):
        out = []
        for _ in range(max_steps):
            got = self.step()
            out.extend(got)
            if self.engine.idle:
                break
            if not got and self.async_draining:
                # downstream progress happens on its own threads or in
                # replica processes; polling harder only burns the CPU
                # the paper's TCP path is trying to account for
                time.sleep(0.001)
        return out

    @property
    def queue(self):
        return self.engine.queue

    @property
    def idle(self):
        return self.engine.idle

    @property
    def async_draining(self) -> bool:
        """True when the wrapped engine drains on its own (threaded
        pipeline / process replicas) — stepping just collects results."""
        return bool(getattr(self.engine, "async_draining", False))

    @property
    def _records(self):
        return self.engine._records

    @property
    def store(self):
        return self.engine.store

    def close(self):
        """Pass shutdown downstream (process-backed clusters reap their
        workers); no-op over plain engines."""
        down = getattr(self.engine, "close", None)
        if callable(down):
            down()

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
