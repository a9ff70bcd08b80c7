"""End-to-end model-serving cluster simulator (paper §III).

Deterministic discrete-event reproduction of the paper's testbed: closed-loop
clients -> (optional gateway) -> GPU server, with the transport mechanism,
copy engines, execution engines, sharing mode, stream limits and priorities
all pluggable. Service times come from calibrated workloads
(core/workloads.py) or from roofline-derived LLM serve steps.

The real-compute twin of this simulator (serving/engine.py) runs the same
pipeline with PyTorch models on the card; this module is what sweeps the
paper's 10+ scenario grids in milliseconds. A copy of the JAX package's
``core/simulator.py``: every service time, copy engine and wire rate it
uses is the paper's A2 + TensorRT testbed model (``PAPER_A2``,
``TABLE_II``), never a reading of an H100.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.engines import CopyEngines, ExecutionEngines, Sim
from repro_torch.core.profiler import ProfileStore, RequestRecord
from repro_torch.core.transport import PAPER_A2, Transport, TransportProfile
from repro_torch.core.workloads import Workload


@dataclasses.dataclass(eq=False)  # identity-hashable: jobs key the PS tables
class Job:
    request_id: int
    client_id: int
    priority: int
    record: RequestRecord


@dataclasses.dataclass
class ScenarioConfig:
    workload: Workload
    transport: Transport = Transport.GDR
    # proxied connection: client->gateway transport (None = direct connection)
    first_hop: Optional[Transport] = None
    n_clients: int = 1
    n_priority_clients: int = 0
    requests_per_client: int = 200
    preprocessed: bool = False  # client sends model-ready tensors
    profile: TransportProfile = PAPER_A2
    sharing: str = "multi-stream"  # multi-stream | multi-context | mps
    max_streams: int = 0  # 0 = one stream per client
    exec_capacity: int = 10  # A2: 10 execution engines
    gateway_overhead_s: float = 40e-6
    client_think_s: float = 0.0
    # service-time jitter (fraction). Real GPUs convoy: without jitter a
    # deterministic closed loop spreads work perfectly and copy queues never
    # form (paper Figs. 12-13 show they do).
    jitter: float = 0.20
    seed: int = 0


class Server:
    def __init__(self, sim: Sim, cfg: ScenarioConfig, store: ProfileStore):
        import random

        self.sim = sim
        self.cfg = cfg
        self.store = store
        self._rng = random.Random(cfg.seed)
        self.exec = ExecutionEngines(
            sim,
            capacity=cfg.workload.concurrency,
            mode=cfg.sharing if cfg.sharing != "mps" else "multi-stream",
            max_streams=cfg.max_streams,
        )
        # MPS: copies issue from separate processes -> per-process queues, no
        # cross-client head-of-line blocking, and less copy<->exec
        # interference (paper §VI-C hypothesis).
        interference = cfg.profile.copy_exec_interference
        if cfg.sharing == "mps":
            interference *= 0.4
        self.copy = CopyEngines(
            sim,
            n=cfg.profile.n_copy_engines,
            exec_engines=self.exec,
            interference=interference,
            per_client_queues=(cfg.sharing == "mps"),
        )

    def _jit(self, dur: float) -> float:
        j = self.cfg.jitter
        return dur * self._rng.uniform(1 - j, 1 + j) if j else dur

    # pipeline: [copy_in] -> preprocess -> inference -> [copy_out] -> respond.
    # For staged transports BOTH copies are enqueued up front (stream issue
    # order) — the D2H head-of-line blocks its copy engine until exec is done.
    def handle(self, job: Job, done_cb):
        cfg = self.cfg
        w = cfg.workload
        nbytes_in = w.in_bytes(cfg.preprocessed)
        t = cfg.transport
        pre = 0.0 if cfg.preprocessed else self._jit(w.t_pre_s)
        work = self._jit(w.t_inf_s)

        if not t.uses_copy_engine:
            self.exec.submit(job, work, done_cb, preprocess_s=pre)
            return

        def after_h2d():
            self.exec.submit(job, work, after_exec, preprocess_s=pre)

        def after_exec():
            self.copy.notify_exec_done(job)

        self.copy.enqueue_h2d(job, self._jit(cfg.profile.copy_time(nbytes_in)),
                              after_h2d)
        self.copy.enqueue_d2h(job, self._jit(cfg.profile.copy_time(w.out_bytes)),
                              done_cb)


class Cluster:
    """Clients (+gateway) + server wiring for one scenario."""

    def __init__(self, cfg: ScenarioConfig):
        self.cfg = cfg
        self.sim = Sim()
        self.store = ProfileStore()
        self.server = Server(self.sim, cfg, self.store)
        self._next_id = 0

    # ------------------------------------------------------------------ #
    def _wire_times(self, nbytes_in: int, nbytes_out: int):
        """(request_s, response_s, cpu_s) across the 1 or 2 hops."""
        cfg = self.cfg
        p = cfg.profile
        req = p.wire_time(cfg.transport, nbytes_in)
        rsp = p.wire_time(cfg.transport, nbytes_out)
        cpu = 0.0
        if cfg.transport is Transport.TCP:
            cpu += (nbytes_in + nbytes_out) * p.tcp_cpu_per_byte
        if cfg.first_hop is not None:  # proxied: client->gateway hop
            req += p.wire_time(cfg.first_hop, nbytes_in) + cfg.gateway_overhead_s
            rsp += p.wire_time(cfg.first_hop, nbytes_out) + cfg.gateway_overhead_s
            if cfg.first_hop is Transport.TCP:
                cpu += (nbytes_in + nbytes_out) * p.tcp_cpu_per_byte
        return req, rsp, cpu

    def _issue(self, client_id: int, priority: int, remaining: int):
        if remaining <= 0:
            return
        cfg = self.cfg
        w = cfg.workload
        rec = RequestRecord(
            request_id=self._next_id, client_id=client_id, priority=priority,
            t_issue=self.sim.now,
            bytes_in=w.in_bytes(cfg.preprocessed), bytes_out=w.out_bytes,
        )
        self._next_id += 1
        job = Job(rec.request_id, client_id, priority, rec)
        req_s, rsp_s, cpu_s = self._wire_times(rec.bytes_in, rec.bytes_out)
        rec.cpu_s = cpu_s
        rec.add("request", req_s)

        def at_server():
            self.server.handle(job, served)

        def served():
            rec.add("response", rsp_s)
            self.sim.schedule(rsp_s, completed)

        def completed():
            rec.t_done = self.sim.now
            self.store.add(rec)
            self.sim.schedule(
                cfg.client_think_s, self._issue, client_id, priority, remaining - 1
            )

        self.sim.schedule(req_s, at_server)

    def run(self) -> ProfileStore:
        cfg = self.cfg
        for c in range(cfg.n_clients):
            prio = 1 if c < cfg.n_priority_clients else 0
            # tiny deterministic stagger so clients don't tie on every event
            self.sim.schedule(c * 1e-5, self._issue, c, prio, cfg.requests_per_client)
        self.sim.run()
        return self.store


def run_scenario(cfg: ScenarioConfig) -> ProfileStore:
    return Cluster(cfg).run()


def local_reference(cfg: ScenarioConfig) -> float:
    """Local-processing latency (paper's lower bound): pre + inference only."""
    w = cfg.workload
    pre = 0.0 if cfg.preprocessed else w.t_pre_s
    return pre + w.t_inf_s
