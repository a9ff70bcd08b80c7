"""Fine-grained pipeline profiling (paper Table I).

Every request carries a stage-timestamped record; the store aggregates the
paper's metric set per client / per stage: total-time, request-time,
response-time, copy-time (H2D + D2H), preprocessing-time, inference-time,
CPU usage and memory usage proxies.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

from repro_torch.core.metrics import summarize

STAGES = (
    "request",  # client -> server wire (+ gateway hop)
    "copy_in",  # H2D through the copy engine (TCP/RDMA only)
    "queue",  # waiting for an execution lane
    "preprocess",
    "transfer",  # inter-stage KV handoff (disaggregated prefill -> decode)
    "inference",
    "copy_out",  # D2H
    "response",  # server -> client wire
)


@dataclasses.dataclass
class RequestRecord:
    request_id: int
    client_id: int
    priority: int = 0
    t_issue: float = 0.0
    t_done: float = 0.0
    stage_s: dict = dataclasses.field(default_factory=dict)
    cpu_s: float = 0.0  # host-CPU busy time attributable to this request
    bytes_in: int = 0
    bytes_out: int = 0
    # wall clock actually spent in the inter-stage handoff collective; when
    # the charged "transfer" stage is profile-modeled instead (host-device
    # runs), the engine swaps this measured wall out of ttft/total
    transfer_wall_s: float = 0.0

    def add(self, stage: str, dur: float):
        self.stage_s[stage] = self.stage_s.get(stage, 0.0) + dur

    @property
    def total(self) -> float:
        return self.t_done - self.t_issue

    @property
    def copy_time(self) -> float:
        return self.stage_s.get("copy_in", 0.0) + self.stage_s.get("copy_out", 0.0)

    @property
    def data_movement(self) -> float:
        """copy + request + transfer + response (the paper's 'data movement'
        fraction, plus the disaggregated inter-stage hop)."""
        return (
            self.copy_time
            + self.stage_s.get("request", 0.0)
            + self.stage_s.get("transfer", 0.0)
            + self.stage_s.get("response", 0.0)
        )

    @property
    def processing(self) -> float:
        return self.stage_s.get("preprocess", 0.0) + self.stage_s.get("inference", 0.0)


class ProfileStore:
    def __init__(self):
        self.records: list[RequestRecord] = []

    def add(self, rec: RequestRecord):
        self.records.append(rec)

    def totals(self, client_id: Optional[int] = None, priority=None):
        return [
            r.total
            for r in self.records
            if (client_id is None or r.client_id == client_id)
            and (priority is None or r.priority == priority)
        ]

    def stage_means(self, client_id: Optional[int] = None) -> dict:
        sums = defaultdict(float)
        n = 0
        for r in self.records:
            if client_id is not None and r.client_id != client_id:
                continue
            n += 1
            for s in STAGES:
                sums[s] += r.stage_s.get(s, 0.0)
        return {s: (sums[s] / n if n else 0.0) for s in STAGES}

    def breakdown_fractions(self) -> dict:
        means = self.stage_means()
        tot = summarize(self.totals())["mean"]
        return {s: (v / tot if tot else 0.0) for s, v in means.items()}

    def summary(self, **filt) -> dict:
        return summarize(self.totals(**filt))

    def processing_cov(self) -> float:
        from repro_torch.core.metrics import cov

        return cov([r.processing for r in self.records])

    def cpu_per_request(self) -> float:
        return summarize([r.cpu_s for r in self.records])["mean"]
