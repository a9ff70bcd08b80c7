"""Serving request/response types (a copy of the JAX package's
``serving/request.py``)."""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    prompt_tokens: np.ndarray  # [S] int32
    max_new_tokens: int = 16
    priority: int = 0
    client_id: int = 0
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    features: Optional[np.ndarray] = None  # vlm/audio stub payload
    # filled by the engine — all three stamps come from ONE clock
    # (time.perf_counter), so ttft/total latencies are clock-consistent
    # regardless of what the caller passes to submit().
    t_arrival: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    generated: list = dataclasses.field(default_factory=list)

    @property
    def payload_bytes(self) -> int:
        n = self.prompt_tokens.nbytes
        if self.features is not None:
            n += self.features.nbytes
        return n


@dataclasses.dataclass
class Response:
    request_id: int
    tokens: list
    ttft_s: float  # time to first token (perf_counter deltas)
    total_s: float
    stage_s: dict
