"""Serving tier of the port: the fused engine on its bucketed ring path, its
paged path with radix prefix reuse and its exact-shape path, the
disaggregated prefill->decode tier, and seeded traffic for them."""

from repro_torch.serving.client import ClosedLoopClient, run_closed_loop
from repro_torch.serving.disagg import DisaggregatedEngine
from repro_torch.serving.engine import DecodePool, PrefillArtifact, ServingEngine
from repro_torch.serving.request import Request, Response

__all__ = [
    "ClosedLoopClient",
    "DecodePool",
    "DisaggregatedEngine",
    "PrefillArtifact",
    "Request",
    "Response",
    "ServingEngine",
    "run_closed_loop",
]
