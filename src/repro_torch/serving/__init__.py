"""Serving tier of the port: the fused engine on its bucketed ring path and
its paged path with radix prefix reuse, and seeded traffic for it."""

from repro_torch.serving.client import ClosedLoopClient, run_closed_loop
from repro_torch.serving.engine import DecodePool, PrefillArtifact, ServingEngine
from repro_torch.serving.request import Request, Response

__all__ = [
    "ClosedLoopClient",
    "DecodePool",
    "PrefillArtifact",
    "Request",
    "Response",
    "ServingEngine",
    "run_closed_loop",
]
