"""Serving tier of the port: the fused engine on its bucketed ring path, its
paged path with radix prefix reuse and its exact-shape path, the threaded
host pipeline, the disaggregated prefill->decode tier, the gateway (the
proxied first hop), the multi-replica cluster (in-process or a process a
replica), the pod placement of the tier's stages and of the cluster's
replicas on a device mesh, and seeded traffic for them."""

from repro_torch.serving.client import ClosedLoopClient, run_closed_loop
from repro_torch.serving.cluster import Replica, Router, ServingCluster
from repro_torch.serving.disagg import (
    DisaggregatedEngine,
    PodPlacement,
    make_pod_mesh,
)
from repro_torch.serving.engine import (
    DecodePool,
    EnginePipeline,
    PrefillArtifact,
    ServingEngine,
)
from repro_torch.serving.gateway import Gateway
from repro_torch.serving.loadgen import (
    Arrival,
    load_trace,
    poisson_schedule,
    run_closed_loop_baseline,
    run_open_loop,
    save_trace,
    trace_schedule,
)
from repro_torch.serving.request import Request, Response

__all__ = [
    "Arrival",
    "ClosedLoopClient",
    "DecodePool",
    "DisaggregatedEngine",
    "EnginePipeline",
    "Gateway",
    "PodPlacement",
    "PrefillArtifact",
    "Replica",
    "Request",
    "Response",
    "Router",
    "ServingCluster",
    "ServingEngine",
    "load_trace",
    "make_pod_mesh",
    "poisson_schedule",
    "run_closed_loop",
    "run_closed_loop_baseline",
    "run_open_loop",
    "save_trace",
    "trace_schedule",
]
