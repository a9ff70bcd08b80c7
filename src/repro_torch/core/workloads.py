"""Serving workloads.

Two families:
  1. The paper's Table II DNNs (exact GFLOPs / input / output shapes) with
     service times calibrated to the paper's measurements on the A2 +
     TensorRT testbed — used by the figure-reproduction benchmarks.
  2. The LLM architectures, whose per-request service times are DERIVED
     from a dry-run's roofline terms (max of compute/memory time on the
     production mesh) — this is how the paper's methodology composes with
     the rest of this framework.

A copy of the JAX package's ``core/workloads.py``. Table II's service times
are the paper's testbed (an A2 with TensorRT), not H100 readings.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    gflops: float
    in_bytes_raw: int  # client submits raw data (server preprocesses)
    in_bytes_pre: int  # client submits preprocessed tensors
    out_bytes: int
    t_pre_s: float  # GPU preprocessing time (resize + normalize)
    t_inf_s: float  # GPU inference time (single request, no contention)
    # aggregate concurrency headroom on the device: how many copies of this
    # model the GPU can effectively run before throughput saturates (small
    # kernels leave SM slack; dense ones don't). Calibrated per paper Figs
    # 11/15/16.
    concurrency: float = 3.0

    def in_bytes(self, preprocessed: bool) -> int:
        return self.in_bytes_pre if preprocessed else self.in_bytes_raw


def _img(c, h, w, fp=True):
    return c * h * w * (4 if fp else 1)


# Paper Table II. Raw images: camera-resolution uint8 JPEG-decoded frames
# (640x480x3); preprocessed: model-shape fp32 tensors.
# t_inf calibrated to the paper's reported local-processing latencies.
TABLE_II = {
    "mobilenetv3": Workload(
        "mobilenetv3", 0.06, _img(3, 480, 640, False), _img(3, 224, 224),
        1000 * 4, 0.45e-3, 0.9e-3, concurrency=10.0,
    ),
    "efficientnetb0": Workload(
        "efficientnetb0", 0.39, _img(3, 480, 640, False), _img(3, 224, 224),
        1000 * 4, 0.45e-3, 1.6e-3, concurrency=8.0,
    ),
    "resnet50": Workload(
        "resnet50", 4.1, _img(3, 480, 640, False), _img(3, 224, 224),
        1000 * 4, 0.45e-3, 2.85e-3, concurrency=1.6,
    ),
    "wideresnet101": Workload(
        "wideresnet101", 22.81, _img(3, 480, 640, False), _img(3, 224, 224),
        1000 * 4, 0.45e-3, 20.5e-3, concurrency=2.0,
    ),
    "yolov4": Workload(
        "yolov4", 128.46, _img(3, 720, 1280, False), _img(3, 416, 416),
        sum(s * s * 3 * 85 * 4 for s in (13, 26, 52)), 0.9e-3, 48e-3,
        concurrency=3.5,
    ),
    "deeplabv3": Workload(
        "deeplabv3", 178.72, _img(3, 720, 1280, False), _img(3, 520, 520),
        2 * 21 * 520 * 520 * 4, 1.1e-3, 105e-3, concurrency=1.6,
    ),
}


def llm_workload(arch: str, shape_name: str = "decode_32k",
                 results_dir: str | None = None) -> Workload:
    """Build a serving workload for an assigned arch from its dry-run roofline.

    Service time = max(compute, memory) roofline term of the serve_step on
    the single-pod mesh; ingress = one request's token + sampling params;
    egress = logits-topk. For disaggregated serving the ingress payload is
    the prefill-produced KV cache slice (the transfer the paper's GDR vs
    staged comparison acts on).
    """
    import json
    import os

    from repro_torch.configs import get_config, get_shape

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    results_dir = results_dir or os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "experiments",
        "dryrun_torch")
    path = os.path.join(results_dir, f"{arch}__{shape_name}__16x16.json")
    with open(path) as f:
        r = json.load(f)
    t_inf = max(r["t_compute"], r["t_memory"]) + r["t_collective"]
    # per-token ingress/egress for one decode step across the whole batch
    b = shape.global_batch
    return Workload(
        name=f"{arch}:{shape_name}",
        gflops=r["hlo_flops"] * r["chips"] / 1e9,
        in_bytes_raw=b * 8,  # token ids + params
        in_bytes_pre=b * 8,
        out_bytes=b * 4 * 32,  # top-k logits
        t_pre_s=0.0,
        t_inf_s=t_inf,
    )
