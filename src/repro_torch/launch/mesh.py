"""Logical meshes and the hardware constants of the roofline.

A :class:`LogicalMesh` is axis names and sizes, no devices: what the
sharding rules (``repro_torch.sharding.partition.make_rules``) and the
dry-run (``repro_torch.launch.dryrun``) read. The meshes are the JAX
package's: the production mesh 16 x 16 (``data``, ``model``) or, multi-pod,
2 x 16 x 16 (``pod``, ``data``, ``model``); a 1 x 1 stand-in with the same
axis names. Placing tensors on several cards is not done here.

Per-device constants, from the NVIDIA H100 Tensor Core GPU datasheet (H100
SXM5, 80 GB of HBM3): dense peaks (no sparsity) and HBM3 bandwidth. The
collective term's link is a GPU's own NDR 400 Gb/s InfiniBand port (50 GB/s
a direction): an HGX board joins 8 GPUs by NVLink (900 GB/s a GPU, 450 GB/s
a direction), so a 16-wide axis spans two boards and its ring crosses
InfiniBand.
"""

from __future__ import annotations

import dataclasses
import math

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bf16 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12  # FLOP/s, fp32 on the CUDA cores
HBM_BW = 3.35e12  # B/s
LINK_BW = 50e9  # B/s a direction: NDR 400 Gb/s InfiniBand, one port a GPU


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Axis names and sizes of a mesh, no devices. ``shape`` maps each axis
    name to its size, in order, as a JAX ``Mesh``'s does."""

    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes {self.sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        """'16x16', '2x16x16', '1x1': the dry-run's record names."""
        return "x".join(str(n) for n in self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    if multi_pod:
        return LogicalMesh(("pod", "data", "model"), (2, 16, 16))
    return LogicalMesh(("data", "model"), (16, 16))


def make_local_mesh() -> LogicalMesh:
    """One device with the same axis names (tests, a one-card roofline)."""
    return LogicalMesh(("data", "model"), (1, 1))
