"""Meshes and the hardware constants of the roofline.

A :class:`LogicalMesh` is axis names and sizes, no devices: what the
sharding rules (``repro_torch.sharding.partition.make_rules``) and the
dry-run (``repro_torch.launch.dryrun``) read. The meshes are the JAX
package's: the production mesh 16 x 16 (``data``, ``model``) or, multi-pod,
2 x 16 x 16 (``pod``, ``data``, ``model``); a 1 x 1 stand-in with the same
axis names.

A :class:`DeviceMesh` is axis names over an array of ``torch.device``s:
what tensors are placed on (``sharding.partition``: the pod slices, the
sequence- and vocab-sharded decode, the sharded training step). Its
``shape`` reads as a ``LogicalMesh``'s, so ``make_rules`` takes either.
The serving meshes are the JAX package's: :func:`make_serving_pod_mesh`,
the 1-D ``('pod',)`` mesh the disaggregated tier carves its prefill and
decode slices from, and :func:`make_cluster_mesh`, the one a
multi-replica cluster carves into replica slices; :func:`make_train_mesh`
is the ``('data', 'model')`` mesh the training launcher runs on. All take
the devices the host has and never repeat one.

Per-device constants, from the NVIDIA H100 Tensor Core GPU datasheet (H100
SXM5, 80 GB of HBM3): dense peaks (no sparsity) and HBM3 bandwidth. The
collective term's link is a GPU's own NDR 400 Gb/s InfiniBand port (50 GB/s
a direction): an HGX board joins 8 GPUs by NVLink (900 GB/s a GPU, 450 GB/s
a direction), so a 16-wide axis spans two boards and its ring crosses
InfiniBand.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

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
    """One device with the same axis names (tests, a one-card roofline,
    the dry-run)."""
    return LogicalMesh(("data", "model"), (1, 1))


def _device(d) -> torch.device:
    """``d`` as a torch.device, a card named without its index given the
    current one's (as a tensor placed on "cuda" is)."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceMesh:
    """Axis names over an array of ``torch.device``s, one a mesh slot (the
    JAX package's ``jax.sharding.Mesh``). ``shape`` maps each axis name to
    its size, in order, as :class:`LogicalMesh`'s does; a slot is its
    coordinate, one index an axis.

    A mesh built by hand may name one device in several slots: the port's
    stand-in for JAX's forced host devices. The CPU is one torch device and
    a one-card host has one, so a 1 x 4 mesh over ``[cpu] * 4``
    (or ``[cuda:0] * 4``) runs the real shard arithmetic there -- four
    sequence shards, four kernel launches -- where JAX would run it on four
    devices. On a host with several cards the same code places the shards
    on distinct cards. The default meshes below never repeat a device.
    Meshes are equal when their axis names and devices are."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} for axes "
                             f"{axis_names}")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [_device(d) for d in arr.flat]
        self.axis_names = axis_names
        self.sizes = tuple(int(n) for n in arr.shape)
        self._devices = flat.reshape(arr.shape)

    @property
    def devices(self) -> np.ndarray:
        """The slots' devices as an array of the mesh's shape (a copy)."""
        return self._devices.copy()

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def device_list(self) -> tuple:
        """Every slot's device, row-major (a device repeats where the mesh
        repeats it)."""
        return tuple(self._devices.flat)

    @property
    def first_device(self) -> torch.device:
        """Where the port keeps every tensor that lives whole: slot 0's."""
        return self._devices.flat[0]

    def coords(self):
        """Every slot's coordinate, row-major."""
        return itertools.product(*(range(n) for n in self.sizes))

    def device_at(self, coord) -> torch.device:
        return self._devices[tuple(coord)]

    def __eq__(self, other):
        return (isinstance(other, DeviceMesh)
                and self.axis_names == other.axis_names
                and self.sizes == other.sizes
                and self.device_list == other.device_list)

    def __hash__(self):
        return hash((self.axis_names, self.sizes, self.device_list))

    def __repr__(self):
        return (f"DeviceMesh({self.shape}, "
                f"{[str(d) for d in self.device_list]})")


def available_devices(device="cuda") -> list:
    """The devices of ``device``'s type this host has: every card, in
    index order, or the one CPU."""
    from repro_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def make_serving_pod_mesh(npods=None, device="cuda") -> DeviceMesh:
    """``('pod',)``-axis serving mesh over the first ``npods`` devices of
    ``device``'s type (the JAX package's ``make_serving_pod_mesh``).

    Defaults to 2 pods when the host has at least two such devices, else
    the 1-pod mesh, where both stages of the disaggregated tier share the
    one device. Re-exported as ``repro_torch.serving.make_pod_mesh``."""
    avail = available_devices(device)
    npods = min(2, len(avail)) if npods is None else npods
    if npods > len(avail):
        raise ValueError(f"npods {npods} > available devices {len(avail)}")
    return DeviceMesh(avail[:npods], ("pod",))


def make_train_mesh(n_data=None, device="cuda") -> DeviceMesh:
    """``('data', 'model')`` training mesh over the host's devices of
    ``device``'s type (the JAX package's production mesh, at the host's
    size): ``n_data`` x 1 slots over the first ``n_data`` devices (default:
    every one). FSDP alone: every leaf split over its ``embed`` dim. A mesh
    built by hand may name a device several times (``DeviceMesh``)."""
    avail = available_devices(device)
    n_data = len(avail) if n_data is None else n_data
    if not 1 <= n_data <= len(avail):
        raise ValueError(f"a {n_data}-way data mesh over {len(avail)} "
                         "device(s)")
    return DeviceMesh([[d] for d in avail[:n_data]], ("data", "model"))


def make_cluster_mesh(n_replicas: int, pods_per_replica: int = 1,
                      device="cuda") -> DeviceMesh:
    """``('pod',)``-axis mesh for an ``n_replicas``-replica serving cluster
    (the JAX package's ``make_cluster_mesh``): ``n_replicas *
    pods_per_replica`` slots -- ``pods_per_replica`` 1 for fused replicas,
    2 for disaggregated ones -- clamped to the devices of ``device``'s type
    the host has, so on one card every replica's slice is that card
    (``serving.cluster.replica_pod_slices`` wraps them modulo the axis)."""
    if n_replicas < 1 or pods_per_replica < 1:
        raise ValueError(
            f"need n_replicas >= 1 and pods_per_replica >= 1: "
            f"({n_replicas}, {pods_per_replica})")
    avail = available_devices(device)
    need = n_replicas * pods_per_replica
    return DeviceMesh(avail[:min(need, len(avail))], ("pod",))
