"""Transport mechanisms and their calibrated latency models (paper §II-III).

Four mechanisms, mirroring the paper exactly:

  LOCAL : no network — client shares the accelerator (lower bound).
  TCP   : ZeroMQ-style stream over the host stack. CPU is on the data path:
          per-message syscall/stack overhead + low effective bandwidth
          (stack traversal + staging copies), then an H2D/D2H copy through
          the accelerator's copy engine.
  RDMA  : RNIC DMAs into pinned HOST memory (CPU bypassed), but the payload
          still crosses the copy engine to reach device HBM.
  GDR   : GPUDirect RDMA — RNIC DMAs straight into device HBM. No copy
          engine, no CPU.

Calibration (``PAPER_A2`` profile) reproduces the paper's testbed numbers:
ConnectX-5 25 GbE, NVIDIA A2 (2 copy engines, PCIe gen4 x8), TensorRT.
Checks (paper §IV): ResNet50 preprocessed 602 KB -> TCP is ~0.61 ms slower
than RDMA; GDR saves a further ~0.2 ms by skipping H2D/D2H; GDR adds only
0.27-0.53 ms over local processing.

A copy of the JAX package's ``core/transport.py`` holding only the paper's
own testbed calibration: the port states no number taken on or for a TPU
host.
"""

from __future__ import annotations

import dataclasses
import enum


class Transport(enum.Enum):
    LOCAL = "local"
    TCP = "tcp"
    RDMA = "rdma"
    GDR = "gdr"

    @property
    def uses_copy_engine(self) -> bool:
        return self in (Transport.TCP, Transport.RDMA)

    @property
    def uses_network(self) -> bool:
        return self is not Transport.LOCAL

    @property
    def handoff_copies(self) -> int:
        """Copy-engine hops on an inter-stage (prefill->decode) handoff:
        TCP pays stack staging + H2D, RDMA one pinned-host bounce, GDR
        lands straight in destination HBM (paper §II)."""
        return {Transport.TCP: 2, Transport.RDMA: 1}.get(self, 0)


@dataclasses.dataclass(frozen=True)
class TransportProfile:
    """Latency/bandwidth constants for one deployment."""

    name: str
    # network wire
    tcp_base_s: float  # per-message stack + serialization-free zmq overhead
    tcp_bw: float  # effective B/s through the host stack
    rdma_base_s: float  # RDMA_WRITE posting + WC latency
    rdma_bw: float  # RNIC line rate B/s
    gdr_base_s: float
    gdr_bw: float  # GDR effective B/s (slightly below line rate)
    # host <-> device copy engine
    copy_base_s: float  # cudaMemcpy launch + completion overhead
    copy_bw: float  # PCIe effective B/s
    n_copy_engines: int
    # fraction of an execution-engine slot consumed while a copy is in
    # flight (paper finding 3: issuing copies interferes with execution)
    copy_exec_interference: float
    # TCP keeps the CPU on the data path (paper Fig. 9)
    tcp_cpu_per_byte: float = 0.0

    def tcp_eff_bw(self, nbytes: int) -> float:
        """TCP/ZeroMQ throughput collapses for large payloads (socket-buffer
        and staging-copy pressure): ~tcp_bw below 1 MB, asymptoting to
        ~0.55*tcp_bw. RDMA/GDR stay linear — hardware offload (paper §II)."""
        mb = 1e6
        if nbytes <= mb:
            return self.tcp_bw
        return self.tcp_bw * (0.55 + 0.45 * (mb / nbytes))

    def wire_time(self, transport: Transport, nbytes: int) -> float:
        if transport is Transport.LOCAL or nbytes == 0:
            return 0.0
        if transport is Transport.TCP:
            return self.tcp_base_s + nbytes / self.tcp_eff_bw(nbytes)
        if transport is Transport.RDMA:
            return self.rdma_base_s + nbytes / self.rdma_bw
        return self.gdr_base_s + nbytes / self.gdr_bw

    def copy_time(self, nbytes: int) -> float:
        if nbytes == 0:
            return 0.0
        return self.copy_base_s + nbytes / self.copy_bw

    def handoff_time(self, transport: Transport, nbytes: int) -> float:
        """Inter-stage (prefill->decode) handoff latency: wire time plus the
        staging copy-engine hops the mechanism cannot skip. ``nbytes`` must
        already be the on-wire count (int8-requantized for the TCP/staged
        mechanism — see ``transfer.transfer_bytes``)."""
        return (self.wire_time(transport, nbytes)
                + transport.handoff_copies * self.copy_time(nbytes))


# Calibrated against the paper's reported deltas (see module docstring).
PAPER_A2 = TransportProfile(
    name="paper_a2",
    tcp_base_s=150e-6,
    tcp_bw=1.0e9,
    rdma_base_s=5e-6,
    rdma_bw=3.0e9,
    gdr_base_s=6e-6,
    gdr_bw=2.9e9,
    # A2 is a low-profile PCIe card: effective H2D/D2H ~3.75 GB/s (fits the
    # paper's Fig. 8 RDMA data-movement fractions on DeepLabV3).
    copy_base_s=30e-6,
    copy_bw=2.5e9,
    n_copy_engines=2,
    copy_exec_interference=0.35,
    tcp_cpu_per_byte=1.0 / 2.0e9,
)
