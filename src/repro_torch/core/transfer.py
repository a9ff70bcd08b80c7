"""Prefill -> decode KV transfer: the paper's three mechanisms as real data
paths between the prefill stage's device and the decode stage's.

The JAX package's ``core/transfer.py`` realises them as a collective
permute across a mesh "pod" axis (its ``pod_tile`` / ``pod_take`` only
shape a payload for that permute; a copy to the destination takes their
place here). Each mechanism moves the payload from the source (prefill)
device into decode-side buffers on the destination device, disjoint from
the prefill artifact, with the copy counts of
``Transport.handoff_copies``; on one card the two devices are that card:

  DIRECT_HBM  (GDR)  : one device-to-device copy into the landing buffers
                       (across two cards a peer copy, the GDR analogue).
  DIRECT_DMA  (RDMA) : source device -> pinned host bounce buffer ->
                       destination device.
  HOST_STAGED (TCP)  : each float leaf requantized to int8 with one fp32
                       scale, copied device -> pageable host, copied again
                       on the CPU (the stack staging), host -> device, then
                       dequantized to the leaf's dtype. Integer leaves
                       (slot metadata) cross at full width.

The wire format follows the JAX package's leaves, not the port's: JAX
stacks a layer group's caches into one leaf per (group, layer-in-block,
key), where the port keeps one tensor per layer. :func:`wire_leaves`
regroups the port's tree that way and :func:`pack` lays each group out as
one flat tensor, so every mechanism moves a JAX leaf in one piece (one
copy, not one per layer), HOST_STAGED takes one scale per JAX leaf, and
:func:`payload_wire_bytes` counts its 4 scale bytes once per JAX leaf: the
int8 payload, the scales and the byte counts equal JAX's.

On CUDA the hop runs on a dedicated stream on the destination device,
fenced by events against the work queued before it on the source device
(the prefill, the previous splice) and the work queued after it on the
destination (the splice, the decode step); the quantize, on the source's
tensors, runs on the source device's stream, ahead of its copies.
:func:`move` returns once the landed payload is complete on the
destination. Packing and the buffers (:class:`HopBuffers`) come apart from the
move: a caller keeps one set of buffers, grows it outside its timed
window (:meth:`HopBuffers.fit`) and times the move alone. A failed pinned
allocation or copy raises; no mechanism falls back to another.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from contextlib import nullcontext

import torch

from repro_torch.core.transport import Transport


class TransferMode(enum.Enum):
    DIRECT_HBM = "direct_hbm"  # GDR
    DIRECT_DMA = "direct_dma"  # RDMA
    HOST_STAGED = "host_staged"  # TCP


# Inter-stage mechanism -> the transport whose calibrated constants time it.
MODE_TRANSPORT = {
    TransferMode.DIRECT_HBM: Transport.GDR,
    TransferMode.DIRECT_DMA: Transport.RDMA,
    TransferMode.HOST_STAGED: Transport.TCP,
}


def _quantizes(dtype) -> bool:
    """HOST_STAGED requantizes float payloads to int8; everything else
    (slot metadata, token ids) crosses at full width."""
    return dtype.is_floating_point


def wire_itemsize(dtype, mode: TransferMode) -> int:
    """Bytes per element a leaf of ``dtype`` crosses the hop at."""
    if mode is TransferMode.HOST_STAGED and _quantizes(dtype):
        return 1  # int8 payload; the fp32 scale is counted separately
    return dtype.itemsize


def leaf_paths(tree, path=()):
    """``(path, tensor)`` for every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, path + (i,))
    else:
        yield path, tree


def wire_leaves(tree) -> list:
    """The tree's tensors grouped as the JAX package's leaves: one group
    per path with the list indices (a layer group's layers) dropped, each a
    list of ``(path, tensor)`` in layer order."""
    groups: dict = {}
    for path, t in leaf_paths(tree):
        key = tuple(p for p in path if not isinstance(p, int))
        groups.setdefault(key, []).append((path, t))
    return list(groups.values())


def payload_wire_bytes(tree, mode: TransferMode) -> int:
    """Bytes the hop moves for ``tree`` under ``mode``, counted as the JAX
    package's ``payload_wire_bytes`` counts them: each JAX leaf at its wire
    itemsize, plus one fp32 scale per quantized JAX leaf."""
    total = 0
    for leaf in wire_leaves(tree):
        dtype = leaf[0][1].dtype
        total += sum(t.numel() for _, t in leaf) * wire_itemsize(dtype, mode)
        if mode is TransferMode.HOST_STAGED and _quantizes(dtype):
            total += 4
    return total


def rebuild(tree, values: dict, path=()):
    """``tree``'s structure with each leaf replaced by ``values[path]``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [rebuild(v, values, path + (i,)) for i, v in enumerate(tree)]
    return values[path]


@dataclasses.dataclass
class Packed:
    """A tree in the hop's wire layout: one flat tensor per JAX leaf
    (``flats``), holding the leaf's port tensors back to back in layer
    order, as JAX's stacked leaf holds its layers; ``tree`` keeps the
    structure and ``leaves`` each flat's ``(path, shape)`` list."""

    tree: object
    leaves: list
    flats: list

    def unpack(self):
        """The tree again, each leaf a view into its flat."""
        views = {}
        for leaf, flat in zip(self.leaves, self.flats):
            off = 0
            for path, shape in leaf:
                n = math.prod(shape)
                views[path] = flat[off:off + n].view(shape)
                off += n
        return rebuild(self.tree, views)


def pack(tree) -> Packed:
    """Lay ``tree`` out for the hop: each JAX leaf's layers stacked into one
    new flat tensor (a copy, disjoint from the tree)."""
    leaves = wire_leaves(tree)
    return Packed(tree, [[(p, tuple(t.shape)) for p, t in leaf]
                         for leaf in leaves],
                  [torch.stack([t for _, t in leaf]).view(-1)
                   for leaf in leaves])


class HopBuffers:
    """Everything one mechanism writes, one set per JAX leaf: ``land``, the
    landing flats on the destination (decode) device; for DIRECT_DMA
    ``host``, the pinned bounce flats; for HOST_STAGED ``stages``, the
    flats the wire format passes through -- (source device, pageable host,
    CPU staging, destination device) -- for the int8 or full-width payload
    and, for a float leaf, its one-element fp32 scale. Every buffer is 1-D
    and holds the largest extent seen so far; a payload moves through their
    leading elements. ``dst_device`` defaults to ``src_device`` (one
    device: prefill and decode on the same card, or the CPU); the hop's
    stream lives on the destination."""

    def __init__(self, mode: TransferMode, src_device, dst_device=None):
        self.mode = mode
        self.src_device = torch.device(src_device)
        self.device = torch.device(src_device if dst_device is None
                                   else dst_device)
        cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self.land: list = []
        self.host: list = []
        self.stages: list = []

    def _host(self, n: int, dtype):
        """Host flat of ``n`` elements: pinned for DIRECT_DMA on CUDA, else
        pageable with its pages touched here, so the move takes no page
        fault."""
        if self.mode is TransferMode.DIRECT_DMA:
            return torch.empty((n,), dtype=dtype,
                               pin_memory=self.device.type == "cuda")
        return torch.zeros((n,), dtype=dtype)

    def fit(self, payload: Packed):
        """Grow the buffers of every leaf ``payload`` outgrows."""
        for i, flat in enumerate(payload.flats):
            if i == len(self.land):
                for lst in (self.land, self.host, self.stages):
                    lst.append(None)
            have = self.land[i]
            if (have is not None and have.dtype == flat.dtype
                    and have.numel() >= flat.numel()):
                continue
            n, dev, quant = flat.numel(), self.device, _quantizes(flat.dtype)
            src = self.src_device
            self.land[i] = torch.empty((n,), dtype=flat.dtype, device=dev)
            if self.mode is TransferMode.DIRECT_DMA:
                self.host[i] = self._host(n, flat.dtype)
            elif self.mode is TransferMode.HOST_STAGED:
                # a full-width leaf leaves from its own flat: no first stage
                parts = ([(n, torch.int8), (1, torch.float32)] if quant
                         else [(n, flat.dtype)])
                self.stages[i] = [
                    (torch.empty((k,), dtype=wdt, device=src) if quant
                     else None, self._host(k, wdt), self._host(k, wdt),
                     torch.empty((k,), dtype=wdt, device=dev))
                    for k, wdt in parts]


def quantize(flat, q, s):
    """Write one JAX leaf's int8 values into ``q`` and its fp32 scale into
    the one-element ``s``, as the JAX package's ``kv_transfer`` computes
    them on its 1-pod mesh: one scale over the whole leaf, ``max|x|``
    floored at 1e-6 over 127 in the leaf's dtype, then ``round(x / scale)``
    clipped to +-127."""
    scale = torch.clamp(flat.abs().amax(), min=1e-6) / 127.0
    s.copy_(scale.reshape(1))
    q.copy_((flat / scale).round_().clamp_(-127, 127))


def _stage(src, host, staging, dst):
    """device -> pageable host (returns once the copy is done), the CPU
    staging copy, host -> device."""
    host.copy_(src)
    staging.copy_(host)
    dst.copy_(staging)


def move(payload: Packed, bufs: HopBuffers) -> Packed:
    """Move a packed payload (on ``bufs.src_device``) through ``bufs``'
    mechanism into its landing flats on ``bufs.device`` (grown to fit by
    :meth:`HopBuffers.fit` beforehand) and return it landed, complete on
    the destination: one copy per JAX leaf for DIRECT_HBM, two through the
    pinned bounce for DIRECT_DMA."""
    mode, stream = bufs.mode, bufs.stream
    if stream is not None:
        ready = torch.cuda.Event()
        # everything queued so far on the source: prefill, last splice
        ready.record(torch.cuda.current_stream(bufs.src_device))
        stream.wait_event(ready)
    landed = []
    with torch.cuda.stream(stream) if stream is not None else nullcontext():
        for i, flat in enumerate(payload.flats):
            n = flat.numel()
            land = bufs.land[i][:n]
            if mode is TransferMode.DIRECT_HBM:
                land.copy_(flat, non_blocking=True)
            elif mode is TransferMode.DIRECT_DMA:
                host = bufs.host[i][:n]
                host.copy_(flat, non_blocking=True)
                if stream is not None and bufs.src_device != bufs.device:
                    # the bounce-in ran on the source device's stream
                    landed_host = torch.cuda.Event()
                    landed_host.record(
                        torch.cuda.current_stream(bufs.src_device))
                    stream.wait_event(landed_host)
                land.copy_(host, non_blocking=True)
            elif _quantizes(flat.dtype):
                (q, qh, qs, qd), (s, sh, ss, sd) = bufs.stages[i]
                quantize(flat, q[:n], s)
                _stage(q[:n], qh[:n], qs[:n], qd[:n])
                _stage(s, sh, ss, sd)
                torch.mul(qd[:n], sd, out=land)  # fp32, cast to land's dtype
            else:
                (_, wh, ws, wd), = bufs.stages[i]
                _stage(flat, wh[:n], ws[:n], wd[:n])
                land.copy_(wd[:n])
            landed.append(land)
    if stream is not None:
        done = torch.cuda.Event()
        done.record(stream)
        # the splice and the decode steps after it, on the destination
        torch.cuda.current_stream(bufs.device).wait_event(done)
        done.synchronize()
    return Packed(payload.tree, payload.leaves, landed)
