"""Disaggregated prefill->decode serving tier of the port.

A :class:`DisaggregatedEngine` runs admission and prefill as one stage and
the decode slot pool as another, and hands each admission's KV cache and
slot metadata from the first to the second through one of the paper's
mechanisms (``core.transfer``):

  DIRECT_HBM  (GDR)  : one device-to-device copy into landing buffers.
  DIRECT_DMA  (RDMA) : through one pinned host bounce buffer.
  HOST_STAGED (TCP)  : int8-requantized payload through pageable host
                       memory and a CPU staging copy, CPU on the data path.

The JAX package's ``serving/disagg.py`` moves the payload across a mesh
"pod" axis. On one H100 both stages share the card and one copy of the
weights, as the JAX tier's stages share one committed replica on its
degenerate 1-pod mesh; the handoff is real all the same: it lands in
decode-side buffers disjoint from the prefill artifact, on a stream of
its own.

The hop moves only the valid KV prefix: the artifact's occupied rows and
the longest row's length, both rounded up to powers of two (the prefix
floored at ``HANDOFF_BLOCK``), plus the rows' slot metadata as int32
tensors. The paged path moves the bucket-width SUFFIX cache: reused prefix
KV lives in a prefill-side block store and in decode-pool blocks, so it
crosses the hop once, when first computed. A packed admission hops as a
bucketed one does (its unpacked artifact has the same shape); a chunked
admission computes every chunk against its prior on the prefill side and
hops once, with its final chunk. Three byte counters reconcile:
``handoff_wire_bytes`` is ``payload_wire_bytes`` of what moved,
``handoff_request_bytes`` the per-request true prefixes (lower by the
rounding only), and on the paged path ``handoff_payload_bytes``, computed
from the admission plan alone, equals ``handoff_wire_bytes`` exactly.

Each request's 'transfer' stage is charged the measured hop wall (its
share of it) on a CUDA device, or the calibrated
``profile.handoff_time(hop, wire_share)`` on the CPU, where a host copy
says nothing about the mechanisms; there the measured wall is swapped out
of the latency stamps (:meth:`_ttft_adjust`). TCP also charges the CPU
``tcp_cpu_per_byte`` per wire byte.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import transfer as xfer
from repro_torch.core.transfer import (
    MODE_TRANSPORT,
    TransferMode,
    _quantizes,
    payload_wire_bytes,
    wire_itemsize,
)
from repro_torch.core.transport import Transport
from repro_torch.models import kvcache as kvc
from repro_torch.serving.engine import (
    PAGE,
    PrefillArtifact,
    ServingEngine,
    _next_pow2,
)

HANDOFF_BLOCK = 16  # smallest moved KV prefix, in ring slots
# per-row int32 slot metadata on the hop: lengths/next_tokens/slot/max_new
_META_BYTES = 16
# paged handoffs also carry cached_lens (the reused-prefix split)
_META_BYTES_PAGED = 20


class DisaggregatedEngine(ServingEngine):
    """ServingEngine whose prefill output crosses the prefill->decode hop
    under ``transfer_mode`` before it reaches the decode slot pool. Every
    other argument is the fused engine's.

    ``warmup=True`` runs the fused engine's :meth:`~ServingEngine.warm`
    once the tier is built (its prefix store included). The JAX tier also
    pre-traces its grid of handoff extents; eager PyTorch compiles nothing
    per extent, so there is no such grid here: the hop's buffers grow at
    the first handoffs, and that allocation is kept out of 'preprocess'."""

    def __init__(self, model, params, *,
                 transfer_mode: TransferMode = TransferMode.DIRECT_HBM,
                 warmup: bool = False, **kw):
        if kw.get("legacy"):
            raise ValueError("the disaggregated tier requires the fast path "
                             "(legacy=True is the fused engine's baseline)")
        super().__init__(model, params, **kw)
        self.transfer_mode = transfer_mode
        self.hop = MODE_TRANSPORT[transfer_mode]
        self.handoffs = 0
        self.handoff_wire_bytes = 0  # bytes the mechanism moved
        self.handoff_request_bytes = 0  # useful bytes (true KV prefixes)
        # paged reconciliation oracle: the wire bytes the admission plan
        # implies (rows x suffix bucket x per-token wire bytes + metadata),
        # never read off the payload; equals handoff_wire_bytes exactly
        self.handoff_payload_bytes = 0
        self.handoff_wall_s = 0.0
        # shape/dtype template of the dense max_batch x max_seq cache tree
        # (meta tensors: no memory) for the byte accountants
        self._dense_template = {
            g: [{name: kvc.init_layer_cache(shapes, model.dtype, "meta")
                 for name, shapes in block.items()} for block in group]
            for g, group in model.cache_specs(self.max_batch,
                                              self.max_seq).items()}
        # the hop's buffers, grown to the largest extent seen
        self._bufs = xfer.HopBuffers(transfer_mode, self.device)
        if self.prefix_reuse:
            # prefill-side prefix store: suffix prefills gather their prior
            # here, and its blocks pair 1:1 with decode-pool blocks in the
            # radix index's payloads
            self._store_pool = kvc.PagedKVPool(
                self.pool.allocator.num_blocks, PAGE)
            self._prefix_store_blocks = kvc.init_paged(
                model.cache_specs(self.max_batch, self.max_seq),
                self._store_pool.num_blocks, PAGE, dtype=model.dtype,
                device=self.device)
        if warmup:
            self.warm_s = self.warm()

    # ------------------------------------------------------------------ #
    def _measured(self) -> bool:
        """Charge the measured hop on a card, the modelled one on the CPU
        (the JAX tier's ``charge="auto"``)."""
        return self.device.type == "cuda"

    def _wire_isz(self, leaf) -> int:
        return wire_itemsize(leaf.dtype, self.transfer_mode)

    def handoff_prefix(self, true_len: int) -> int:
        """Ring slots the hop moves for a ``true_len``-token row: the next
        power of two, floored at ``HANDOFF_BLOCK``, clamped to max_seq."""
        p = max(_next_pow2(max(true_len, 1)), HANDOFF_BLOCK)
        return min(p, self.max_seq)

    def _prefix_extent(self, art: PrefillArtifact) -> tuple[int, int]:
        """(rows, prefix) the hop carries: both powers of two, rows clamped
        to the artifact's width (extra rows are its own dummy rows)."""
        n = min(_next_pow2(max(art.n_rows, 1)), len(art.slot_idx))
        return n, self.handoff_prefix(art.prefix_len)

    def request_handoff_bytes(self, true_len: int) -> int:
        """Wire bytes one request's KV prefix and slot metadata take under
        this deployment's mechanism (paged: ``true_len`` is the uncached
        suffix, and the metadata row is wider)."""
        meta = _META_BYTES_PAGED if self.paged else _META_BYTES
        return meta + kvc.request_cache_nbytes(
            self._dense_template, true_len, itemsize=self._wire_isz)

    def padded_tree_wire_bytes(self) -> int:
        """Wire bytes of the full max_batch x max_seq cache tree plus
        full-width slot metadata: the baseline a prefix-only handoff is
        held against."""
        meta = {k: torch.empty((self.max_batch,), dtype=torch.int32,
                               device="meta")
                for k in ("lengths", "next_tokens", "slot_idx", "max_new")}
        return payload_wire_bytes(
            {"caches": self._dense_template, "meta": meta},
            self.transfer_mode)

    def _meta(self, art: PrefillArtifact, n: int) -> dict:
        meta = {
            "lengths": art.lengths[:n],
            "next_tokens": art.next_tokens[:n],
            "slot_idx": torch.as_tensor(art.slot_idx[:n], dtype=torch.int32,
                                        device=self.device),
            "max_new": art.max_new[:n],
        }
        if self.paged:
            meta["cached_lens"] = torch.as_tensor(
                art.cached_lens[:n], dtype=torch.int32, device=self.device)
        return meta

    def _wire_payload(self, art: PrefillArtifact, n: int, prefix: int):
        """What the hop moves for one admission, packed in the wire layout
        (the JAX tier's slice jit): the [rows, prefix] cache slice and those
        rows' slot metadata. The port's artifact is at bucket width, and
        ``prefix`` never exceeds it (the bucket is the next power of two of
        the longest row, floored at the same 16), so the slice needs no
        regrow."""
        return xfer.pack({"caches": kvc.slice_cache(art.caches, n, prefix),
                          "meta": self._meta(art, n)})

    def _paged_geometry_bytes(self, n: int, L: int) -> int:
        """Wire bytes of an [n rows x L suffix tokens] paged payload from
        the admission plan alone: per-token wire bytes of the dense
        template times the extent, per-row metadata, and HOST_STAGED's
        scale per JAX leaf."""
        total = n * _META_BYTES_PAGED
        for leaf in xfer.wire_leaves(self._dense_template):
            dtype = leaf[0][1].dtype
            per_tok = sum(t.numel() for _, t in leaf) // (
                self.max_batch * self.max_seq)
            total += n * L * per_tok * wire_itemsize(dtype,
                                                     self.transfer_mode)
            if (self.transfer_mode is TransferMode.HOST_STAGED
                    and _quantizes(dtype)):
                total += 4
        return total

    # ------------------------------------------------------------------ #
    # prefill-side prefix store (paged reuse)
    # ------------------------------------------------------------------ #
    def _store_alloc(self):
        return self._store_pool if self.prefix_reuse else self.pool.allocator

    def _prior_blocks(self):
        return self._prefix_store_blocks

    def _store_alloc_blocks(self, n: int) -> list:
        """Allocate prefill-store blocks, evicting cold index pages under
        pressure (each eviction releases both payload sides)."""
        while True:
            got = self._store_pool.alloc(n)
            if got is not None:
                return got
            payload = self.prefix_index.evict_lru()
            if payload is None:
                raise RuntimeError("prefill-side prefix store exhausted with "
                                   "no evictable index pages")
            self._evict_index_page(payload)

    def _store_prepare(self, jobs: list, caches, L: int):
        """Scatter each job's fully-in-prompt suffix pages into the
        prefill-side store before the handoff, so later suffix prefills
        gather their prior there and never take it back across the hop.
        Returns id(job) -> its fresh store blocks (refcount 1: the index's
        reference if the page gets created, dropped in
        :meth:`_index_insert` otherwise)."""
        if not self.prefix_reuse:
            return None
        dest = np.zeros((self.max_batch, L // PAGE), np.int32)
        ctx: dict = {}
        for j, job in enumerate(jobs):
            n_ins = len(job.req.prompt_tokens) // PAGE
            store_ids = self._store_alloc_blocks(
                max(n_ins - job.cached // PAGE, 0))
            ctx[id(job)] = store_ids
            dest[j, : len(store_ids)] = store_ids
        kvc.scatter_pages(self._prefix_store_blocks, caches, dest)
        return ctx

    def _index_insert(self, jobs: list, store_ctx):
        """Store-aware radix insert: page ``i``'s payload pairs the
        prefill-store block with the decode-pool block. A created page
        keeps the store block's alloc-time reference as the index's and
        takes one decode-side reference; orphans (a page a sibling of the
        same admission already indexed, or a row skipped after an eviction
        during this admission) drop theirs."""
        if not self.prefix_reuse:
            return
        for job in jobs:
            store_ids = store_ctx.get(id(job), []) if store_ctx else []
            toks = job.req.prompt_tokens
            n_ins = len(toks) // PAGE
            cpages = job.cached // PAGE
            if n_ins == 0:
                continue
            depth = len(self.prefix_index.match(toks, n_ins, peek=True))
            if depth < cpages:
                self._store_pool.deref(store_ids)
                continue
            payloads = ([(job.p_ids[i], job.pt_row[i]) for i in range(cpages)]
                        + [(store_ids[i - cpages], job.pt_row[i])
                           for i in range(cpages, n_ins)])
            created = self.prefix_index.insert(toks, payloads, n_ins)
            created_p = set()
            for (p, d) in created:
                created_p.add(p)
                self.pool.allocator.ref([d])
            self._store_pool.deref([p for p in store_ids
                                    if p not in created_p])

    # ------------------------------------------------------------------ #
    def _move(self, payload):
        """Run the mechanism on a packed payload: (the landed tree, the
        measured wall, seconds spent growing buffers outside it)."""
        t0 = time.perf_counter()
        self._bufs.fit(payload)
        alloc_s = time.perf_counter() - t0
        if self.device.type == "cuda":
            # the payload (and the prefill behind it) is complete before
            # the window opens, as the JAX tier blocks on its tiled payload
            torch.cuda.current_stream(self.device).synchronize()
        t0 = time.perf_counter()
        landed = xfer.move(payload, self._bufs)
        wall = time.perf_counter() - t0
        return landed.unpack(), wall, alloc_s

    def _charge(self, art: PrefillArtifact, wire_now: int, wall: float,
                req_bytes: list):
        """Count one handoff and charge each riding request its share."""
        measured = self._measured()
        self.handoffs += 1
        self.handoff_wall_s += wall
        self.handoff_wire_bytes += wire_now
        share = wall / max(len(art.reqs), 1)
        tot_bytes = max(sum(req_bytes), 1)
        for req, nbytes in zip(art.reqs, req_bytes):
            rec = self._records[req.request_id]
            self.handoff_request_bytes += nbytes
            # the request's prefix-proportional share of what the hop moved
            # (block rounding and co-riders' dummy rows included): the
            # modelled hop and TCP's CPU both charge on it, so the requests'
            # stages sum to the real wire cost
            wire_share = wire_now * nbytes / tot_bytes
            # every co-admitted request waits the full hop before its first
            # token; the stage splits the measured wall or models this
            # request's share
            rec.transfer_wall_s += wall
            rec.add("transfer", share if measured
                    else self.profile.handoff_time(self.hop, wire_share))
            if self.hop is Transport.TCP:
                rec.cpu_s += wire_share * self.profile.tcp_cpu_per_byte

    def _land(self, art: PrefillArtifact, landed) -> PrefillArtifact:
        """Decode side, after the hop: pad the rows back to the admission
        width ``max_batch``, padding rows carrying the dummy slot index (the
        splice drops them). The ring dim stays at the landed prefix: the
        port's splice writes ring slots ``[0, width)`` of each slot, where
        the JAX tier regrows the prefix to max_seq first."""
        meta = landed["meta"]
        width = (0, self.max_batch - meta["lengths"].shape[0])
        return dataclasses.replace(
            art, caches=kvc.pad_cache_rows(landed["caches"], self.max_batch),
            slot_idx=F.pad(meta["slot_idx"], width,
                           value=self.max_batch).cpu().numpy(),
            lengths=F.pad(meta["lengths"], width),
            next_tokens=F.pad(meta["next_tokens"], width),
            max_new=F.pad(meta["max_new"], width))

    def _handoff(self, art: PrefillArtifact):
        """Move the artifact's valid KV prefix (paged: its suffix cache)
        and slot metadata across the hop, charge each riding request, and
        return the landed artifact with the seconds to keep out of
        'preprocess' (the hop wall and any buffer allocation)."""
        if self.paged:  # the suffix cache at its bucket width
            n = min(_next_pow2(max(art.n_rows, 1)), len(art.slot_idx))
            bucket = art.dest_blocks.shape[1] * PAGE
            payload = self._wire_payload(art, n, bucket)
        else:
            n, prefix = self._prefix_extent(art)
            payload = self._wire_payload(art, n, prefix)
        landed, wall, alloc_s = self._move(payload)
        wire_now = payload_wire_bytes(payload.tree, self.transfer_mode)
        lens = landed["meta"]["lengths"].cpu().numpy()
        if self.paged:
            self.handoff_payload_bytes += self._paged_geometry_bytes(
                n, bucket)
            # each row's UNCACHED suffix: its reused prefix rode an earlier
            # handoff, and counting it again would undo what reuse saved
            req_bytes = [_META_BYTES_PAGED + kvc.request_cache_nbytes(
                art.caches, int(lens[j]) - int(art.cached_lens[j]),
                itemsize=self._wire_isz) for j in range(len(art.reqs))]
        else:
            req_bytes = [_META_BYTES + kvc.request_cache_nbytes(
                art.caches, int(lens[j]), itemsize=self._wire_isz)
                for j in range(len(art.reqs))]
        self._charge(art, wire_now, wall, req_bytes)
        return self._land(art, landed), wall + alloc_s

    def counters(self) -> dict:
        out = super().counters()
        out.update(handoffs=self.handoffs,
                   handoff_wire_bytes=self.handoff_wire_bytes,
                   handoff_request_bytes=self.handoff_request_bytes,
                   handoff_payload_bytes=self.handoff_payload_bytes)
        return out

    def _ttft_adjust(self, rec) -> float:
        # measured: the hop wall is already inside the latency stamps. CPU:
        # swap the full, non-representative wall the request waited out of
        # the stamps and fold the modelled hop in
        if self._measured():
            return 0.0
        return rec.stage_s.get("transfer", 0.0) - rec.transfer_wall_s
