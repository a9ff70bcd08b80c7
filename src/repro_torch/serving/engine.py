"""Serving engine of the port: continuous batching over a ring KV slot pool
or a paged KV block pool with radix prefix reuse.

The PyTorch twin of the JAX package's ``serving/engine.py`` fused engine on
its bucketed fast path: the paper's pipeline (request -> [copy] ->
preprocess/prefill -> decode -> response) with real compute on the card and
the transport and copy-engine stages modelled by the calibrated
TransportProfile, composed into one per-request record (paper Table I).

* **Bucketed prefill** -- prompts are right-padded to power-of-two length
  buckets; queued admissions sharing a bucket run as ONE prefill call at the
  fixed admission width ``max_batch`` (dummy rows carry slot index
  ``max_batch`` and are dropped on the host before the splice: a CUDA
  scatter would fault on an out-of-bounds index where JAX's drops it).
* **Exact-shape prefill** -- a stack with SSM layers cannot be right-padded
  (pad tokens would flow into its conv window and recurrent state), so, as
  in the JAX engine, each admitted request of such a stack is prefilled on
  its own at its true length. The architecture picks the path.
* **Device-resident decode loop** -- sampling (greedy argmax, or
  temperature/top-k with a ``torch.Generator`` on the pool's device), EOS
  detection, per-slot done flags and length updates all run on the device.
  Up to ``inflight`` steps are dispatched ahead (capped adaptively at the
  live slots' outstanding token budget); each step's tokens+done are copied
  into pinned host memory without blocking, behind a CUDA event the host
  waits on only when it harvests that step.
* **Fused admission splice** -- an admission writes its prefill KV into the
  free slots of the pool and updates the per-slot state in one pass.
* **Paged KV pool** (``paged=True``) -- the ring pool becomes a block pool
  of ``PAGE``-token blocks with per-slot page tables (host-built, pushed to
  the device before a dispatch) and refcounts. With ``prefix_reuse`` a radix
  index maps page-aligned prompt prefixes to the blocks that hold their KV:
  an admission reuses the longest indexed prefix, prefills only its suffix
  (each layer gathers its prior right before its flash launch), and decode
  writes and reads the pool through the page table with the paged kernel --
  nothing is gathered on the decode path.
* **Token-packed prefill** (``packed=True``) -- an admission's prompts
  are written back to back into ONE ``[1, T]`` row (T the next power of two
  of their true tokens) with per-token segment ids, so prefill pays for the
  tokens it has, not ``max_batch`` rows of the bucket. Flash masks by
  segment and skips the key tiles before a q-tile's segments; the packed
  cache unpacks per segment into the same artifact a bucketed admission
  gives. Off (silently) on stacks with SSM layers; turns prefix reuse off.
* **Chunked prefill** (``prefill_chunk=C``) -- a prompt longer than C
  admits as a sequence of C-token suffix prefills against a fixed-width
  dense prior (the remainder chunk first), one chunk per engine iteration
  after the decode dispatch, so a long admission never stalls live decodes
  for its whole prefill. Ring pool only.
* **The decode step as one CUDA graph** -- the counterpart of the JAX
  engine's jitted step: on CUDA each pool (ring, paged or SSM) runs its
  first decode dispatch eagerly, then captures the step (model step,
  sampling, stop flags, length update) into one ``torch.cuda.CUDAGraph``
  that every later dispatch replays. ``warmup=True`` (:meth:`ServingEngine.
  warm`) runs every serving shape once and captures the graph at
  construction. A capture or replay that fails raises; nothing falls back
  to the eager step. On the CPU the step runs eagerly.
* **Legacy loop** (``legacy=True``) -- the seed's synchronous loop, the
  A/B baseline: exact-length prefill per request, a blocking host argmax
  every token, one step in flight.

Every device state tensor of the pool -- the KV pool (the JAX engine
donates it), the page table and the small per-slot state -- is allocated
once and updated in place from then on, since a captured graph reads and
writes fixed addresses. Each in-flight step copies its tokens and done
flags out when it is dispatched, so a harvest never reads a later step's
values.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.profiler import ProfileStore, RequestRecord
from repro_torch.core.transport import PAPER_A2, Transport
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.models import kvcache as kvc
from repro_torch.serving.prefix import RadixPrefixIndex
from repro_torch.serving.request import Request, Response


MIN_BUCKET = 16  # smallest prefill length bucket
PAGE = 16  # tokens per KV block of the paged pool (a divisor of MIN_BUCKET)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class _HostCopy:
    """A step's tokens+done on their way to the host: on CUDA, a
    non-blocking copy into pinned buffers of its own behind a recorded
    event; on the CPU, copies taken now (the pool updates its state in
    place, so the next step would overwrite the tensors themselves)."""

    def __init__(self, tokens, done):
        if tokens.device.type == "cuda":
            self.tokens = torch.empty(tokens.shape, dtype=tokens.dtype,
                                      pin_memory=True)
            self.done = torch.empty(done.shape, dtype=done.dtype,
                                    pin_memory=True)
            self.tokens.copy_(tokens, non_blocking=True)
            self.done.copy_(done, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.tokens, self.done = tokens.clone(), done.clone()
            self.event = None

    def wait(self):
        """Block until the copy landed; returns (tokens, done) as numpy."""
        if self.event is not None:
            self.event.synchronize()
        return self.tokens.numpy(), self.done.numpy()


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unharvested decode step."""

    slots: tuple  # Request-or-None per slot, snapshotted at dispatch
    host: _HostCopy  # the step's own tokens+done, copied at dispatch


@dataclasses.dataclass
class PrefillArtifact:
    """Everything a prefill stage delivers to the decode slot pool.

    Row j of every per-row array belongs to ``reqs[j]`` for j < ``n_rows``;
    rows past it are admission padding (slot index == max_batch) and never
    reach the pool. ``caches`` holds the prefill KV at bucket width: the
    splice writes ring slots ``[0, bucket)`` of each slot, and decode never
    reads a slot past a row's length before writing it. An SSM layer's conv
    window and state have no such mask, so the splice overwrites the slot's
    whole rows of them.
    """

    caches: object  # cache tree, [npad, bucket, Hkv, hd] per k/v leaf
    slot_idx: np.ndarray  # [npad] int32 host-side (max_batch => dummy row)
    lengths: torch.Tensor  # [npad] true cache lengths (prompt tokens)
    next_tokens: torch.Tensor  # [npad] first token per row
    max_new: torch.Tensor  # [npad] per-request token budget
    reqs: list  # the real requests (row-aligned prefix)
    slots: list  # pool slot per request
    n_rows: int = 0  # occupied leading rows (== len(reqs))
    # max true cache length among the occupied rows: a disaggregated
    # handoff moves only this valid prefix of the k/v leaves
    prefix_len: int = 0
    # paged: ``caches`` holds the SUFFIX cache at bucket width, scattered
    # page-wise into the blocks named here (0 => dropped); a reused prefix
    # already lives in shared blocks and never rides the artifact
    dest_blocks: Optional[np.ndarray] = None  # [npad, bucket / PAGE] int32
    cached_lens: Optional[np.ndarray] = None  # [npad] int32 reused prefix


@dataclasses.dataclass
class _ChunkJob:
    """One in-progress chunked admission: its reserved slot, its
    fixed-width prior cache tree and the prompt tokens prefilled so far."""

    req: Request
    slot: int
    prior: object  # [1, max_seq, Hkv, hd] cache tree, written in place
    done: int = 0  # prompt tokens already prefilled and spliced


@dataclasses.dataclass
class _PagedJob:
    """Per-request admission bookkeeping for a paged prefill group."""

    req: Request
    slot: int
    cached: int  # reused prefix tokens (page-aligned)
    p_ids: list  # prior blocks gathered by the suffix prefill (pinned)
    pt_row: list  # shared prefix blocks + own blocks = the row's page table


class DecodePool:
    """Decode-side slot pool: slot occupancy, the ring KV pool (or, paged,
    the block pool, its allocator and the per-slot page tables), the
    per-slot device decode state (tokens/lengths/gen/done/maxn), the
    decode step and the in-flight window.

    Every state tensor is allocated once and only ever updated in place,
    so the decode step can be one captured CUDA graph: with ``graph`` (the
    default) a pool on CUDA runs its first dispatch eagerly, captures the
    step right after, and replays the capture at every later dispatch.
    :meth:`reset_state` re-zeros the state after a warm-up, in place, so
    the capture stays valid."""

    def __init__(self, model: Model, *, max_batch: int, max_seq: int,
                 eos_token: Optional[int], inflight: int,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0, paged: bool = False,
                 graph: bool = True):
        self.paged = bool(paged)
        if self.paged:
            if max_seq % PAGE:
                raise ValueError(f"max_seq {max_seq} must be a multiple of "
                                 f"the page size {PAGE}")
            # sentinel + every slot's worst case + as much again for the
            # prefix index to keep warm (the JAX engine's default)
            self.pages_per_seq = max_seq // PAGE
            self.allocator = kvc.PagedKVPool(
                1 + 2 * max_batch * self.pages_per_seq, PAGE)
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0: {temperature}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0: {top_k}")
        self.model = model
        self.device = model.device
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.inflight = inflight
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.eos = eos_token if eos_token is not None else -1
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.sample_seed = int(sample_seed)
        self.window: deque[_InFlight] = deque()
        # the captured step: the graph, the params it was captured with,
        # and the kernel launches one replay makes (ops.LAUNCHES counts
        # them at each replay)
        self.use_graph = bool(graph) and self.device.type == "cuda"
        self._graph = None
        self._graph_params = None
        self._graph_launches: dict = {}
        self.graph_replays = 0  # decode dispatches that replayed the graph
        self._init_state()

    def _init_state(self):
        """Build the device-side slot state once: empty pool, all slots
        done."""
        dev, B = self.device, self.max_batch
        if self.paged:
            self.caches = None
            self.blocks = kvc.init_paged(
                self.model.cache_specs(B, self.max_seq),
                self.allocator.num_blocks, PAGE, dtype=self.model.dtype,
                device=dev)
            self.pt_host = np.zeros((B, self.pages_per_seq), np.int32)
            self.page_table = torch.zeros((B, self.pages_per_seq),
                                          dtype=torch.int32, device=dev)
            self._pt_dirty = False
            self._slot_blocks: list[list] = [[] for _ in range(B)]
        else:
            self.caches = self.model.init_cache(B, self.max_seq)
        self.lengths = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.tokens = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self.gen = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.maxn = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.done = torch.ones((B,), dtype=torch.bool, device=dev)
        # AND of isfinite over every logit row this pool and its engine saw
        self.logits_finite = torch.ones((), dtype=torch.bool, device=dev)
        self.rng = torch.Generator(device=dev).manual_seed(2 * self.sample_seed)

    def reset_state(self):
        """Re-zero the slot state after a warm-up (the JAX engine's
        ``reset_state``): a pristine pool, every tensor zeroed in place --
        never reallocated, since a captured step reads and writes these
        addresses -- the allocator reset and the sampling stream re-seeded.
        Refuses an occupied pool."""
        if not self.all_free:
            raise RuntimeError("reset_state on an occupied pool")
        self.window.clear()
        kv = self.blocks if self.paged else self.caches
        kvc.tree_map(lambda leaf: leaf.zero_(), kv)
        for t in (self.lengths, self.tokens, self.gen, self.maxn):
            t.zero_()
        self.done.fill_(True)
        self.logits_finite.fill_(True)
        if self.paged:
            self.pt_host[:] = 0
            self.page_table.zero_()
            self._pt_dirty = False
            self._slot_blocks = [[] for _ in range(self.max_batch)]
            self.allocator.reset()
        self.rng.manual_seed(2 * self.sample_seed)

    # ------------------------------------------------------------------ #
    def note_logits(self, logits):
        """Fold a batch of logits into the device-side finiteness flag
        (no host sync)."""
        self.logits_finite &= torch.isfinite(logits).all()

    def sample(self, logits, rng: torch.Generator):
        """Next-token choice on device: argmax at temperature 0 (first
        maximum, like ``jnp.argmax``), else a Gumbel-max draw from the
        temperature-scaled, top_k-filtered logits (``top_k == 1`` is argmax
        exactly)."""
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        lg = logits.float() / self.temperature
        if self.top_k > 0:
            kth = torch.topk(lg, self.top_k, dim=-1).values[:, -1:]
            lg = lg.masked_fill(lg < kth, float("-inf"))
        u = torch.rand(lg.shape, generator=rng, device=lg.device)
        return torch.argmax(lg - torch.log(-torch.log(u)), dim=-1).to(torch.int32)

    def _step(self, params):
        """One whole-batch decode step, sampling and stop logic on device.

        Frozen (done/empty) slots keep their token and length, so their
        ring slot stays put; their lane still flows through the batched
        compute (its output discarded), which keeps token streams step for
        step the JAX engine's. Every state update is in place: this body
        is what the pool's CUDA graph captures."""
        active = ~self.done
        if self.paged:
            logits, lengths2 = self.model.decode_step_paged(
                params, self.blocks, self.page_table, self.tokens,
                self.lengths)
        else:
            logits, _, lengths2 = self.model.decode_step(
                params, self.caches, self.tokens, self.lengths)
        self.note_logits(logits)
        next_tok = self.sample(logits, self.rng)
        next_tok = torch.where(active, next_tok, self.tokens[:, 0])
        self.gen.add_(active.to(torch.int32))
        self.done |= (self.gen >= self.maxn) | (active & (next_tok == self.eos))
        self.lengths.copy_(torch.where(active, lengths2, self.lengths))
        self.tokens.copy_(next_tok[:, None])

    def _capture(self, params):
        """The pool's first decode dispatch on CUDA: one real eager step,
        then the capture of the same step into a CUDA graph.

        The eager step runs every one-time host call before the capture
        (kernel builds, ``cudaFuncSetAttribute``, cached SM counts and
        split plans, cuBLAS's workspace for the capture stream, the
        caching allocator's first blocks); the capture launches nothing
        and changes no state, so it is taken back out of ``ops.LAUNCHES``.
        The sampling generator is registered with the graph, so each replay
        advances its Philox offset as an eager call would. The capture
        keeps the caching allocator's blocks (``torch.cuda.graph`` would
        empty the cache first, and every later prefill would allocate its
        blocks with ``cudaMalloc`` anew). Failure raises: there is no eager
        fallback."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        if self.temperature > 0.0:
            graph.register_generator_state(self.rng)
        with torch.cuda.stream(side):
            self._step(params)
            side.synchronize()
            before = dict(ops.LAUNCHES)
            graph.capture_begin()
            try:
                self._step(params)
            finally:
                graph.capture_end()
        cur.wait_stream(side)
        launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
        ops.add_launches(launches, -1)
        self._graph, self._graph_params = graph, params
        self._graph_launches = launches

    def _decode(self, params):
        """One decode dispatch: a replay of the captured step (captured at
        the first dispatch), or the eager step on the CPU and with
        ``graph=False``."""
        if self.paged:
            self._sync_pt()
        if not self.use_graph:
            self._step(params)
        elif self._graph is None:
            self._capture(params)
        else:
            if params is not self._graph_params:
                raise ValueError("the decode graph was captured with other "
                                 "params")
            self._graph.replay()
            ops.add_launches(self._graph_launches)
            self.graph_replays += 1

    # ------------------------------------------------------------------ #
    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def all_free(self) -> bool:
        return all(s is None for s in self.slots)

    @property
    def done_mask(self) -> np.ndarray:
        """Host copy of the device-side per-slot done flags."""
        return self.done.cpu().numpy()

    def splice(self, art: PrefillArtifact):
        """Admit a prefill artifact into the pool: KV into the slots' ring
        rows (paged: page-wise into ``art.dest_blocks``), plus every
        per-slot state update. Only the ``n_rows`` real rows are indexed
        (dummy rows are dropped here, on the host)."""
        n = art.n_rows
        if n == 0:
            return
        idx = torch.as_tensor(art.slot_idx[:n].astype(np.int64),
                              device=self.device)
        if self.paged:
            kvc.scatter_pages(self.blocks, art.caches, art.dest_blocks)
        else:
            for gname, group in self.caches.items():
                for i, block in enumerate(group):
                    for lname, pool_leaves in block.items():
                        new = art.caches[gname][i][lname]
                        for key, pool in pool_leaves.items():
                            src = new[key][:n].to(pool.dtype)
                            if key in kvc.SEQ_KEYS:
                                pool[idx, : src.shape[1]] = src
                            else:
                                # a freed or frozen lane kept changing its
                                # conv/state in every decode step since
                                pool[idx] = src
        col = torch.zeros_like(idx)
        self.lengths.index_put_((idx,), art.lengths[:n])
        self.tokens.index_put_((idx, col), art.next_tokens[:n])
        self.gen.index_put_((idx,), torch.ones_like(art.lengths[:n]))
        # the prefill token may already exhaust the budget (max_new=1):
        # such slots start done so decode never advances them
        self.done.index_put_((idx,), art.max_new[:n] <= 1)
        self.maxn.index_put_((idx,), art.max_new[:n])

    # ------------------------------------------------------------------ #
    # paged page-table plumbing (host-authored, device-consumed)
    # ------------------------------------------------------------------ #
    def set_row(self, slot: int, blocks_list: list):
        """Install a slot's page-table row (admission). The device copy is
        pushed before the next dispatch; steps already in flight read the
        old table, whose row for this slot is zero -- their writes land in
        the sink block, so a stale window is harmless."""
        self.pt_host[slot, :] = 0
        self.pt_host[slot, : len(blocks_list)] = blocks_list
        self._pt_dirty = True
        self._slot_blocks[slot] = list(blocks_list)

    def release_slot(self, slot: int):
        """Drop a finished row's block references and zero its page-table
        row (paged; a no-op on the ring pool). Shared prefix blocks live
        as long as the prefix index or another row holds them."""
        if not self.paged:
            return
        self.allocator.deref(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self.pt_host[slot, :] = 0
        self._pt_dirty = True

    def _sync_pt(self):
        """Push the host page table into the one device ``page_table`` when
        it changed: a copy on the stream from a pinned host copy of
        ``pt_host`` taken now, so a later host edit never races the
        asynchronous transfer; steps already in flight keep the table
        they were dispatched with (the copy is stream-ordered after
        them)."""
        if self._pt_dirty:
            staged = torch.from_numpy(self.pt_host.copy())
            if self.page_table.is_cuda:
                staged = staged.pin_memory()
            self.page_table.copy_(staged, non_blocking=True)
            self._pt_dirty = False

    def fill_one(self, params, limit: int) -> bool:
        """Dispatch one decode step if the in-flight window has room
        (``limit`` caps it below ``inflight``)."""
        if len(self.window) >= min(self.inflight, limit):
            return False
        self._decode(params)
        self.window.append(_InFlight(tuple(self.slots),
                                     _HostCopy(self.tokens, self.done)))
        return True

    def pop_oldest(self) -> Optional[_InFlight]:
        return self.window.popleft() if self.window else None


class ServingEngine:
    """Continuous-batching serving engine over a slot-based KV pool: the
    ring pool, or with ``paged=True`` the paged block pool, with radix
    prefix reuse unless ``prefix_reuse=False`` (or ``packed``).
    ``packed=True`` prefills each admission as one token-packed row;
    ``prefill_chunk=C`` (ring pool only) prefills prompts longer than C
    in C-token chunks between decode steps. A stack with SSM layers
    prefills each request at its exact length, cannot be paged, and runs
    neither packed nor chunked.

    :meth:`submit` queues a request, :meth:`step` runs one iteration (admit
    -> dispatch -> harvest) and returns finished
    :class:`~repro_torch.serving.request.Response` objects, and
    :meth:`run_until_drained` loops :meth:`step` until queue, slots and
    in-flight window are empty. Per-request stage accounting accumulates in
    ``self.store``.

    ``warmup=True`` runs :meth:`warm` at construction, so no timed stage
    pays a one-time cost (its wall is ``warm_s``). ``legacy=True`` serves
    through the seed's synchronous loop instead (exact-length prefill per
    request, a blocking host argmax every token, one step in flight; no
    bucketing, packing, chunking, paging or sampling), the baseline of the
    fast path's A/B. ``_graph=False`` keeps the fast path's decode step
    eager on CUDA: for comparisons only, like the decode launchers'
    ``_splits``.

    ``device`` defaults to CUDA and must be the model's device; with no
    CUDA device the constructor raises unless ``device="cpu"`` is given.
    """

    def __init__(
        self,
        model: Model,
        params,
        *,
        max_batch: int = 8,
        max_seq: int = 256,
        transport: Transport = Transport.GDR,
        eos_token: Optional[int] = None,
        inflight: int = 4,
        temperature: float = 0.0,
        top_k: int = 0,
        sample_seed: int = 0,
        paged: bool = False,
        prefix_reuse: bool = True,
        packed: bool = False,
        prefill_chunk: int = 0,
        legacy: bool = False,
        warmup: bool = False,
        device="cuda",
        _graph: bool = True,
    ):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        if model.cfg.sliding_window and model.cfg.sliding_window < max_seq:
            # the slot pool rings at W = window: right-pad past the window
            # would clobber live slots. Serve with max_seq <= window.
            raise ValueError(
                f"slot-pool engine requires max_seq <= sliding_window "
                f"({max_seq} > {model.cfg.sliding_window})"
            )
        # bucketed (right-padded) prefill is sound only for attention-only
        # stacks; the others take the exact-shape path, one request per call
        self.exact_prefill = not model.attention_only
        self.legacy = bool(legacy)
        if self.legacy and temperature > 0.0:
            raise ValueError("device-side sampling requires the fast path "
                             "(the legacy loop argmaxes on the host)")
        if paged and (self.exact_prefill or self.legacy):
            raise ValueError(
                "paged KV pool requires the bucketed fast path (an "
                f"attention-only stack, legacy=False): {model.cfg.name}")
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.transport = transport
        self.profile = PAPER_A2
        self.eos = eos_token
        self.inflight = 1 if self.legacy else max(1, inflight)
        self.prefill_tokens_total = 0
        self.prefill_tokens_uncached = 0
        # padded token-rows dispatched to prefill (npad * bucket per call):
        # a FLOPs proxy that must equal the JAX engine's on the same load
        self.prefill_padded_tokens = 0
        self.prefill_calls = 0
        # paged pool + shared-prefix reuse (the ring pool is the A/B
        # baseline): reused prompt tokens are counted apart from the rest
        self.paged = bool(paged)
        # token-packed prefill: the bucketing gate (attention-only), and
        # off silently otherwise, so callers may set it on any stack
        self.packed = bool(packed) and not (self.exact_prefill or self.legacy)
        # chunked prefill: long prompts prefill C tokens an iteration
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0: {prefill_chunk}")
        if self.prefill_chunk:
            if self.paged:
                raise ValueError(
                    "chunked prefill rides the ring pool (its fixed-width "
                    "prior splices densely); use paged=False with "
                    "prefill_chunk")
            if self.prefill_chunk > max_seq:
                raise ValueError(f"prefill_chunk {prefill_chunk} exceeds "
                                 f"max_seq {max_seq}")
        self._chunk_enabled = self.prefill_chunk > 0 and not (
            self.exact_prefill or self.legacy)
        self._chunk_jobs: deque[_ChunkJob] = deque()
        self._chunk_slots: set[int] = set()  # slots reserved by chunk jobs
        # a packed admission's pages interleave its segments and never
        # align with the prefix index: reuse is off under packing
        self.prefix_reuse = self.paged and bool(prefix_reuse) and not self.packed
        self.prefix_index = (RadixPrefixIndex(PAGE) if self.prefix_reuse
                             else None)
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.store = ProfileStore()
        self.queue: deque[Request] = deque()
        self.pool = DecodePool(
            model, max_batch=max_batch, max_seq=max_seq, eos_token=eos_token,
            inflight=self.inflight, temperature=temperature, top_k=top_k,
            sample_seed=sample_seed, paged=self.paged, graph=_graph,
        )
        # the prefill's first-token draws: a stream of their own
        self.prefill_rng = torch.Generator(device=self.device).manual_seed(
            2 * int(sample_seed) + 1)
        self._records: dict[int, RequestRecord] = {}
        self._finished_ids: set[int] = set()
        self._prefill_finished: list[Response] = []
        self._t_mark = time.perf_counter()
        self.decode_steps = 0  # whole-batch decode dispatches
        self.useful_steps = 0  # harvested steps that advanced a live request
        self.warm_s = 0.0  # construction-time warm wall, outside all stages
        if warmup:
            self.warm_s = self.warm()

    # ------------------------------------------------------------------ #
    def counters(self) -> dict:
        """The engine's counters as one plain dict."""
        return {
            "prefill_tokens_total": self.prefill_tokens_total,
            "prefill_tokens_uncached": self.prefill_tokens_uncached,
            "prefill_padded_tokens": self.prefill_padded_tokens,
            "prefill_calls": self.prefill_calls,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "decode_steps": self.decode_steps,
            "useful_steps": self.useful_steps,
            "requests_finished": len(self.store.records),
        }

    def logits_all_finite(self) -> bool:
        """Whether every logit row computed so far was finite (syncs)."""
        return bool(self.pool.logits_finite.item())

    @property
    def done_mask(self) -> np.ndarray:
        return self.pool.done_mask

    # ------------------------------------------------------------------ #
    def submit(self, req: Request, now: Optional[float] = None):
        """Queue a request for admission at the next step boundary.

        Stamps the arrival clock (``now`` is accepted for API compatibility
        and not used) and charges the modelled INGRESS stages (request wire
        + copy engine, per the transport) to the request's record. Raises
        if the prompt exceeds ``max_seq`` or, paged, if prompt + max_new
        does.
        """
        req.t_arrival = time.perf_counter()
        if len(req.prompt_tokens) > self.max_seq:
            raise ValueError(
                f"prompt length {len(req.prompt_tokens)} exceeds max_seq "
                f"{self.max_seq}"
            )
        if req.features is not None:
            raise NotImplementedError(
                "feature payloads come with the VLM/audio front-end slice "
                "of the port")
        if self.paged and len(req.prompt_tokens) + req.max_new_tokens > self.max_seq:
            # the ring pool wraps a long generation over its own oldest
            # positions; a paged row may SHARE its prefix blocks, so
            # wrapping would corrupt other readers -- reject instead
            raise ValueError(
                f"prompt + max_new ({len(req.prompt_tokens)} + "
                f"{req.max_new_tokens}) exceeds max_seq {self.max_seq}: "
                "the paged pool never ring-wraps")
        rec = RequestRecord(
            request_id=req.request_id, client_id=req.client_id,
            priority=req.priority, t_issue=req.t_arrival,
            bytes_in=req.payload_bytes, bytes_out=4 * req.max_new_tokens,
        )
        rec.add("request", self.profile.wire_time(self.transport, rec.bytes_in))
        if self.transport.uses_copy_engine:
            rec.add("copy_in", self.profile.copy_time(rec.bytes_in))
        self._records[req.request_id] = rec
        self.queue.append(req)

    def _bucket(self, s: int) -> int:
        return min(max(_next_pow2(s), MIN_BUCKET), self.max_seq)

    def _free_slots(self) -> list[int]:
        """Admittable slots: the pool's free ones less those a chunked
        admission has reserved (its request lands in the pool's slots only
        at its final chunk)."""
        free = self.pool.free_slots()
        if self._chunk_slots:
            free = [s for s in free if s not in self._chunk_slots]
        return free

    def packed_cap(self) -> int:
        """Widest packed row this engine can dispatch: every slot admitted
        at once at a full max_seq prompt, rounded to a power of two."""
        return _next_pow2(self.max_batch * self.max_seq)

    # ------------------------------------------------------------------ #
    # Construction-time warm-up
    # ------------------------------------------------------------------ #
    def bucket_grid(self) -> list:
        """Every pow2 prefill bucket this engine can admit into:
        ``MIN_BUCKET, 2 * MIN_BUCKET, ..., max_seq`` (clamped)."""
        return self._pow2_grid(self.max_seq)

    def packed_grid(self) -> list:
        """Every pow2 packed width a packed admission can dispatch:
        ``MIN_BUCKET .. packed_cap()``."""
        return self._pow2_grid(self.packed_cap())

    @staticmethod
    def _pow2_grid(cap: int) -> list:
        out, n = [], min(MIN_BUCKET, cap)
        while True:
            out.append(n)
            if n >= cap:
                return out
            n = min(2 * n, cap)

    def warm(self) -> float:
        """Run every shape the serving path can hit once for real, so no
        timed stage pays a one-time cost: kernel builds, cuBLAS's
        heuristics, the caching allocator's first blocks, the decode
        step's capture. Returns the wall seconds, charged to no request.

        It runs one prefill per pow2 bucket (per packed width when
        ``packed``), the suffix prefill per bucket when prefix reuse is on,
        the chunk shape when chunking, and the first decode dispatch (on
        CUDA: one eager step and the graph capture), then re-zeros the pool
        with :meth:`DecodePool.reset_state`. Nothing here is counted, and
        the prefill's sampling stream is not drawn from. The JAX engine
        also compiles its splice on an all-dummy artifact; the port's
        splice drops dummy rows on the host, so such a splice launches
        nothing and there is nothing of it to warm. The exact-shape path
        (SSM stacks) prefills per ragged prompt length and is warmed no
        further than its decode step; under ``legacy=True`` this is a
        no-op that returns 0.0, as in the JAX engine."""
        if self.legacy:
            return 0.0
        t0 = time.perf_counter()
        npad, dev = self.max_batch, self.device

        def zeros(*shape, fill=0):
            return torch.full(shape, fill, dtype=torch.int32, device=dev)

        if not self.exact_prefill:
            if self.packed:
                for T in self.packed_grid():
                    _, packed = self.model.prefill_packed(
                        self.params, zeros(1, T), zeros(1, T),
                        zeros(1, T, fill=-1), zeros(npad))
                    kvc.unpack_segments(packed, zeros(npad),
                                        self._bucket(T))
            else:
                for L in self.bucket_grid():
                    self.model.prefill_bucketed(self.params, zeros(npad, L),
                                                zeros(npad, fill=1))
                    if self.prefix_reuse:
                        self.model.prefill_suffix(
                            self.params, zeros(npad, L), zeros(npad, fill=1),
                            zeros(npad), zeros(npad, self.pool.pages_per_seq),
                            self._prior_blocks())
        if self._chunk_enabled:
            C = self.prefill_chunk
            prior = self.model.init_cache(1, self.max_seq)
            _, suffix, _ = self.model.prefill_suffix_dense(
                self.params, zeros(1, C), zeros(1, fill=1), zeros(1), prior)
            kvc.splice_suffix(prior, suffix, zeros(1))
        self.pool.fill_one(self.params, limit=1)  # on CUDA: the capture
        self.pool.reset_state()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    # ------------------------------------------------------------------ #
    # Admission
    # ------------------------------------------------------------------ #
    def _admit(self):
        free = self._free_slots()
        if not self.queue or not free:
            return
        order = sorted(
            range(len(self.queue)),
            key=lambda i: (-self.queue[i].priority, i),
        )[: len(free)]
        picked = [self.queue[i] for i in order]
        for i in sorted(order, reverse=True):
            del self.queue[i]
        if self.paged:
            self._admit_paged(picked, free)
            return
        free_it = iter(free)
        if self.exact_prefill:
            for req in picked:
                self._prefill_exact(req, next(free_it))
            return
        packables: list[Request] = []
        buckets: dict[int, list[Request]] = {}
        for req in picked:
            if (self._chunk_enabled
                    and len(req.prompt_tokens) > self.prefill_chunk):
                # long prompts admit chunk by chunk, one chunk an engine
                # iteration, between decode dispatches
                self._chunk_admit(req, next(free_it))
            elif self.packed:
                packables.append(req)
            else:
                buckets.setdefault(self._bucket(len(req.prompt_tokens)),
                                   []).append(req)
        if packables:
            self._prefill_packed(packables, [next(free_it) for _ in packables])
        for L, reqs in buckets.items():
            self._prefill_bucket(L, reqs, [next(free_it) for _ in reqs])

    def _host_batch(self, L: int, reqs: list, slots: list, cached=None):
        """Host arrays of one prefill group at the fixed admission width
        ``max_batch``: tokens (each prompt's uncached suffix, right-padded
        to ``L``), suffix lengths, budgets and slot indices (``max_batch``
        marks a dummy row). Charges the group to the prefill counters."""
        npad = self.max_batch
        cached = cached or [0] * len(reqs)
        toks = np.zeros((npad, L), np.int32)
        lens = np.zeros((npad,), np.int32)
        maxn = np.zeros((npad,), np.int32)
        slot_idx = np.full((npad,), self.max_batch, np.int32)  # dummy rows
        for j, (req, slot, c) in enumerate(zip(reqs, slots, cached)):
            s = len(req.prompt_tokens) - c
            toks[j, :s] = req.prompt_tokens[c:]
            lens[j] = s
            maxn[j] = req.max_new_tokens
            slot_idx[j] = slot
        self.prefill_padded_tokens += npad * L
        self.prefill_calls += 1
        return toks, lens, maxn, slot_idx

    def _prefill_bucket(self, L: int, reqs: list, slots: list):
        """One padded prefill + fused splice for every request in a bucket,
        the batch dim padded to the fixed admission width ``max_batch``."""
        toks, lens, maxn, slot_idx = self._host_batch(L, reqs, slots)
        self.prefill_tokens_total += int(lens.sum())
        self.prefill_tokens_uncached += int(lens.sum())
        t0 = time.perf_counter()
        dev = self.device
        logits, cache1, lens_d = self.model.prefill_bucketed(
            self.params, torch.from_numpy(toks).to(dev),
            torch.from_numpy(lens).to(dev),
        )
        self._splice_and_place(logits, cache1, lens_d, slot_idx, maxn, reqs,
                               slots, t0, prefix_len=int(lens.max()))

    def _prefill_packed(self, reqs: list, slots: list, jobs: list = None):
        """One token-packed prefill for every admitted prompt.

        The prompts go back to back into one ``[1, T]`` row, T the next
        power of two of their true tokens (at least ``MIN_BUCKET``, at most
        :meth:`packed_cap`), with segment ids (-1 on the pad tail) and
        positions that restart in each segment. The host builds the arrays
        with numpy and copies each to the device once. The packed cache
        unpacks per segment into ``[max_batch, bucket]`` rows, the bucket
        of the longest prompt: the artifact a bucketed admission of the
        same rows gives (the JAX engine unpacks to max_seq, or on the paged
        path to min(T, max_seq); the port's splice and handoff take the
        bucket width, and nothing past a row's length is read before
        decode writes it). ``jobs`` are the paged admission's planned rows,
        whose prompt counters :meth:`_admit_paged` has charged."""
        npad = self.max_batch
        total = sum(len(r.prompt_tokens) for r in reqs)
        T = min(max(_next_pow2(total), MIN_BUCKET), self.packed_cap())
        toks = np.zeros((1, T), np.int32)
        pos = np.zeros((1, T), np.int32)
        seg = np.full((1, T), -1, np.int32)  # -1 = pad: matches no segment
        seg_starts = np.zeros((npad,), np.int32)
        last_idx = np.zeros((npad,), np.int32)
        lens = np.zeros((npad,), np.int32)
        maxn = np.zeros((npad,), np.int32)
        slot_idx = np.full((npad,), npad, np.int32)  # dummy rows
        off = 0
        for j, (req, slot) in enumerate(zip(reqs, slots)):
            n = len(req.prompt_tokens)
            toks[0, off:off + n] = req.prompt_tokens
            pos[0, off:off + n] = np.arange(n)
            seg[0, off:off + n] = j
            seg_starts[j] = off
            last_idx[j] = off + n - 1
            lens[j] = n
            maxn[j] = req.max_new_tokens
            slot_idx[j] = slot
            off += n
        # dummy rows keep seg_starts/last_idx 0: their unpacked rows and
        # logits are garbage that the splice drops with their slot index
        if jobs is None:
            self.prefill_tokens_total += total
            self.prefill_tokens_uncached += total
        self.prefill_padded_tokens += T
        self.prefill_calls += 1
        out_w = self._bucket(int(lens.max()))
        t0 = time.perf_counter()
        dev = self.device
        logits, packed = self.model.prefill_packed(
            self.params, torch.from_numpy(toks).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(seg).to(dev),
            torch.from_numpy(last_idx).to(dev))
        caches = kvc.unpack_segments(
            packed, torch.from_numpy(seg_starts).to(dev), out_w)
        paged = {}
        if self.paged:
            dest = np.zeros((npad, out_w // PAGE), np.int32)  # 0 => drop
            for j, job in enumerate(jobs):
                row = job.pt_row[: out_w // PAGE]
                dest[j, : len(row)] = row
            paged = dict(dest_blocks=dest,
                         cached_lens=np.zeros((npad,), np.int32))
        self._splice_and_place(
            logits, caches, torch.from_numpy(lens).to(dev), slot_idx, maxn,
            reqs, slots, t0, prefix_len=int(lens.max()), **paged)

    # ------------------------------------------------------------------ #
    # Chunked prefill: fixed-width chunks interleaved with decode steps
    # ------------------------------------------------------------------ #
    def _chunk_admit(self, req: Request, slot: int):
        """Reserve ``slot`` and queue the request as a chunk job with a
        fresh fixed-width dense prior; its prompt prefills
        ``prefill_chunk`` tokens an engine iteration in :meth:`_chunk_step`
        until the final chunk splices it in. The prior lives on the
        prefill stage's device (one card holds both stages of the
        disaggregated tier too, so only the final artifact hops)."""
        self._chunk_slots.add(slot)
        self._chunk_jobs.append(
            _ChunkJob(req, slot, self.model.init_cache(1, self.max_seq)))
        P = len(req.prompt_tokens)
        self.prefill_tokens_total += P
        self.prefill_tokens_uncached += P

    def _chunk_step(self):
        """Run ONE chunk of the oldest chunk job (once an engine iteration,
        after the decode dispatch, so live slots' steps are queued on the
        stream ahead of it).

        The REMAINDER chunk runs first (sizes r, C, ..., C with r = ((P -
        1) % C) + 1): every later chunk is exactly C wide, so the final
        chunk's logits are at a fixed index and no splice overruns the
        prior (done + C <= P <= max_seq). The first chunk's pad rows write
        KV past r that the next chunk's splice overwrites; ``prior_valid``
        masks it meanwhile. Each chunk is one prefill call of C token-rows.
        """
        if not self._chunk_jobs:
            return
        job = self._chunk_jobs[0]
        C = self.prefill_chunk
        P = len(job.req.prompt_tokens)
        t0 = time.perf_counter()
        rec = self._records[job.req.request_id]
        if job.done == 0:  # the pre-admission wait ends at the first chunk
            rec.add("queue", max(t0 - rec.t_issue, 0.0))
        n = ((P - 1) % C) + 1 if job.done == 0 else C
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = job.req.prompt_tokens[job.done:job.done + n]
        dev = self.device
        cached = torch.tensor([job.done], dtype=torch.int32, device=dev)
        logits, suffix, _ = self.model.prefill_suffix_dense(
            self.params, torch.from_numpy(toks).to(dev),
            torch.tensor([n], dtype=torch.int32, device=dev), cached,
            job.prior)
        kvc.splice_suffix(job.prior, suffix, cached)
        job.done += n
        self.prefill_padded_tokens += C
        self.prefill_calls += 1
        if job.done < P:
            # deliberate fence: the chunk's 'preprocess' includes its
            # device completion and the host runs at most a chunk ahead
            self.pool.sample(logits, self.prefill_rng).cpu()
            rec.add("preprocess", max(time.perf_counter() - t0, 0.0))
            return
        # the final chunk: its prior, cut to the prompt's bucket, is the
        # artifact's one row (the splice and the handoff read rows up to
        # n_rows, so the JAX engine's pad of the cache rows to max_batch
        # is not needed), spliced as any admission is
        self._chunk_jobs.popleft()
        self._chunk_slots.discard(job.slot)
        caches = kvc.slice_cache(job.prior, 1, self._bucket(P))
        self._splice_and_place(
            logits, caches, torch.tensor([P], dtype=torch.int32, device=dev),
            np.asarray([job.slot], np.int32),
            np.asarray([job.req.max_new_tokens], np.int32), [job.req],
            [job.slot], t0, prefix_len=P, queued=False)

    def _prefill_exact(self, req: Request, slot: int):
        """Exact-shape prefill of one request at its true length S, then its
        sample, splice and record (the JAX engine's ``_prefill_exact``)."""
        S = len(req.prompt_tokens)
        self.prefill_calls += 1
        self.prefill_tokens_total += S
        self.prefill_tokens_uncached += S
        self.prefill_padded_tokens += S
        t0 = time.perf_counter()
        toks = torch.tensor(np.asarray(req.prompt_tokens, np.int32))[None]
        logits, caches, lengths = self.model.prefill(self.params,
                                                     toks.to(self.device))
        self._splice_and_place(
            logits, caches, lengths, np.asarray([slot], np.int32),
            np.asarray([req.max_new_tokens], np.int32), [req], [slot], t0,
            prefix_len=S)

    def _splice_and_place(self, logits, caches, lengths, slot_idx, maxn,
                          reqs: list, slots: list, t0: float, *,
                          prefix_len: int, before_place=None, queued=True,
                          **paged):
        """Sample each row's first token, hand the artifact across
        :meth:`_handoff`, splice it into the pool, and hand its requests
        their first token and slot. ``paged`` carries the paged
        artifact's ``dest_blocks`` and ``cached_lens``; ``queued=False``
        leaves 'queue' alone (a chunked admission charged it at its first
        chunk).
        ``before_place`` runs after the splice and before any request is
        placed (the paged path indexes its prompts there: a request its
        prefill token already finishes releases its slot in
        :meth:`_place`)."""
        self.pool.note_logits(logits)
        next_toks = self.pool.sample(logits, self.prefill_rng)
        art = PrefillArtifact(caches, slot_idx, lengths, next_toks,
                              torch.from_numpy(maxn).to(self.device), reqs,
                              list(slots), n_rows=len(reqs),
                              prefix_len=prefix_len, **paged)
        art, t_xfer = self._handoff(art)  # disagg: the prefill->decode hop
        self.pool.splice(art)
        # deliberate fence: 'preprocess' must include prefill completion
        toks_host = art.next_tokens.cpu().numpy()
        now = time.perf_counter()
        dt = max(now - t0 - t_xfer, 0.0)
        if before_place is not None:
            before_place()
        for j, (req, slot) in enumerate(zip(reqs, slots)):
            rec = self._records[req.request_id]
            if queued:  # pre-admission wait: submit -> this admission
                rec.add("queue", max(t0 - rec.t_issue, 0.0))
            rec.add("preprocess", dt / len(reqs))  # prefill = "preprocessing"
            req.generated.append(int(toks_host[j]))
            req.t_first_token = now
            self._place(req, slot)
        self._t_mark = now  # prefill time is "preprocess", not "inference"

    # ------------------------------------------------------------------ #
    # Paged admission: prefix match -> block plan -> grouped prefill
    # ------------------------------------------------------------------ #
    def _admit_paged(self, picked: list, free: list):
        """Plan every picked request's page table, then prefill in groups.

        All prefix MATCHES happen before any INSERT, so two requests
        sharing a prefix admitted in the same batch can't false-match
        pages whose KV this very admission is still computing: the second
        request recomputes the shared prefix once, and reuse starts at the
        next admission. Matched blocks are refcount-pinned here (once for
        the row's page table, for its lifetime; once more until its suffix
        prefill has gathered the prior), so index eviction under pool
        pressure can never free KV a picked request is about to read.
        """
        jobs: list[_PagedJob] = []
        alloc = self.pool.allocator
        for req, slot in zip(picked, free):
            P = len(req.prompt_tokens)
            shared: list = []
            p_ids: list = []
            if self.prefix_reuse:
                # cap the match below the full prompt: at least one suffix
                # token must remain to produce the first-token logits
                payloads = self.prefix_index.match(req.prompt_tokens,
                                                   (P - 1) // PAGE)
                if payloads:
                    p_ids = [p for (p, _) in payloads]
                    shared = [d for (_, d) in payloads]
                    self._store_alloc().ref(p_ids)
                    alloc.ref(shared)
                    self.prefix_hits += 1
                    self.prefix_hit_tokens += len(shared) * PAGE
            cached = len(shared) * PAGE
            n_pages = -(-(P + req.max_new_tokens) // PAGE)
            pt_row = shared + self._alloc_blocks(n_pages - len(shared))
            self.pool.set_row(slot, pt_row)
            self.prefill_tokens_total += P
            self.prefill_tokens_uncached += P - cached
            jobs.append(_PagedJob(req, slot, cached, p_ids, pt_row))
        if self.packed:
            # reuse is off under packing (cached == 0 for every job): one
            # packed call replaces the bucket groups
            self._prefill_packed([job.req for job in jobs],
                                 [job.slot for job in jobs], jobs=jobs)
            return
        groups: dict[tuple, list[_PagedJob]] = {}
        for job in jobs:
            L = self._bucket(len(job.req.prompt_tokens) - job.cached)
            groups.setdefault((L, job.cached > 0), []).append(job)
        for (L, has_prior), gjobs in sorted(groups.items()):
            self._prefill_paged_group(L, has_prior, gjobs)

    def _alloc_blocks(self, n: int) -> list:
        """Allocate ``n`` fresh blocks, LRU-evicting cold prefix-index
        pages under pool pressure. Eviction only drops the INDEX's
        references: a block a live row still reads is refcount-protected
        and stays until its last reader releases it."""
        while True:
            got = self.pool.allocator.alloc(n)
            if got is not None:
                return got
            payload = (self.prefix_index.evict_lru()
                       if self.prefix_reuse else None)
            if payload is None:
                raise RuntimeError(
                    "paged KV pool exhausted with no evictable prefix "
                    "pages; lower max_batch")
            self._evict_index_page(payload)

    def _evict_index_page(self, payload):
        """Drop the index's references on one evicted page (one per
        payload side; in the fused engine both name the same block)."""
        p, d = payload
        self._store_alloc().deref([p])
        self.pool.allocator.deref([d])

    # seams the disaggregated tier overrides: the prior side of a reused
    # prefix lives wherever prefill runs (fused: the decode pool itself;
    # disaggregated: a prefill-side block store, so a suffix prefill never
    # takes prefix KV back across the hop)
    def _store_alloc(self):
        return self.pool.allocator

    def _prior_blocks(self):
        return self.pool.blocks

    def _store_prepare(self, jobs: list, caches, L: int):
        """Seam before the handoff (the disaggregated tier stashes the
        suffix cache into its prefill-side store here). Fused: nothing."""
        return None

    def _index_insert(self, jobs: list, store_ctx):
        """Index each admitted prompt's fully-in-prompt pages.

        Existing pages keep their first writer's blocks (matches ref THOSE
        at admission); only newly created nodes take references, one per
        payload side, so the index keeps a released slot's prefix KV alive
        for future hits. A row whose matched interior was LRU-evicted
        during this very admission's allocations is skipped: its chain
        would root orphaned payloads the index can no longer reach.
        """
        if not self.prefix_reuse:
            return
        for job in jobs:
            toks = job.req.prompt_tokens
            n_ins = len(toks) // PAGE
            if n_ins == 0:
                continue
            depth = len(self.prefix_index.match(toks, n_ins, peek=True))
            if depth < job.cached // PAGE:
                continue
            payloads = [(job.pt_row[i], job.pt_row[i]) for i in range(n_ins)]
            for (p, d) in self.prefix_index.insert(toks, payloads, n_ins):
                self._store_alloc().ref([p])
                self.pool.allocator.ref([d])

    def prefix_lookup_tokens(self, tokens) -> int:
        """Matched prefix length in tokens, LRU- and counter-neutral (a
        peek, not a hit); 0 when reuse is off."""
        if not self.prefix_reuse:
            return 0
        return self.prefix_index.lookup_tokens(tokens)

    def _prefill_paged_group(self, L: int, has_prior: bool, jobs: list):
        """One padded (suffix-)prefill + paged splice for a group of
        admissions sharing a suffix bucket.

        A group with no reused prefix runs the plain bucketed prefill, the
        ring path's math. A group with one runs the suffix prefill: its
        prior is ``max(cached)`` tokens wide (rows with less pad with the
        zero sentinel), and each layer gathers it right before its flash
        launch. Either way the artifact carries the bucket-width SUFFIX
        cache only: reused prefix KV never moves again.
        """
        reqs = [job.req for job in jobs]
        slots = [job.slot for job in jobs]
        cached = [job.cached for job in jobs]
        toks, lens, maxn, slot_idx = self._host_batch(L, reqs, slots, cached)
        cached_np = np.zeros((self.max_batch,), np.int32)
        cached_np[: len(jobs)] = cached
        dest = np.zeros((self.max_batch, L // PAGE), np.int32)  # 0 => drop
        for j, job in enumerate(jobs):
            tail = job.pt_row[job.cached // PAGE:][: L // PAGE]
            dest[j, : len(tail)] = tail
        t0 = time.perf_counter()
        dev = self.device
        toks_d = torch.from_numpy(toks).to(dev)
        lens_d = torch.from_numpy(lens).to(dev)
        if has_prior:
            prior_pt = np.zeros((self.max_batch, max(cached) // PAGE),
                                np.int32)
            for j, job in enumerate(jobs):
                prior_pt[j, : len(job.p_ids)] = job.p_ids
            logits, caches, total = self.model.prefill_suffix(
                self.params, toks_d, lens_d,
                torch.from_numpy(cached_np).to(dev),
                torch.from_numpy(prior_pt).to(dev), self._prior_blocks())
            # every layer's gather is enqueued: the prior pins can go (the
            # page-table rows keep each row's own hold from here)
            for job in jobs:
                self._store_alloc().deref(job.p_ids)
        else:
            logits, caches, total = self.model.prefill_bucketed(
                self.params, toks_d, lens_d)
        store_ctx = self._store_prepare(jobs, caches, L)
        self._splice_and_place(
            logits, caches, total, slot_idx, maxn, reqs, slots, t0,
            prefix_len=int((cached_np + lens).max()), dest_blocks=dest,
            cached_lens=cached_np,
            before_place=lambda: self._index_insert(jobs, store_ctx))

    def _place(self, req: Request, slot: int):
        """Occupy ``slot``, or finish the request right away when the
        prefill token already met its budget (max_new_tokens <= 1)."""
        if req.max_new_tokens <= 1:
            # never occupies the slot; a paged row still drops its
            # page-table hold (the prefix index took its own first)
            self.pool.release_slot(slot)
            self._prefill_finished.append(
                self._finish(req, self._records[req.request_id]))
            return
        self.pool.slots[slot] = req

    # ------------------------------------------------------------------ #
    # Decode: async dispatch window + single-transfer harvest
    # ------------------------------------------------------------------ #
    def _window_limit(self) -> int:
        """Adaptive dispatch depth: the max outstanding token budget among
        live slots; steps beyond it cannot advance any request."""
        out = [
            req.max_new_tokens - len(req.generated)
            for req in self.pool.slots if req is not None
        ]
        return max(out, default=0)

    def _dispatch(self):
        """Top up the in-flight window."""
        if self.pool.all_free:
            return
        if not self.pool.window:
            # pipeline (re)start: don't charge idle time to "inference"
            self._t_mark = time.perf_counter()
        limit = self._window_limit()
        while self.pool.fill_one(self.params, limit=limit):
            self.decode_steps += 1

    def _harvest(self) -> list[Response]:
        e = self.pool.pop_oldest()
        if e is None:
            return []
        toks, _done = e.host.wait()  # the step's one host transfer
        now = time.perf_counter()
        dt = max(now - self._t_mark, 0.0)
        self._t_mark = now
        return self._finalize_harvest(e, toks, dt)

    def _finalize_harvest(self, e: _InFlight, toks, dt: float) -> list[Response]:
        """Host bookkeeping over one harvested step: per-request records,
        EOS/budget checks, slot release."""
        live = [
            (i, r) for i, r in enumerate(e.slots)
            if r is not None and r.request_id not in self._finished_ids
        ]
        if live:
            self.useful_steps += 1
        done: list[Response] = []
        for i, req in live:
            rec = self._records[req.request_id]
            rec.add("inference", dt / len(live))
            tok = int(toks[i, 0])
            req.generated.append(tok)
            finished = len(req.generated) >= req.max_new_tokens or (
                self.eos is not None and tok == self.eos
            )
            if finished:
                done.append(self._finish(req, rec))
                self._finished_ids.add(req.request_id)
                if self.pool.slots[i] is req:
                    self.pool.slots[i] = None
                    # paged: drop the row's block references. Safe with
                    # stale steps still in flight: their frozen-lane reads
                    # and writes are dispatched before any splice that
                    # could reuse a freed block, and the stream runs work
                    # in dispatch order
                    self.pool.release_slot(i)
        if done and self._finished_ids:
            # ids matter only while an in-flight snapshot references them
            live_ids = {
                r.request_id for ent in self.pool.window
                for r in ent.slots if r is not None
            }
            self._finished_ids &= live_ids
        return done

    # ------------------------------------------------------------------ #
    # Stage seams (overridden by the disaggregated tier)
    # ------------------------------------------------------------------ #
    def _handoff(self, art: PrefillArtifact):
        """Hook between prefill and the decode-pool splice. The fused
        engine hands the artifact on as it is; the disaggregated tier moves
        it across the prefill->decode hop here and returns the seconds to
        keep out of 'preprocess' alongside."""
        return art, 0.0

    def _ttft_adjust(self, rec: RequestRecord) -> float:
        """Modelled latency folded into ttft/total beyond the measured
        stamps (the disaggregated tier swaps the measured handoff wall for
        the profile-modelled hop on CPU runs)."""
        return 0.0

    def _finish(self, req: Request, rec: RequestRecord) -> Response:
        rsp_wire = self.profile.wire_time(self.transport, rec.bytes_out)
        rec.add("response", rsp_wire)
        egress = rsp_wire
        if self.transport.uses_copy_engine:
            copy_out = self.profile.copy_time(rec.bytes_out)
            rec.add("copy_out", copy_out)
            egress += copy_out
        # modelled ingress (charged at submit) and egress both reach the
        # latency stamps, so total_s >= sum(stage_s) holds end to end
        ingress = (rec.stage_s.get("request", 0.0)
                   + rec.stage_s.get("copy_in", 0.0))
        adj = self._ttft_adjust(rec)
        rec.t_done = time.perf_counter() + ingress + egress + adj
        req.t_done = rec.t_done
        self.store.add(rec)
        return Response(
            request_id=req.request_id,
            tokens=list(req.generated),
            ttft_s=req.t_first_token - req.t_arrival + ingress + adj,
            total_s=rec.t_done - rec.t_issue,
            stage_s=dict(rec.stage_s),
        )

    # ------------------------------------------------------------------ #
    def step(self) -> list[Response]:
        """One continuous-batching iteration: admit, top up the in-flight
        window, run one chunk of a chunked admission, harvest the OLDEST
        dispatched step (under ``legacy=True``, the seed's synchronous
        iteration instead)."""
        if self.legacy:
            return self._step_legacy()
        self._admit()
        self._dispatch()
        # one chunk AFTER the decode top-up: live slots' steps are already
        # on the stream, so the chunk interleaves instead of blocking them
        self._chunk_step()
        done = self._harvest()
        if self._prefill_finished:  # budget met by the prefill token itself
            done = self._prefill_finished + done
            self._prefill_finished = []
        return done

    @property
    def idle(self) -> bool:
        """No queued requests, no occupied slots, no in-flight steps, no
        chunked admission under way."""
        return (not self.queue and self.pool.all_free and not self.pool.window
                and not self._chunk_jobs)

    def run_until_drained(self, max_steps: int = 10_000) -> list[Response]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if self.idle:
                break
        return out

    # ------------------------------------------------------------------ #
    # Legacy synchronous loop (the seed's): the fast path's A/B baseline
    # ------------------------------------------------------------------ #
    def _prefill_one(self, slot: int, req: Request):
        """Exact-length prefill of one request, a blocking host argmax of
        its first token, and its splice into ``slot``. The prefill wall is
        charged to 'preprocess', the wait before it to 'queue'. Like the
        JAX loop it counts no prefill call and leaves the budget check to
        the decode step."""
        t0 = time.perf_counter()
        toks = torch.tensor(np.asarray(req.prompt_tokens, np.int32))[None]
        logits, caches, lengths = self.model.prefill(self.params,
                                                     toks.to(self.device))
        next_tok = int(torch.argmax(logits[0]))  # blocks on the prefill
        dt = time.perf_counter() - t0
        rec = self._records[req.request_id]
        rec.add("queue", max(t0 - rec.t_issue, 0.0))  # submit -> admission
        rec.add("preprocess", dt)
        one = torch.tensor([next_tok], dtype=torch.int32, device=self.device)
        maxn = torch.tensor([req.max_new_tokens], dtype=torch.int32,
                            device=self.device)
        self.pool.splice(PrefillArtifact(
            caches, np.asarray([slot], np.int32), lengths, one, maxn, [req],
            [slot], n_rows=1, prefix_len=len(req.prompt_tokens)))
        req.generated.append(next_tok)
        self.pool.slots[slot] = req
        req.t_first_token = time.perf_counter()

    def _admit_legacy(self):
        """Admit the highest-priority queued request (the first of equals)
        into the first free slot, one at a time."""
        while self.queue and self._free_slots():
            best = max(range(len(self.queue)),
                       key=lambda i: self.queue[i].priority)
            req = self.queue[best]
            del self.queue[best]
            self._prefill_one(self._free_slots()[0], req)

    def _step_legacy(self) -> list[Response]:
        """The seed loop: admit, one eager whole-batch decode step (never
        the graph), a blocking host argmax, per-slot bookkeeping. Every
        lane advances, live or not, as in the seed. Its ``max_new_tokens
        =1`` quirk is kept: such a request still takes one decode step and
        returns 2 tokens, where the fast path finishes it at prefill."""
        self._admit_legacy()
        active = [i for i, s in enumerate(self.pool.slots) if s is not None]
        if not active:
            return []
        pool = self.pool
        t0 = time.perf_counter()
        logits, _, lengths = self.model.decode_step(
            self.params, pool.caches, pool.tokens, pool.lengths)
        self.decode_steps += 1
        self.useful_steps += 1  # the sync loop only steps live slots
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32).cpu()
        dt = time.perf_counter() - t0
        pool.note_logits(logits)
        pool.lengths.copy_(lengths)
        pool.tokens.copy_(next_tokens[:, None])
        done: list[Response] = []
        for i in active:
            req = pool.slots[i]
            rec = self._records[req.request_id]
            rec.add("inference", dt / len(active))
            tok = int(next_tokens[i])
            req.generated.append(tok)
            finished = len(req.generated) >= req.max_new_tokens or (
                self.eos is not None and tok == self.eos)
            if finished:
                done.append(self._finish(req, rec))
                pool.slots[i] = None
        return done
