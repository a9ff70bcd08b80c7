"""Serving engine of the port: continuous batching over a ring KV slot pool.

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
* **Device-resident decode loop** -- sampling (greedy argmax, or
  temperature/top-k with a ``torch.Generator`` on the pool's device), EOS
  detection, per-slot done flags and length updates all run on the device.
  Up to ``inflight`` steps are dispatched ahead (capped adaptively at the
  live slots' outstanding token budget); each step's tokens+done are copied
  into pinned host memory without blocking, behind a CUDA event the host
  waits on only when it harvests that step.
* **Fused admission splice** -- an admission writes its prefill KV into the
  free slots of the pool and updates the per-slot state in one pass.

The KV pool is updated in place (the JAX engine donates it); the small
per-slot state tensors are replaced on every update, and each in-flight
step copies its tokens and done flags out when it is dispatched, so a
harvest never reads a later step's values.
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
from repro_torch.models import Model
from repro_torch.serving.request import Request, Response


MIN_BUCKET = 16  # smallest prefill length bucket


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class _HostCopy:
    """A step's tokens+done on their way to the host: on CUDA, a
    non-blocking copy into pinned buffers behind a recorded event; on the
    CPU, the tensors themselves."""

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
            self.tokens, self.done, self.event = tokens, done, None

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
    reads a slot past a row's length before writing it.
    """

    caches: object  # cache tree, [npad, bucket, Hkv, hd] per k/v leaf
    slot_idx: np.ndarray  # [npad] int32 host-side (max_batch => dummy row)
    lengths: torch.Tensor  # [npad] true prompt lengths
    next_tokens: torch.Tensor  # [npad] first token per row
    max_new: torch.Tensor  # [npad] per-request token budget
    reqs: list  # the real requests (row-aligned prefix)
    slots: list  # pool slot per request
    n_rows: int = 0  # occupied leading rows (== len(reqs))


class DecodePool:
    """Decode-side slot pool: slot occupancy, the ring KV pool, the
    per-slot device decode state (tokens/lengths/gen/done/maxn), the
    decode step and the in-flight window."""

    def __init__(self, model: Model, *, max_batch: int, max_seq: int,
                 eos_token: Optional[int], inflight: int,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0):
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
        self._init_state()

    def _init_state(self):
        """Build the device-side slot state: empty pool, all slots done."""
        dev, B = self.device, self.max_batch
        self.caches = self.model.init_cache(B, self.max_seq)
        self.lengths = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.tokens = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self.gen = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.maxn = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.done = torch.ones((B,), dtype=torch.bool, device=dev)
        # AND of isfinite over every logit row this pool and its engine saw
        self.logits_finite = torch.ones((), dtype=torch.bool, device=dev)
        self.rng = torch.Generator(device=dev).manual_seed(2 * self.sample_seed)

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
        step the JAX engine's."""
        active = ~self.done
        logits, _, lengths2 = self.model.decode_step(
            params, self.caches, self.tokens, self.lengths)
        self.note_logits(logits)
        next_tok = self.sample(logits, self.rng)
        next_tok = torch.where(active, next_tok, self.tokens[:, 0])
        self.gen = self.gen + active.to(torch.int32)
        self.done = (self.done | (self.gen >= self.maxn)
                     | (active & (next_tok == self.eos)))
        self.lengths = torch.where(active, lengths2, self.lengths)
        self.tokens = next_tok[:, None]

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
        rows, plus every per-slot state update. Only the ``n_rows`` real
        rows are indexed (dummy rows are dropped here, on the host)."""
        n = art.n_rows
        if n == 0:
            return
        idx = torch.as_tensor(art.slot_idx[:n].astype(np.int64),
                              device=self.device)
        for gname, group in self.caches.items():
            for i, block in enumerate(group):
                for lname, pool_leaves in block.items():
                    new = art.caches[gname][i][lname]
                    for key, pool in pool_leaves.items():
                        src = new[key][:n]
                        pool[idx, : src.shape[1]] = src.to(pool.dtype)
        col = torch.zeros_like(idx)
        self.lengths = self.lengths.index_put((idx,), art.lengths[:n])
        self.tokens = self.tokens.index_put((idx, col), art.next_tokens[:n])
        self.gen = self.gen.index_put((idx,), torch.ones_like(art.lengths[:n]))
        # the prefill token may already exhaust the budget (max_new=1):
        # such slots start done so decode never advances them
        self.done = self.done.index_put((idx,), art.max_new[:n] <= 1)
        self.maxn = self.maxn.index_put((idx,), art.max_new[:n])

    def fill_one(self, params, limit: int) -> bool:
        """Dispatch one decode step if the in-flight window has room
        (``limit`` caps it below ``inflight``)."""
        if len(self.window) >= min(self.inflight, limit):
            return False
        self._step(params)
        self.window.append(_InFlight(tuple(self.slots),
                                     _HostCopy(self.tokens, self.done)))
        return True

    def pop_oldest(self) -> Optional[_InFlight]:
        return self.window.popleft() if self.window else None


class ServingEngine:
    """Continuous-batching serving engine over a slot-based ring KV pool.

    :meth:`submit` queues a request, :meth:`step` runs one iteration (admit
    -> dispatch -> harvest) and returns finished
    :class:`~repro_torch.serving.request.Response` objects, and
    :meth:`run_until_drained` loops :meth:`step` until queue, slots and
    in-flight window are empty. Per-request stage accounting accumulates in
    ``self.store``.

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
        device="cuda",
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
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.transport = transport
        self.eos = eos_token
        self.inflight = max(1, inflight)
        self.prefill_tokens_total = 0
        self.prefill_tokens_uncached = 0
        # padded token-rows dispatched to prefill (npad * bucket per call):
        # a FLOPs proxy that must equal the JAX engine's on the same load
        self.prefill_padded_tokens = 0
        self.prefill_calls = 0
        self.store = ProfileStore()
        self.queue: deque[Request] = deque()
        self.pool = DecodePool(
            model, max_batch=max_batch, max_seq=max_seq, eos_token=eos_token,
            inflight=self.inflight, temperature=temperature, top_k=top_k,
            sample_seed=sample_seed,
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

    # ------------------------------------------------------------------ #
    def counters(self) -> dict:
        """The engine's counters as one plain dict."""
        return {
            "prefill_tokens_total": self.prefill_tokens_total,
            "prefill_tokens_uncached": self.prefill_tokens_uncached,
            "prefill_padded_tokens": self.prefill_padded_tokens,
            "prefill_calls": self.prefill_calls,
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
        if the prompt exceeds ``max_seq``.
        """
        req.t_arrival = time.perf_counter()
        if len(req.prompt_tokens) > self.max_seq:
            raise ValueError(
                f"prompt length {len(req.prompt_tokens)} exceeds max_seq "
                f"{self.max_seq}"
            )
        if req.features is not None:
            raise NotImplementedError(
                "feature payloads take the exact-shape prefill path, which "
                "comes with a later slice of the port")
        rec = RequestRecord(
            request_id=req.request_id, client_id=req.client_id,
            priority=req.priority, t_issue=req.t_arrival,
            bytes_in=req.payload_bytes, bytes_out=4 * req.max_new_tokens,
        )
        rec.add("request", PAPER_A2.wire_time(self.transport, rec.bytes_in))
        if self.transport.uses_copy_engine:
            rec.add("copy_in", PAPER_A2.copy_time(rec.bytes_in))
        self._records[req.request_id] = rec
        self.queue.append(req)

    def _bucket(self, s: int) -> int:
        return min(max(_next_pow2(s), MIN_BUCKET), self.max_seq)

    # ------------------------------------------------------------------ #
    # Admission
    # ------------------------------------------------------------------ #
    def _admit(self):
        free = self.pool.free_slots()
        if not self.queue or not free:
            return
        order = sorted(
            range(len(self.queue)),
            key=lambda i: (-self.queue[i].priority, i),
        )[: len(free)]
        picked = [self.queue[i] for i in order]
        for i in sorted(order, reverse=True):
            del self.queue[i]
        free_it = iter(free)
        buckets: dict[int, list[Request]] = {}
        for req in picked:
            buckets.setdefault(self._bucket(len(req.prompt_tokens)), []).append(req)
        for L, reqs in buckets.items():
            self._prefill_bucket(L, reqs, [next(free_it) for _ in reqs])

    def _prefill_bucket(self, L: int, reqs: list, slots: list):
        """One padded prefill + fused splice for every request in a bucket,
        the batch dim padded to the fixed admission width ``max_batch``."""
        n = len(reqs)
        npad = self.max_batch
        toks = np.zeros((npad, L), np.int32)
        lens = np.zeros((npad,), np.int32)
        maxn = np.zeros((npad,), np.int32)
        slot_idx = np.full((npad,), self.max_batch, np.int32)  # dummy rows
        for j, (req, slot) in enumerate(zip(reqs, slots)):
            s = len(req.prompt_tokens)
            toks[j, :s] = req.prompt_tokens
            lens[j] = s
            maxn[j] = req.max_new_tokens
            slot_idx[j] = slot
        self.prefill_tokens_total += int(lens[:n].sum())
        self.prefill_tokens_uncached += int(lens[:n].sum())
        self.prefill_padded_tokens += npad * L
        self.prefill_calls += 1
        t0 = time.perf_counter()
        dev = self.device
        logits, cache1, lens_d = self.model.prefill_bucketed(
            self.params, torch.from_numpy(toks).to(dev),
            torch.from_numpy(lens).to(dev),
        )
        self.pool.note_logits(logits)
        next_toks = self.pool.sample(logits, self.prefill_rng)
        art = PrefillArtifact(cache1, slot_idx, lens_d, next_toks,
                              torch.from_numpy(maxn).to(dev), reqs,
                              list(slots), n_rows=n)
        self.pool.splice(art)
        # deliberate fence: 'preprocess' must include prefill completion
        toks_host = art.next_tokens.cpu().numpy()
        now = time.perf_counter()
        dt = max(now - t0, 0.0)
        for j, (req, slot) in enumerate(zip(reqs, slots)):
            rec = self._records[req.request_id]
            # pre-admission wait: submit -> this admission picking it
            rec.add("queue", max(t0 - rec.t_issue, 0.0))
            rec.add("preprocess", dt / n)  # prefill = serving "preprocessing"
            req.generated.append(int(toks_host[j]))
            req.t_first_token = now
            self._place(req, slot)
        self._t_mark = now  # prefill time is "preprocess", not "inference"

    def _place(self, req: Request, slot: int):
        """Occupy ``slot``, or finish the request right away when the
        prefill token already met its budget (max_new_tokens <= 1)."""
        if req.max_new_tokens <= 1:
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
        if done and self._finished_ids:
            # ids matter only while an in-flight snapshot references them
            live_ids = {
                r.request_id for ent in self.pool.window
                for r in ent.slots if r is not None
            }
            self._finished_ids &= live_ids
        return done

    def _finish(self, req: Request, rec: RequestRecord) -> Response:
        rsp_wire = PAPER_A2.wire_time(self.transport, rec.bytes_out)
        rec.add("response", rsp_wire)
        egress = rsp_wire
        if self.transport.uses_copy_engine:
            copy_out = PAPER_A2.copy_time(rec.bytes_out)
            rec.add("copy_out", copy_out)
            egress += copy_out
        # modelled ingress (charged at submit) and egress both reach the
        # latency stamps, so total_s >= sum(stage_s) holds end to end
        ingress = (rec.stage_s.get("request", 0.0)
                   + rec.stage_s.get("copy_in", 0.0))
        rec.t_done = time.perf_counter() + ingress + egress
        req.t_done = rec.t_done
        self.store.add(rec)
        return Response(
            request_id=req.request_id,
            tokens=list(req.generated),
            ttft_s=req.t_first_token - req.t_arrival + ingress,
            total_s=rec.t_done - rec.t_issue,
            stage_s=dict(rec.stage_s),
        )

    # ------------------------------------------------------------------ #
    def step(self) -> list[Response]:
        """One continuous-batching iteration: admit, top up the in-flight
        window, harvest the OLDEST dispatched step."""
        self._admit()
        self._dispatch()
        done = self._harvest()
        if self._prefill_finished:  # budget met by the prefill token itself
            done = self._prefill_finished + done
            self._prefill_finished = []
        return done

    @property
    def idle(self) -> bool:
        """No queued requests, no occupied slots, no in-flight steps."""
        return not self.queue and self.pool.all_free and not self.pool.window

    def run_until_drained(self, max_steps: int = 10_000) -> list[Response]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if self.idle:
                break
        return out
