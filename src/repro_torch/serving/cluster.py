"""Multi-replica serving cluster: a load-balancing router over engine
replicas (the JAX package's ``serving/cluster.py``).

The paper frames model serving as a multi-stage pipeline "across multiple
compute nodes and proxies" with dynamic load-balancing requirements; its
latency breakdowns are about where time goes once a request enters that
fabric. This module is the layer that makes those quantities measurable on
the serving path: N independent :class:`~repro_torch.serving.engine.
ServingEngine` / :class:`~repro_torch.serving.disagg.DisaggregatedEngine`
replicas behind a :class:`Router`, with per-request 'queue' accounting and
warmup-aware TTFT/TPOT/E2E percentile telemetry
(``core.metrics.slo_summary``). Composing ``Gateway(TCP) -> ServingCluster
-> GDR replicas`` is the paper's proxied deployment shape end to end: a
TCP first hop, router admission, a hardware-accelerated last hop inside
each replica.

**Replicas on a mesh.** As the JAX package does, :meth:`ServingCluster.
build` carves the ``('pod',)`` axis of a cluster mesh
(:func:`~repro_torch.launch.mesh.make_cluster_mesh` by default, or the
``mesh`` given) into per-replica slices (:func:`replica_pod_slices`): a
fused replica's engine runs on its slice's device, a disaggregated
replica places its two stages within its slice (``PodPlacement``). With
fewer devices than slices, the slices overlap: on one card every replica
lives on that card, and replicas on one device share one copy of the
params (a copy is made once a distinct device); each replica has its own
``DecodePool`` and so its own decode graph.

**Router policies** (:class:`Router`):

  round_robin  : static rotation -- the baseline every queueing result is
                 held against.
  jsq          : join-shortest-queue -- fewest requests in system (queued
                 + occupying a decode slot), ties broken by outstanding
                 work then index.
  least_loaded : fewest outstanding TOKENS (queued budgets + live slots'
                 remaining budgets + free-slot headroom): work first where
                 jsq is count first.
  affinity     : pow2-bucket stickiness -- same-prefill-bucket admissions
                 co-locate on one replica, so same-bucket bursts batch into
                 one padded prefill.
  prefix_cache : for paged engines with prefix reuse: each replica is
                 scored by its own radix index's longest cached-prefix
                 match against the prompt (``engine.prefix_lookup_tokens``,
                 an LRU-neutral peek) and the request goes where the most
                 prompt tokens are resident (ties by outstanding tokens). A
                 prompt no replica has seen falls back to sticky
                 first-page placement, so the next request sharing its
                 system prompt scores a hit on the replica that indexed it.

Routing happens at submit: the request joins the chosen replica's
admission queue at once, so the engine-level 'queue' stage (submit ->
admission pick) measures exactly the backlog the policy created.

**Backends.** ``backend="inprocess"`` keeps every replica an object in
this interpreter, stepped one after another by :meth:`ServingCluster.step`;
``backend="process"`` runs each replica in its own OS process (its own
CUDA context and weights, rebuilt from ``param_seed``) behind the socket
RPC control plane of ``serving/ipc.py`` and ``serving/worker.py``. Two
worker processes on one card time-slice it: the paper's "GPU scheduling"
factor.

**Telemetry.** :meth:`ServingCluster.telemetry` merges every replica's
records and reports SLO percentiles (TTFT/TPOT/E2E/queue p50/p95/p99),
per-replica routed counts and mean occupancy, Jain balance indices over
busy-slot time and routed counts, each replica's metrics registry, the
sampler's histograms and the trace buffer's health. ``warmup=k`` drops
the first k completions from the percentiles.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from repro_torch.core import trace
from repro_torch.core.metrics import (
    jain_index,
    merge_record_streams,
    slo_summary,
)
from repro_torch.core.obs import Registry, Sampler
from repro_torch.core.profiler import ProfileStore, RequestRecord
from repro_torch.launch.mesh import available_devices, make_cluster_mesh
from repro_torch.serving.engine import (
    MIN_BUCKET,
    PAGE,
    ServingEngine,
    _next_pow2,
)
from repro_torch.sharding.partition import place_on_slice, pod_slice_mesh


def replica_pod_slices(n_pods: int, n_replicas: int,
                       pods_per_replica: int) -> list:
    """Pod-index tuple for each replica: replica i owns pods
    [i*ppr, (i+1)*ppr), wrapped modulo the pod axis (and deduped) when the
    backend has fewer devices than the cluster asked for. On one card
    (``n_pods == 1``) every replica gets ``(0,)``."""
    out = []
    for i in range(n_replicas):
        pods = {
            (i * pods_per_replica + j) % n_pods
            for j in range(pods_per_replica)
        }
        out.append(tuple(sorted(pods)))
    return out


@dataclasses.dataclass
class Replica:
    """One serving engine with its pod slice (on one card, ``(0,)``), plus
    the router-visible load counters the admission policies read."""

    index: int
    engine: object
    pods: tuple = ()
    routed: int = 0  # requests the router sent here
    steps: int = 0  # cluster steps taken (occupancy sample count)
    busy_slot_steps: int = 0  # sum over steps of occupied slots

    @property
    def queue_depth(self) -> int:
        """Requests waiting for admission (not yet in a decode slot)."""
        return len(self.engine.queue)

    @property
    def occupancy(self) -> int:
        """Decode slots currently occupied."""
        return self.engine.max_batch - len(self.engine.pool.free_slots())

    @property
    def free_slots(self) -> int:
        return len(self.engine.pool.free_slots())

    @property
    def jobs(self) -> int:
        """Requests in system: queued + in a decode slot (the jsq metric)."""
        return self.queue_depth + self.occupancy

    @property
    def outstanding_tokens(self) -> int:
        """Token-budget view of load: queued requests' full budgets plus
        live slots' remaining budgets (the least_loaded metric — a
        48-token request weighs 24x a 2-token one where ``jobs`` counts
        them the same)."""
        queued = sum(r.max_new_tokens for r in self.engine.queue)
        live = sum(
            r.max_new_tokens - len(r.generated)
            for r in self.engine.pool.slots if r is not None
        )
        return queued + live

    @property
    def occupancy_mean(self) -> float:
        """Mean occupied-slot fraction over the cluster steps so far."""
        denom = self.steps * self.engine.max_batch
        return self.busy_slot_steps / denom if denom else 0.0

    # ------------------------------------------------------------------ #
    # backend seam: ServingCluster drives replicas only through these, so
    # in-process and process-backed replicas are interchangeable
    # ------------------------------------------------------------------ #
    @property
    def idle(self) -> bool:
        return self.engine.idle

    @property
    def queued_requests(self) -> list:
        return list(self.engine.queue)

    @property
    def records(self):
        """request_id -> RequestRecord (what Gateway mutates in place)."""
        return self.engine._records

    @property
    def clock_offset(self) -> float:
        """Per-process perf_counter skew vs the router's clock (0 for an
        in-process replica: same interpreter, same clock)."""
        return 0.0

    def submit(self, req, now: Optional[float] = None) -> None:
        self.engine.submit(req, now)

    def step(self) -> list:
        return self.engine.step()

    def sample_occupancy(self) -> None:
        """One occupancy sample per cluster step (the balance metric)."""
        self.steps += 1
        self.busy_slot_steps += self.occupancy

    def store_records(self) -> list:
        return list(self.engine.store.records)

    def metrics_snapshot(self) -> dict:
        return self.engine.metrics_snapshot()

    def trace_flush(self) -> None:
        """Close the engine's open decode window (drain-end hook)."""
        tf = getattr(self.engine, "trace_flush", None)
        if callable(tf):
            tf()

    def drain(self, deadline_s: float = 120.0) -> list:
        """Step to idle (bounded); returns the finished responses."""
        out = []
        t_end = time.perf_counter() + deadline_s
        while not self.idle:
            out.extend(self.step())
            self.sample_occupancy()
            if time.perf_counter() > t_end:
                raise RuntimeError(
                    f"replica {self.index} drain exceeded {deadline_s}s"
                )
        out.extend(self.step())
        self.trace_flush()
        return out

    def close(self) -> None:
        eng_close = getattr(self.engine, "close", None)
        if callable(eng_close):
            eng_close()


class _RemoteEngineFacade:
    """The slice of the single-engine surface the :class:`Router`'s
    policies touch, backed by a :class:`ProcessReplica`'s cached load
    snapshot instead of a live engine. Deliberately does NOT expose
    ``prefix_lookup_tokens``: a remote radix index can't be peeked without
    an RPC per replica per request, so the ``prefix_cache`` policy's
    scores degrade to its sticky first-page fallback (the contract of
    engines without prefix reuse). ``exact_prefill`` comes from the
    worker's init reply (the architecture picks the prefill path)."""

    def __init__(self, replica: "ProcessReplica", spec: dict,
                 exact_prefill: bool = False):
        self._replica = replica
        kw = spec.get("engine_kw") or {}
        self.exact_prefill = bool(exact_prefill)
        self.max_seq = int(kw.get("max_seq", 256))
        self.max_batch = int(kw.get("max_batch", 8))
        self.packed = bool(kw.get("packed", False))

    def _bucket(self, s: int) -> int:
        return min(max(_next_pow2(s), MIN_BUCKET), self.max_seq)

    @property
    def queue(self) -> list:
        """Depth-only placeholder: the queued Request objects live in the
        worker process; router policies only ever len() this."""
        return [None] * self._replica.queue_depth


class ProcessReplica:
    """One replica living in its own OS process, driven over the socket
    RPC control plane (``serving/ipc.py`` / ``serving/worker.py``).

    Duck-types :class:`Replica`'s backend seam (submit / step /
    sample_occupancy / idle / records / store_records / drain / close plus
    the router-visible load counters), so the Router and ServingCluster
    drive both kinds identically. Differences that matter:

    * **Load counters are snapshots.** Every submit/harvest RPC reply
      carries the worker's fresh ``load_snapshot()``; between RPCs the
      counters are as stale as the last exchange — exactly the staleness
      a distributed router lives with.
    * **Records merge at harvest.** The parent keeps a stub
      ``RequestRecord`` per submit (the object ``Gateway`` mutates); when
      the child's finished record arrives it is folded INTO the stub in
      place — stage/cpu charges summed, ``t_done`` rebased from the
      child's perf_counter epoch onto the parent's via the handshake
      ``clock_offset`` — so record identity is stable across the
      request's whole life (see ``core.metrics.merge_record_streams``
      for the skew rationale).
    * **Occupancy is sampled child-side.** The worker's pipeline counts
      its own steps/busy-slot-steps; :meth:`sample_occupancy` is a no-op
      and the balance telemetry reads the snapshot.
    """

    def __init__(self, index: int, client, spec: dict, pods: tuple = (),
                 init_info: Optional[dict] = None):
        self.index = index
        self.client = client  # ipc.ReplicaClient
        self.pods = pods
        # the worker's init reply: its device, warm wall, weight checksum
        self.init_info = dict(init_info or {})
        self.routed = 0
        # debug-mode stamp validation after every cross-clock rebase (the
        # engines' own debug_stamps knob checks the same stamps child-side
        # BEFORE the rebase; this catches a bad offset sign/staleness)
        self.debug_stamps = bool(
            (spec.get("engine_kw") or {}).get("debug_stamps")
        )
        self.engine = _RemoteEngineFacade(
            self, spec, self.init_info.get("exact_prefill", False))
        self._load = {
            "queue_depth": 0, "occupancy": 0,
            "free_slots": self.engine.max_batch, "outstanding_tokens": 0,
            "steps": 0, "busy_slot_steps": 0, "submitted": 0, "emitted": 0,
            "submitted_bytes": 0, "idle": True,
        }
        self._records_local: dict = {}  # request_id -> merged/stub record
        self._store = ProfileStore()

    # -------------------------- load counters ------------------------- #
    @property
    def queue_depth(self) -> int:
        return self._load["queue_depth"]

    @property
    def occupancy(self) -> int:
        return self._load["occupancy"]

    @property
    def free_slots(self) -> int:
        return self._load["free_slots"]

    @property
    def jobs(self) -> int:
        return self.queue_depth + self.occupancy

    @property
    def outstanding_tokens(self) -> int:
        return self._load["outstanding_tokens"]

    @property
    def steps(self) -> int:
        return self._load["steps"]

    @property
    def busy_slot_steps(self) -> int:
        return self._load["busy_slot_steps"]

    @property
    def occupancy_mean(self) -> float:
        denom = self.steps * self.engine.max_batch
        return self.busy_slot_steps / denom if denom else 0.0

    @property
    def clock_offset(self) -> float:
        return self.client.clock_offset

    # --------------------------- backend seam ------------------------- #
    @property
    def idle(self) -> bool:
        """Fresh check (one load RPC): drain loops poll this, and a stale
        snapshot would end them early or never."""
        self._load = self.client.load()
        return bool(self._load["idle"])

    @property
    def queued_requests(self) -> list:
        return self.engine.queue

    @property
    def records(self) -> dict:
        return self._records_local

    def submit(self, req, now: Optional[float] = None) -> None:
        # the stub is what Gateway mutates between submit and harvest;
        # engine-side ingress charges happen in the WORKER's engine and
        # fold in at harvest, so nothing is double-charged here
        self._records_local[req.request_id] = RequestRecord(
            request_id=req.request_id, client_id=req.client_id,
            priority=req.priority, t_issue=time.perf_counter(),
            bytes_in=req.payload_bytes, bytes_out=4 * req.max_new_tokens,
        )
        self._load = self.client.submit(req)

    def _merge(self, pairs) -> list:
        """Fold harvested child records into their parent-side stubs (in
        place — Gateway holds references) and return the responses."""
        out = []
        for rsp, child in pairs:
            stub = self._records_local.get(child.request_id)
            if stub is None:  # submitted out-of-band; adopt as-is, rebased
                stub = dataclasses.replace(
                    child,
                    t_issue=child.t_issue - self.clock_offset,
                    stage_s=dict(child.stage_s),
                )
                self._records_local[child.request_id] = stub
                stub.t_done = child.t_done - self.clock_offset
            else:
                for k, v in child.stage_s.items():
                    stub.add(k, v)
                stub.cpu_s += child.cpu_s
                stub.transfer_wall_s += child.transfer_wall_s
                stub.t_done = child.t_done - self.clock_offset
            if self.debug_stamps:
                # rebased completion must stay after the parent-side issue
                # stamp (tolerating the RTT/2 handshake estimate error) —
                # an inversion here means the offset sign flipped or went
                # stale, exactly the bug this mode exists to catch
                trace.validate_stamps(
                    stub.t_issue, 0.0, stub.t_done, tol=0.05,
                    where=f"replica{self.index} record {stub.request_id} "
                          f"after clock rebase",
                )
            self._store.add(stub)
            out.append(rsp)
        return out

    def step(self) -> list:
        pairs, self._load = self.client.harvest()
        return self._merge(pairs)

    def sample_occupancy(self) -> None:
        pass  # the worker's pipeline samples its own occupancy

    def store_records(self) -> list:
        return list(self._store.records)

    def drain(self, deadline_s: float = 120.0) -> list:
        """One blocking drain RPC: the worker runs its pipeline to idle
        and ships everything it finished along the way."""
        pairs = self.client.drain(deadline_s)
        self._load = self.client.load()
        return self._merge(pairs)

    def telemetry(self) -> dict:
        return self.client.telemetry()

    def metrics_snapshot(self) -> dict:
        return self.client.telemetry().get("metrics", {})

    def trace_flush(self) -> None:
        pass  # the worker flushes its own windows at drain

    def close(self) -> None:
        self.client.close()


class Router:
    """Pluggable admission policy: maps a request to a replica index.

    Stateless reads of the replicas' load counters plus two bits of
    router-local state (the round-robin cursor and the affinity
    bucket->replica map); every tie breaks toward the lowest replica
    index, so routing is deterministic given the submission sequence.
    """

    POLICIES = ("round_robin", "jsq", "least_loaded", "affinity",
                "prefix_cache")

    def __init__(self, policy: str = "least_loaded"):
        if policy not in self.POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; pick one of {self.POLICIES}"
            )
        self.policy = policy
        self._rr = 0
        self._affinity: dict = {}  # prefill bucket/shape key -> replica
        self._prefix_home: dict = {}  # first prompt page -> replica

    def pick(self, req, replicas: list) -> int:
        if self.policy == "round_robin":
            i = self._rr % len(replicas)
            self._rr += 1
            return i
        if self.policy == "jsq":
            # shortest queue = fewest requests in system; ties break by
            # outstanding work (two replicas with one job each are NOT
            # equal when one job is a 2-token request and the other a
            # 192-token decode), then index — so ties stay deterministic
            # without blindly parking work behind a long decode
            return min(
                range(len(replicas)),
                key=lambda i: (replicas[i].jobs,
                               replicas[i].outstanding_tokens, i),
            )
        if self.policy == "least_loaded":
            # outstanding work first, then spare slot headroom
            return min(
                range(len(replicas)),
                key=lambda i: (replicas[i].outstanding_tokens,
                               -replicas[i].free_slots, i),
            )
        if self.policy == "prefix_cache":
            return self._pick_prefix_cache(req, replicas)
        # affinity: sticky pow2-bucket placement
        key = self._bucket_key(req, replicas[0].engine)
        if key not in self._affinity:
            counts = [0] * len(replicas)
            for r in self._affinity.values():
                counts[r] += 1
            self._affinity[key] = min(
                range(len(replicas)),
                key=lambda i: (counts[i], replicas[i].jobs, i),
            )
        return self._affinity[key]

    def _pick_prefix_cache(self, req, replicas: list) -> int:
        """Estimated prefix-hit routing: score each replica by how many
        prompt tokens its radix index already holds (a peek — no LRU or
        hit/miss distortion) and send the request to the deepest match;
        among equally-deep matches, the least-loaded replica wins. When
        no replica has any of the prompt (a cold system prompt, or
        engines without prefix reuse scoring a flat 0), fall back to a
        sticky map keyed on the prompt's FIRST page, so repeats of the
        same system prompt converge on one replica and turn its future
        lookups into hits instead of spraying cold prefills."""
        scores = [
            rep.engine.prefix_lookup_tokens(req.prompt_tokens)
            if hasattr(rep.engine, "prefix_lookup_tokens") else 0
            for rep in replicas
        ]
        if max(scores) > 0:
            return min(
                range(len(replicas)),
                key=lambda i: (-scores[i],
                               replicas[i].outstanding_tokens, i),
            )
        key = tuple(int(t) for t in req.prompt_tokens[:PAGE])
        if key not in self._prefix_home:
            self._prefix_home[key] = min(
                range(len(replicas)),
                key=lambda i: (replicas[i].outstanding_tokens,
                               replicas[i].jobs, i),
            )
        return self._prefix_home[key]

    def _bucket_key(self, req, engine):
        """The prefill shape the request admits into: its pow2 bucket on
        the bucketed path, or its exact (length, features) shape on the
        exact path -- either way, co-locating equal keys means co-located
        requests share one prefill shape."""
        if not engine.exact_prefill and req.features is None:
            if getattr(engine, "packed", False):
                # packed engines dispatch per pow2 PACKED width (the sum
                # of an admission's true lengths); keying on the
                # per-request bucket still co-locates similar lengths,
                # keeping each replica's packed widths stable without
                # funneling every request to one replica
                return ("packed", engine._bucket(len(req.prompt_tokens)))
            return ("bucket", engine._bucket(len(req.prompt_tokens)))
        feat = None if req.features is None else tuple(req.features.shape)
        return ("exact", len(req.prompt_tokens), feat)


class _MergedRecords:
    """Read-only mapping view over the replicas' per-request record dicts
    (what ``Gateway`` reaches through ``engine._records``)."""

    def __init__(self, dicts):
        self._dicts = dicts

    def get(self, key, default=None):
        for d in self._dicts:
            if key in d:
                return d[key]
        return default

    def __getitem__(self, key):
        rec = self.get(key)
        if rec is None:
            raise KeyError(key)
        return rec

    def __contains__(self, key) -> bool:
        return any(key in d for d in self._dicts)


class ServingCluster:
    """N engine replicas behind a :class:`Router`.

    The public surface matches a single engine — :meth:`submit`,
    :meth:`step`, :meth:`run_until_drained`, ``queue``, ``store``,
    ``idle`` — so ``Gateway``, the load generators, and the closed-loop
    client drive a cluster exactly like one engine. :meth:`step` steps
    every replica once (replicas are independent; a real deployment steps
    them in parallel processes) and samples per-replica occupancy for the
    balance telemetry.
    """

    def __init__(self, replicas: list, *, policy: str = "least_loaded",
                 router: Optional[Router] = None):
        if not replicas:
            raise ValueError("cluster needs at least one replica")
        self.replicas = [
            r if isinstance(r, (Replica, ProcessReplica)) else Replica(i, r)
            for i, r in enumerate(replicas)
        ]
        self.router = router if router is not None else Router(policy)
        self.responses: list = []  # completion-ordered, for telemetry
        self._where: dict = {}  # request_id -> replica index
        self._closed = False
        # cluster-level observability: the sampler polls per-replica
        # queue depth / occupancy into this registry's histograms while a
        # drain runs; telemetry() embeds its snapshot
        self.registry = Registry()
        self._sampler: Optional[Sampler] = None

    # ------------------------------------------------------------------ #
    @classmethod
    def build(cls, model, params, *, n_replicas: int = 2,
              engine: str = "fused", mesh=None,
              pods_per_replica: Optional[int] = None,
              policy: str = "least_loaded",
              router: Optional[Router] = None, warmup: bool = False,
              backend: str = "inprocess",
              devices_per_replica: Optional[int] = None, param_seed: int = 0,
              backlog: int = 2, rpc_timeout_s: float = 120.0,
              init_timeout_s: float = 600.0, device="cuda",
              **engine_kw) -> "ServingCluster":
        """Construct a cluster of ``n_replicas`` engines on ``device`` (the
        card unless ``"cpu"`` is asked for).

        engine: 'fused' (one :class:`ServingEngine` per replica) or
        'disagg' (one :class:`~repro_torch.serving.disagg.
        DisaggregatedEngine` per replica, its KV handoff under
        ``engine_kw['transfer_mode']``). In-process replicas share
        ``params``; each has its own decode pool.

        backend: 'inprocess' (every replica an object in this interpreter,
        stepped one after another by :meth:`step`) or 'process' (each
        replica its OWN OS process with its own CUDA context, spoken to
        over the socket RPC control plane: real concurrency). The process
        backend ignores ``params`` and rebuilds each worker's weights from
        ``param_seed`` (``model.init(torch.Generator(device).manual_seed(
        param_seed))``); pass params drawn from the SAME seed for an
        in-process-vs-process A/B. Workers start overlapped; ``with`` the
        cluster (or :meth:`close` it) so they are reaped on every exit
        path.

        mesh: a ``('pod',)``-axis :class:`~repro_torch.launch.mesh.
        DeviceMesh` to carve up (in-process backend only; default
        ``make_cluster_mesh(n_replicas, pods_per_replica, device)``), each
        replica owning ``pods_per_replica`` pods of it (default 1 fused, 2
        disaggregated). ``devices_per_replica`` (process backend; default
        1 fused, 2 disaggregated) hands worker i the card indices ``i *
        devices_per_replica + j`` modulo the cards there are: on one card
        every worker gets ``cuda:0``; a disaggregated worker places its two
        stages on its devices. Remaining ``engine_kw`` (max_batch,
        max_seq, transfer_mode, temperature, ...) pass through to every
        replica's engine; ``warmup`` warms each replica at construction.
        """
        if engine not in ("fused", "disagg"):
            raise ValueError(f"engine must be 'fused' or 'disagg': {engine}")
        if backend not in ("inprocess", "process"):
            raise ValueError(
                f"backend must be 'inprocess' or 'process': {backend}"
            )
        if backend == "process":
            if mesh is not None:
                raise ValueError("mesh carves in-process replicas; the "
                                 "process backend takes devices_per_replica")
            return cls._build_process(
                model, n_replicas=n_replicas, engine=engine,
                policy=policy, router=router, warmup=warmup,
                devices_per_replica=devices_per_replica,
                param_seed=param_seed, backlog=backlog,
                rpc_timeout_s=rpc_timeout_s,
                init_timeout_s=init_timeout_s, device=device, **engine_kw,
            )
        ppr = (1 if engine == "fused" else 2) \
            if pods_per_replica is None else pods_per_replica
        if mesh is None:
            mesh = make_cluster_mesh(n_replicas, ppr, device=device)
        if "pod" not in mesh.axis_names:
            raise ValueError(f"mesh has no 'pod' axis: {mesh.axis_names}")
        slices = replica_pod_slices(mesh.shape["pod"], n_replicas, ppr)
        placed: dict = {}  # device -> params there: one copy a device
        replicas = []
        for i, pods in enumerate(slices):
            # per-replica trace tag: in-process replicas share MainThread,
            # so the tag keeps their process-level spans (decode windows,
            # handoffs) on distinct trace lanes
            kw_i = dict(engine_kw)
            kw_i.setdefault("trace_tag", f"replica{i}")
            sub = pod_slice_mesh(mesh, pods)
            dev = sub.first_device
            if engine == "fused":
                if dev not in placed:
                    placed[dev] = place_on_slice(params, mesh, pods)
                eng = ServingEngine(model.on(dev), placed[dev],
                                    warmup=warmup, device=dev, **kw_i)
            else:
                from repro_torch.serving.disagg import DisaggregatedEngine

                eng = DisaggregatedEngine(model, params, mesh=sub,
                                          warmup=warmup, device=dev,
                                          _placed=placed, **kw_i)
            replicas.append(Replica(i, eng, pods))
        out = cls(replicas, policy=policy, router=router)
        out.mesh = mesh
        return out

    @classmethod
    def _build_process(cls, model, *, n_replicas: int, engine: str,
                       policy: str, router: Optional[Router], warmup: bool,
                       devices_per_replica: Optional[int], param_seed: int,
                       backlog: int, rpc_timeout_s: float,
                       init_timeout_s: float, device,
                       **engine_kw) -> "ServingCluster":
        """Process backend: spawn ``n_replicas`` worker processes, overlap
        their start (imports, handshake) and their init (the param rebuild
        on their devices, optional warm-up), and wrap each in a
        :class:`ProcessReplica`."""
        from repro_torch.serving.ipc import ReplicaClient

        dpr = (1 if engine == "fused" else 2) \
            if devices_per_replica is None else int(devices_per_replica)
        if dpr < 1:
            raise ValueError(f"devices_per_replica must be >= 1: {dpr}")
        avail = available_devices(device)
        spec = {
            "cfg": model.cfg,
            "dtype": str(model.dtype).removeprefix("torch."),
            "param_seed": int(param_seed),
            "device": str(device),
            "engine": engine,
            "engine_kw": dict(engine_kw, warmup=warmup),
            "backlog": int(backlog),
            # workers inherit the parent's tracing state at build time;
            # their spans ship back on harvest/telemetry/drain replies and
            # are rebased and relabelled by the ReplicaClient at ingest
            "tracing": trace.tracing_enabled(),
        }
        clients, replicas = [], []
        try:
            # a worker imports torch before it connects back, so the spawns
            # and handshakes run on threads of their own, overlapped
            with ThreadPoolExecutor(max_workers=n_replicas) as pool:
                futures = [pool.submit(
                    ReplicaClient, label=f"replica{i}",
                    call_timeout_s=rpc_timeout_s,
                    init_timeout_s=init_timeout_s,
                ) for i in range(n_replicas)]
                errors = []
                for f in futures:
                    try:
                        clients.append(f.result())
                    except Exception as e:  # close the rest, then raise
                        errors.append(e)
            if errors:
                raise errors[0]
            specs = [dict(spec, devices=[
                str(avail[(i * dpr + j) % len(avail)]) for j in range(dpr)])
                for i in range(n_replicas)]
            for c, s in zip(clients, specs):  # overlapped: built concurrently
                c.start_init(s)
            for i, c in enumerate(clients):
                info = c.wait_init()
                replicas.append(ProcessReplica(i, c, specs[i], pods=(0,),
                                               init_info=info))
        except Exception:
            for c in clients:
                c.close(timeout_s=2.0)
            raise
        return cls(replicas, policy=policy, router=router)

    # ------------------------------------------------------------------ #
    def submit(self, req, now: Optional[float] = None) -> int:
        """Route ``req`` to a replica and join its admission queue; the
        replica's engine stamps arrival and charges the modeled ingress.
        Returns the replica index (recorded for telemetry)."""
        t0 = time.perf_counter()
        i = self.router.pick(req, self.replicas)
        trace.tracer().emit(
            "router.pick", t0, time.perf_counter(),
            request_id=req.request_id, policy=self.router.policy, replica=i,
        )
        rep = self.replicas[i]
        rep.submit(req, now)
        rep.routed += 1
        self._where[req.request_id] = i
        return i

    def step(self) -> list:
        """One cluster iteration: step every replica once (an in-process
        replica runs admit/dispatch/harvest; a process replica harvests
        whatever its worker finished since last time), collect finished
        responses, sample occupancy for the balance index."""
        done = []
        for rep in self.replicas:
            done.extend(rep.step())
            rep.sample_occupancy()
        self.responses.extend(done)
        return done

    @property
    def idle(self) -> bool:
        return all(rep.idle for rep in self.replicas)

    @property
    def async_draining(self) -> bool:
        """True when stepping is not what makes progress (process-backed
        replicas drain in their own processes) — the open-loop driver's
        cue that it may sleep instead of spin."""
        return any(
            isinstance(rep, ProcessReplica) or
            getattr(rep.engine, "async_draining", False)
            for rep in self.replicas
        )

    def run_until_drained(self, max_steps: int = 10_000) -> list:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if self.idle:
                for rep in self.replicas:
                    rep.trace_flush()
                break
        return out

    # ------------------------------------------------------------------ #
    # single-engine-compatible surface (Gateway, loadgen, closed loop)
    # ------------------------------------------------------------------ #
    @property
    def queue(self) -> list:
        """All queued (unadmitted) requests across replicas (process
        replicas contribute depth-only placeholders — their Request
        objects live in the worker)."""
        return [r for rep in self.replicas for r in rep.queued_requests]

    @property
    def _records(self) -> _MergedRecords:
        return _MergedRecords([rep.records for rep in self.replicas])

    @property
    def store(self) -> ProfileStore:
        """Merged ProfileStore over every replica's records, on ONE
        timeline: process replicas' records were rebased onto the
        parent's clock at harvest, so the streams merge with zero
        offsets and sort by completion (see ``core.metrics.
        merge_record_streams`` for the skew rationale). Rebuilt per
        access; records are shared, not copied."""
        s = ProfileStore()
        s.records.extend(merge_record_streams(
            [rep.store_records() for rep in self.replicas]
        ))
        return s

    def replica_of(self, request_id: int) -> Optional[int]:
        return self._where.get(request_id)

    # ------------------------------------------------------------------ #
    @property
    def parallelism(self) -> str:
        """How replicas actually execute: ``"process-per-replica"`` (real
        OS-process concurrency) or ``"sequential-in-process"`` (stepped
        one after another in this interpreter — queueing effects are
        real, parallel capacity is not). Recorded in telemetry so the two
        regimes' numbers can't be conflated."""
        if any(isinstance(r, ProcessReplica) for r in self.replicas):
            return "process-per-replica"
        return "sequential-in-process"

    def drain(self, deadline_s: float = 120.0) -> list:
        """Drain every replica to idle. Process replicas drain INSIDE
        their workers (one blocking RPC each — tight timing, no parent
        poll loop); in-process replicas step here."""
        done = []
        for rep in self.replicas:
            done.extend(rep.drain(deadline_s))
        self.responses.extend(done)
        return done

    # ------------------------------------------------------------------ #
    # background observability sampler
    # ------------------------------------------------------------------ #
    def start_sampler(self, interval_s: float = 0.005) -> Sampler:
        """Start the background queue-depth / slot-occupancy sampler:
        every ``interval_s`` it observes each replica's counters into
        same-named histograms in :attr:`registry` (process replicas read
        the last RPC load snapshot — no extra wire traffic). Pair with
        :meth:`stop_sampler`; sources that raise are captured and
        re-raised there, never swallowed."""
        if self._sampler is not None:
            raise RuntimeError("sampler already running")
        sources = {}
        for rep in self.replicas:
            sources[f"replica{rep.index}.queue_depth"] = (
                lambda r=rep: r.queue_depth
            )
            sources[f"replica{rep.index}.occupancy"] = (
                lambda r=rep: r.occupancy
            )
        self._sampler = Sampler(
            self.registry, sources, interval_s=interval_s
        ).start()
        return self._sampler

    def stop_sampler(self, *, check: bool = True) -> None:
        if self._sampler is not None:
            s, self._sampler = self._sampler, None
            s.stop(check=check)

    def close(self) -> None:
        """Shut replicas down (terminate worker processes for the
        process backend). Idempotent; safe on error paths — always
        ``close()`` (or ``with``) a process-backed cluster, or its
        workers outlive the router until the atexit reaper."""
        if self._closed:
            return
        self._closed = True
        self.stop_sampler(check=False)
        for rep in self.replicas:
            try:
                rep.close()
            except Exception:
                pass  # reap the rest regardless

    def __enter__(self) -> "ServingCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    def telemetry(self, *, warmup: int = 0) -> dict:
        """SLO + balance snapshot: warmup-aware TTFT/TPOT/E2E/queue
        percentiles over the completions so far, per-replica load
        counters, and Jain balance indices (busy-slot time and routed
        counts; 1.0 = perfectly balanced, 1/n = one replica took all)."""
        busy = [rep.busy_slot_steps for rep in self.replicas]
        out = {
            "policy": self.router.policy,
            "n_replicas": len(self.replicas),
            "parallelism": self.parallelism,
            "slo": slo_summary(self.responses, warmup=warmup),
            "per_replica": [
                {
                    "pods": list(rep.pods),
                    "routed": rep.routed,
                    "busy_slot_steps": rep.busy_slot_steps,
                    "occupancy_mean": round(rep.occupancy_mean, 4),
                }
                for rep in self.replicas
            ],
            "balance_index_busy": round(jain_index(busy), 4),
            "balance_index_routed": round(
                jain_index([rep.routed for rep in self.replicas]), 4
            ),
            # unified metrics surface: each replica's engine counters
            # through the obs.Registry (process replicas ship theirs over
            # the telemetry RPC), plus the cluster-level sampler registry
            # and this process's trace-buffer health
            "metrics": [rep.metrics_snapshot() for rep in self.replicas],
            "obs": self.registry.snapshot(),
            "trace": trace.tracer().stats(),
        }
        if self.parallelism == "process-per-replica":
            # control-plane conservation counters: what each worker
            # acknowledged vs what the router sent it, plus raw RPC wire
            # volume — the process-backend analogue of the engines'
            # handoff byte reconciliation
            out["ipc"] = [
                {
                    "replica": rep.index,
                    "rpc_bytes_sent": rep.client.bytes_sent,
                    "rpc_bytes_recv": rep.client.bytes_recv,
                    "request_payload_bytes":
                        rep.client.request_payload_bytes,
                    "submitted": rep._load["submitted"],
                    "emitted": rep._load["emitted"],
                    "submitted_bytes": rep._load["submitted_bytes"],
                    "clock_offset_s": round(rep.clock_offset, 6),
                }
                for rep in self.replicas
                if isinstance(rep, ProcessReplica)
            ]
        return out
