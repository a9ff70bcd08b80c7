"""The port's cluster tier against the JAX package's on the CPU: the
Router's picks for all five policies on the same stub loads; an in-process
ServingCluster's tokens, replica map and routed counts against the JAX
cluster's on the same converted weights (fused, and disaggregated under
DIRECT_HBM and DIRECT_DMA); prefix_cache routing on paged replicas; the
Gateway's modelled charges over a cluster against JAX's; the trace replay
round trip; the open and closed loops; telemetry, the sampler and the
build's refusals (fp32)."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.transfer import TransferMode as JaxMode  # noqa: E402
from repro.core.transport import Transport as JaxTransport  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serving import Gateway as JaxGateway  # noqa: E402
from repro.serving import Router as JaxRouter  # noqa: E402
from repro.serving import ServingCluster as JaxCluster  # noqa: E402
from repro.serving import loadgen as jax_loadgen  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import trace  # noqa: E402
from repro_torch.core.transfer import TransferMode  # noqa: E402
from repro_torch.core.transport import Transport  # noqa: E402
from repro_torch.launch.mesh import DeviceMesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Gateway,
    Request,
    Router,
    ServingCluster,
    ServingEngine,
    load_trace,
    poisson_schedule,
    run_closed_loop_baseline,
    run_open_loop,
    save_trace,
    trace_schedule,
)
from repro_torch.serving.cluster import replica_pod_slices  # noqa: E402
from repro_torch.serving.loadgen import shared_prefix_schedule  # noqa: E402

LENS = [5, 9, 14, 20, 26, 33]
KW = dict(max_batch=2, max_seq=64)


def micro(cfg):
    """benchmarks/serving.py's llama3-8b-micro."""
    import dataclasses

    return dataclasses.replace(
        cfg.reduced(), name="llama3-8b-micro", d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=32)


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(micro(jax_get_config("llama3-8b")), dtype=jnp.float32)
    jp = jm.init(jax.random.key(0))
    cfg = micro(get_config("llama3-8b"))
    tm = Model(cfg, dtype=torch.float32, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


def _prompts(vocab, lens, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, s, dtype=np.int32) for s in lens]


def _drain(front, req_cls, prompts, max_new=4):
    reqs = [req_cls(prompt_tokens=p.copy(), max_new_tokens=max_new)
            for p in prompts]
    for r in reqs:
        front.submit(r, time.perf_counter())
    out = front.run_until_drained(max_steps=100_000)
    assert len(out) == len(reqs)
    return reqs, out


# --------------------------------------------------------------------------- #
# Router.pick against JAX's on the same stub loads
# --------------------------------------------------------------------------- #
class _StubEngine:
    def __init__(self, cached: int, exact: bool = False):
        self.cached = cached
        self.exact_prefill = exact
        self.bucketed_prefill = not exact
        self.packed = False
        self.max_seq = 128

    def _bucket(self, s):
        return min(max(1 << max(s - 1, 0).bit_length(), 16), self.max_seq)

    def prefix_lookup_tokens(self, tokens):
        return self.cached


class _StubReplica:
    def __init__(self, jobs, outstanding, free, cached=0, exact=False):
        self.jobs = jobs
        self.outstanding_tokens = outstanding
        self.free_slots = free
        self.engine = _StubEngine(cached, exact)


LOADS = [  # (jobs, outstanding tokens, free slots, cached prefix tokens)
    [(0, 0, 2, 0), (0, 0, 2, 0), (0, 0, 2, 0)],
    [(2, 40, 0, 0), (1, 3, 1, 16), (1, 3, 1, 48)],
    [(1, 8, 1, 32), (3, 8, 2, 32), (0, 9, 2, 0)],
    [(1, 5, 1, 0), (1, 5, 1, 0), (0, 50, 2, 0)],
    [(4, 90, 0, 16), (0, 0, 2, 0), (2, 12, 1, 16)],
]


@pytest.mark.parametrize("policy", list(Router.POLICIES))
def test_router_picks_match_jax(policy):
    """A stream of requests (prompt lengths spanning buckets, first pages
    repeating) over evolving stub loads: the port's Router picks what the
    JAX Router picks, one for one."""
    assert Router.POLICIES == JaxRouter.POLICIES
    router, jrouter = Router(policy), JaxRouter(policy)
    rng = np.random.default_rng(17)
    pages = [rng.integers(0, 256, 16, dtype=np.int32) for _ in range(3)]
    got, want = [], []
    for i in range(40):
        load = LOADS[i % len(LOADS)]
        reps = [_StubReplica(*row, exact=(i % 7 == 6)) for row in load]
        n = int(rng.integers(1, 120))
        prompt = np.concatenate([pages[i % 3],
                                 rng.integers(0, 256, n, dtype=np.int32)])
        got.append(router.pick(Request(prompt_tokens=prompt), reps))
        want.append(jrouter.pick(JaxRequest(prompt_tokens=prompt), reps))
    assert got == want
    assert len(set(got)) > 1


def test_router_validates_policy_and_pod_slices():
    with pytest.raises(ValueError, match="unknown policy"):
        Router("random")
    assert replica_pod_slices(4, 2, 2) == [(0, 1), (2, 3)]
    assert replica_pod_slices(1, 2, 2) == [(0,), (0,)]  # one card


# --------------------------------------------------------------------------- #
# the cluster against the JAX cluster on the same weights
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("engine,mode,policy", [
    ("fused", None, "least_loaded"),
    ("fused", None, "jsq"),
    ("disagg", "direct_hbm", "round_robin"),
    ("disagg", "direct_dma", "affinity"),
])
def test_cluster_tokens_routing_match_jax(models, engine, mode, policy):
    """Submitted all at once, the requests are routed on the same loads:
    the port's replica map, routed counts and tokens are the JAX
    cluster's; and a cluster is numerically invisible -- its tokens are
    the same requests' on standalone engines split the way it routed."""
    jm, jp, tm, tp = models
    prompts = _prompts(tm.cfg.vocab_size, LENS)
    kw = dict(KW)
    jkw = dict(KW)
    if mode is not None:
        kw["transfer_mode"] = TransferMode(mode)
        jkw["transfer_mode"] = JaxMode(mode)
    cl = ServingCluster.build(tm, tp, n_replicas=2, engine=engine,
                              policy=policy, device="cpu", **kw)
    jcl = JaxCluster.build(jm, jp, n_replicas=2, engine=engine,
                           policy=policy, **jkw)
    reqs, _ = _drain(cl, Request, prompts)
    jreqs, _ = _drain(jcl, JaxRequest, prompts)
    where = [cl.replica_of(r.request_id) for r in reqs]
    assert where == [jcl.replica_of(r.request_id) for r in jreqs]
    assert [r.routed for r in cl.replicas] == [r.routed for r in jcl.replicas]
    assert sum(r.routed for r in cl.replicas) == len(prompts)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert all(r.engine.trace_tag == f"replica{i}"
               for i, r in enumerate(cl.replicas))
    assert cl.replicas[0].engine.params is cl.replicas[1].engine.params
    assert cl.replicas[0].engine.pool is not cl.replicas[1].engine.pool
    # standalone engines, fed what the cluster routed to each replica
    solo = []
    for k in range(2):
        eng = (ServingEngine(tm, tp, device="cpu", **kw) if engine == "fused"
               else cl.replicas[k].engine.__class__(tm, tp, device="cpu",
                                                    **kw))
        mine = [p for p, w in zip(prompts, where) if w == k]
        solo.append(iter(_drain(eng, Request, mine)[0]) if mine else iter(()))
    assert [r.generated for r in reqs] == \
        [next(solo[w]).generated for w in where]
    tel = cl.telemetry()
    assert tel["parallelism"] == "sequential-in-process"
    assert tel["n_replicas"] == 2 and tel["slo"]["n"] == len(prompts)
    assert [row["routed"] for row in tel["per_replica"]] == \
        [r.routed for r in cl.replicas]
    assert [row["pods"] for row in tel["per_replica"]] == [[0], [0]]
    assert len(tel["metrics"]) == 2
    assert sum(m["counters"]["engine.requests_finished"]
               for m in tel["metrics"]) == len(prompts)
    jtel = jcl.telemetry()
    assert tel["balance_index_routed"] == jtel["balance_index_routed"]
    assert len(cl.store.records) == len(prompts)


def test_prefix_cache_routes_each_family_to_one_replica(models):
    """tests/test_paged.py's law on the port: on paged replicas with
    prefix reuse, each system-prompt family lands wholly on one replica,
    and the replica map is the JAX cluster's."""
    jm, jp, tm, tp = models
    kw = dict(max_batch=2, max_seq=128, paged=True)

    args = dict(rate_rps=100.0, n_requests=8, n_prefixes=2, prefix_len=32,
                suffix_len=16, max_new=2, seed=5)
    cl = ServingCluster.build(tm, tp, n_replicas=2, policy="prefix_cache",
                              device="cpu", **kw)
    jcl = JaxCluster.build(jm, jp, n_replicas=2, policy="prefix_cache", **kw)
    ours = shared_prefix_schedule(256, **args)
    theirs = jax_loadgen.shared_prefix_schedule(256, **args)
    for a in ours:
        cl.submit(a.request)
    for a in theirs:
        jcl.submit(a.request)
    assert len(cl.run_until_drained()) == len(jcl.run_until_drained()) == 8
    fams = {}
    for a in ours:
        key = tuple(int(t) for t in a.request.prompt_tokens[:16])
        fams.setdefault(key, set()).add(cl.replica_of(a.request.request_id))
    assert all(len(v) == 1 for v in fams.values()), fams
    got = [cl.replica_of(a.request.request_id) for a in ours]
    assert got == [jcl.replica_of(a.request.request_id) for a in theirs]
    assert sum(r.engine.prefix_hits for r in cl.replicas) == \
        sum(r.engine.prefix_hits for r in jcl.replicas) > 0


def test_gateway_over_cluster_charges_match_jax(models):
    """Gateway(TCP) over a 2-replica GDR cluster: the modelled first hop
    on each stored record (request and response stages, the TCP CPU) and
    on each Response equals the JAX gateway's on the same requests."""
    jm, jp, tm, tp = models
    prompts = _prompts(tm.cfg.vocab_size, [8, 9, 30], 4)
    cl = ServingCluster.build(tm, tp, n_replicas=2, policy="round_robin",
                              device="cpu", max_batch=1, max_seq=64)
    jcl = JaxCluster.build(jm, jp, n_replicas=2, policy="round_robin",
                           max_batch=1, max_seq=64)
    trace.enable_tracing()
    try:
        reqs, out = _drain(Gateway(cl, first_hop=Transport.TCP), Request,
                           prompts, 2)
        tr = trace.Trace.from_buffer()
    finally:
        trace.disable_tracing()
    jreqs, jout = _drain(JaxGateway(jcl, first_hop=JaxTransport.TCP),
                         JaxRequest, prompts, 2)
    by_id = {r.request_id: r for r in out}
    jby_id = {r.request_id: r for r in jout}
    for r, jr in zip(reqs, jreqs):
        rec, jrec = cl._records[r.request_id], jcl._records[jr.request_id]
        for stage in ("request", "response"):
            assert rec.stage_s[stage] == pytest.approx(jrec.stage_s[stage],
                                                       rel=1e-12)
        assert rec.cpu_s == pytest.approx(jrec.cpu_s, rel=1e-12)
        assert rec.cpu_s > 0  # TCP keeps the CPU on the data path
        assert by_id[r.request_id].stage_s["response"] == pytest.approx(
            jby_id[jr.request_id].stage_s["response"], rel=1e-12)
    assert len(cl.store.records) == 3
    assert cl._records.get(-1) is None
    with pytest.raises(KeyError):
        cl._records[-1]
    names = [s.name for s in tr.spans]
    for name in ("gateway.submit", "gateway.response", "router.pick"):
        assert names.count(name) == 3, name
    # the hop is modelled: an instant span carrying the charge as an attr
    for s in tr.spans:
        if s.name == "gateway.submit":
            rec = cl._records[s.request_id]
            assert s.wall == 0.0 and s.attrs["charge"] == "modeled"
            assert s.attrs["transport"] == "TCP"
            assert s.attrs["hop_s"] < rec.stage_s["request"]


# --------------------------------------------------------------------------- #
# traffic: trace replay, the open and closed loops
# --------------------------------------------------------------------------- #
def test_trace_schedule_roundtrip_matches_jax(tmp_path):
    entries = [
        {"t": 0.0, "prompt_len": 8, "max_new": 2},
        {"t": 0.5, "prompt_len": 16, "max_new": 4, "priority": 1},
        {"t": 0.5, "prompt_len": 3, "client_id": 2},
    ]
    path = tmp_path / "trace.jsonl"
    save_trace(path, entries)
    assert load_trace(path) == entries == jax_loadgen.load_trace(path)
    sched = trace_schedule(load_trace(path), vocab=256, seed=7)
    again = trace_schedule(entries, vocab=256, seed=7)
    want = jax_loadgen.trace_schedule(entries, vocab=256, seed=7)
    assert [a.t for a in sched] == [a.t for a in want] == [0.0, 0.5, 0.5]
    for a, b, c in zip(sched, again, want):
        np.testing.assert_array_equal(a.request.prompt_tokens,
                                      b.request.prompt_tokens)
        np.testing.assert_array_equal(a.request.prompt_tokens,
                                      c.request.prompt_tokens)
        assert (a.request.max_new_tokens, a.request.priority,
                a.request.client_id) == (c.request.max_new_tokens,
                                         c.request.priority,
                                         c.request.client_id)
    with pytest.raises(ValueError, match="non-decreasing"):
        trace_schedule([{"t": 1.0, "prompt_len": 4},
                        {"t": 0.5, "prompt_len": 4}], vocab=256)
    pa = poisson_schedule(256, rate_rps=100, n_requests=6, seed=42)
    pj = jax_loadgen.poisson_schedule(256, rate_rps=100, n_requests=6,
                                      seed=42)
    assert [a.t for a in pa] == [a.t for a in pj]


def test_open_loop_drives_engine_and_charges_queue(models):
    _, _, tm, tp = models
    eng = ServingEngine(tm, tp, max_batch=1, max_seq=64, device="cpu")
    sched = trace_schedule(
        [{"t": 0.0, "prompt_len": 8, "max_new": 3},
         {"t": 0.0, "prompt_len": 9, "max_new": 3},
         {"t": 0.01, "prompt_len": 10, "max_new": 3}],
        vocab=tm.cfg.vocab_size, seed=0)
    out = run_open_loop(eng, sched)
    assert len(out) == 3
    assert all("queue" in r.stage_s for r in out)
    assert max(r.stage_s["queue"] for r in out) > 0.0


def test_closed_loop_baseline_and_sampler_on_cluster(models):
    _, _, tm, tp = models
    cl = ServingCluster.build(tm, tp, n_replicas=2, policy="least_loaded",
                              device="cpu", max_batch=2, max_seq=64)
    cl.start_sampler(interval_s=0.001)
    with pytest.raises(RuntimeError, match="already running"):
        cl.start_sampler()
    done = run_closed_loop_baseline(cl, tm.cfg.vocab_size, n_clients=3,
                                    requests_per_client=2, prompt_len=12,
                                    max_new_tokens=3)
    time.sleep(0.01)
    cl.stop_sampler()
    assert len(done) == 6
    assert sum(r.routed for r in cl.replicas) == 6
    tel = cl.telemetry()
    hists = tel["obs"]["histograms"]
    assert {"replica0.queue_depth", "replica1.occupancy"} <= set(hists)
    assert hists["replica0.occupancy"]["count"] >= 1
    assert 0.5 <= tel["balance_index_routed"] <= 1.0
    assert tel["trace"]["capacity"] > 0
    cl.close()
    cl.close()  # idempotent


def test_jsq_spreads_a_queue_buildup(models):
    _, _, tm, tp = models
    cl = ServingCluster.build(tm, tp, n_replicas=2, policy="jsq",
                              device="cpu", max_batch=1, max_seq=64)
    pre = [Request(prompt_tokens=p, max_new_tokens=4)
           for p in _prompts(tm.cfg.vocab_size, [8, 8, 8], 1)]
    for r in pre:  # jsq walks the backlog: 0, 1, 0 (ties -> lowest index)
        cl.submit(r)
    assert [r.routed for r in cl.replicas] == [2, 1]
    late = Request(prompt_tokens=_prompts(tm.cfg.vocab_size, [8], 2)[0],
                   max_new_tokens=4)
    assert cl.submit(late) == 1  # the shorter queue wins
    assert len(cl.run_until_drained(max_steps=100_000)) == 4


def test_cluster_build_validates(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="at least one replica"):
        ServingCluster([])
    with pytest.raises(ValueError, match="pods_per_replica >= 1"):
        ServingCluster.build(tm, tp, device="cpu", pods_per_replica=0, **KW)
    with pytest.raises(ValueError, match="mesh has no 'pod' axis"):
        ServingCluster.build(tm, tp, device="cpu", mesh=DeviceMesh(
            ["cpu"], ("data",)), **KW)
    with pytest.raises(ValueError, match="devices_per_replica"):
        ServingCluster.build(tm, tp, device="cpu", backend="process",
                             mesh=DeviceMesh(["cpu"], ("pod",)), **KW)
    with pytest.raises(ValueError, match="engine must be"):
        ServingCluster.build(tm, tp, engine="split", device="cpu", **KW)
    with pytest.raises(ValueError, match="backend must be"):
        ServingCluster.build(tm, tp, backend="thread", device="cpu", **KW)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingCluster.build(tm, tp, **KW)  # the card by default


def test_launcher_first_hop_puts_a_gateway_in_front(models):
    """``--first-hop tcp`` on the launcher charges the modelled TCP hop
    (and its CPU) on every record, beside the engine's own GDR wire."""
    from repro_torch.core.transport import PAPER_A2
    from repro_torch.launch import serve

    argv = ["--arch", "llama3-8b", "--reduced", "--device", "cpu",
            "--clients", "2", "--requests", "1", "--prompt-len", "8",
            "--new-tokens", "3"]
    plain = serve.main(argv)["engine"].store.records
    proxied = serve.main(argv + ["--first-hop", "tcp"])["engine"]
    for rec, base in zip(proxied.store.records, plain):
        hop = PAPER_A2.wire_time(Transport.TCP, rec.bytes_in) + 40e-6
        assert rec.stage_s["request"] == pytest.approx(
            base.stage_s["request"] + hop, rel=1e-12)
        assert rec.cpu_s > 0 and base.cpu_s == 0
    with pytest.raises(SystemExit):
        serve.main(argv + ["--first-hop", "gdr"])
