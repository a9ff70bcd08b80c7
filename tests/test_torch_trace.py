"""The port's tracing and metrics plane against the JAX package's
(``core/trace.py``, ``core/obs.py``, ``core/metrics.py``) on the same
inputs: span buffer semantics, the wire round trip with clock rebasing,
Chrome export, stage summary, tree and reconcile checks, the balance and
merge helpers, the registry and sampler; and the engine's spans, counters
and registry snapshot against the JAX engine's on the same traffic and
converted weights, for the bucket, packed, chunked, paged, exact-shape
(mamba2-130m) and legacy paths and the disaggregated tier (CPU, fp32)."""

import collections
import dataclasses
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import metrics as jax_metrics  # noqa: E402
from repro.core import obs as jax_obs  # noqa: E402
from repro.core import trace as jax_trace  # noqa: E402
from repro.core.profiler import RequestRecord as JaxRecord  # noqa: E402
from repro.core.transfer import TransferMode as JaxMode  # noqa: E402
from repro.core.transport import PAPER_A2  # noqa: E402
from repro.core.transport import TransportProfile  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serving import DisaggregatedEngine as JaxDisagg  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.request import Response as JaxResponse  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import metrics, obs, trace  # noqa: E402
from repro_torch.core.profiler import RequestRecord  # noqa: E402
from repro_torch.core.transfer import TransferMode  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DisaggregatedEngine,
    Request,
    Response,
    ServingEngine,
)

# stage names -> equal span sets (the stamps differ run to run)
PATHS = {
    "bucket": ("llama3-8b", {}),
    "packed": ("llama3-8b", dict(packed=True)),
    "chunked": ("llama3-8b", dict(prefill_chunk=16)),
    "paged": ("llama3-8b", dict(paged=True)),
    "exact": ("mamba2-130m", {}),
    "legacy": ("llama3-8b", dict(legacy=True)),
}
# counters both packages keep (the JAX engine's prefill_compiles counts
# jit shapes; the port's prefill_calls counts dispatches)
SHARED_COUNTERS = ("prefill_tokens_total", "prefill_tokens_uncached",
                   "prefill_padded_tokens", "prefix_hits",
                   "prefix_hit_tokens", "decode_steps", "useful_steps",
                   "requests_finished")


@pytest.fixture(autouse=True)
def _tracers_off():
    """Never leak an enabled global tracer into other tests."""
    yield
    trace.disable_tracing()
    jax_trace.disable_tracing()


# --------------------------------------------------------------------------- #
# TraceBuffer semantics
# --------------------------------------------------------------------------- #
def test_buffer_disabled_emit_is_noop():
    buf = trace.TraceBuffer(capacity=8)
    buf.emit("x", 0.0, 1.0)
    assert buf.snapshot() == []
    assert buf.stats() == jax_trace.TraceBuffer(capacity=8).stats()


def test_buffer_ring_counts_drops_never_raises():
    stats, names = [], []
    for mod in (trace, jax_trace):
        buf = mod.TraceBuffer(capacity=4)
        buf.enable(process="p")
        for i in range(10):
            buf.emit(f"s{i}", float(i), float(i) + 0.5)
        stats.append(buf.stats())
        names.append([s.name for s in buf.snapshot()])
    assert stats[0] == stats[1]
    assert stats[0]["emitted"] == 10 and stats[0]["dropped"] == 6
    assert names[0] == names[1] == ["s6", "s7", "s8", "s9"]


def test_buffer_enable_reset_and_drain():
    buf = trace.TraceBuffer(capacity=8)
    buf.enable(process="p")
    buf.emit("a", 0.0, 1.0, request_id=7, tag="t")
    got = buf.drain()
    assert [s.name for s in got] == ["a"] and buf.snapshot() == []
    assert got[0].request_id == 7 and got[0].attrs["tag"] == "t"
    assert got[0].process == "p"
    assert got[0].thread == threading.current_thread().name
    buf.emit("b", 0.0, 1.0)
    buf.enable(process="p")  # reset=True clears the ring and counters
    assert buf.snapshot() == [] and buf.stats()["emitted"] == 0


# --------------------------------------------------------------------------- #
# wire round trip + rebasing (the IPC span ferry)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("offset", [-12345.678, -1e-4, 0.0, 1e-4, 98765.4321])
def test_wire_roundtrip_rebases_onto_parent_clock(offset):
    """A worker whose perf_counter epoch differs by ``offset`` ships spans;
    after ingest the placement is rebased, every duration kept, and the
    port's result is the JAX module's, field for field."""
    got = {}
    for name, mod in (("port", trace), ("jax", jax_trace)):
        worker = mod.TraceBuffer(capacity=16, process="worker")
        worker.enable()
        t0 = 1000.0 + offset  # worker-clock stamp of a parent-clock t=1000
        worker.emit("prefill.bucket", t0, t0 + 0.25, request_id=1,
                    thread="w")
        worker.emit("decode.window", t0 + 0.25, t0 + 0.75, request_id=1,
                    thread="w")
        wire = worker.drain_wire()
        parent = mod.TraceBuffer(capacity=16, process="router")
        parent.ingest_wire(wire, offset=offset, process="replica0")
        assert not parent.enabled and len(parent.snapshot()) == 2
        got[name] = (wire, [mod.spans_to_wire([s])[0] for s in
                            sorted(parent.snapshot(), key=lambda s: s.t_start)])
    assert got["port"] == got["jax"]
    spans = trace.spans_from_wire(got["port"][0], offset=offset,
                                  process="replica0")
    assert spans[0].t_start == pytest.approx(1000.0, abs=1e-9)
    assert spans[0].wall == pytest.approx(0.25, abs=1e-12)
    assert spans[1].wall == pytest.approx(0.50, abs=1e-12)


def test_wire_interleaves_with_parent_spans_on_one_timeline():
    parent = trace.TraceBuffer(capacity=32, process="router")
    parent.enable()
    parent.emit("router.pick", 10.0, 10.1)
    for label, off, start in (("replica0", 500.0, 10.2),
                              ("replica1", -500.0, 10.4)):
        w = trace.TraceBuffer(capacity=8, process="w")
        w.enable()
        w.emit("request", start + off, start + off + 0.1)
        parent.ingest_wire(w.drain_wire(), offset=off, process=label)
    order = [s.process for s in
             sorted(parent.snapshot(), key=lambda s: s.t_start)]
    assert order == ["router", "replica0", "replica1"]


# --------------------------------------------------------------------------- #
# Trace views on fixed spans: the JAX module's results
# --------------------------------------------------------------------------- #
FIXED_SPANS = [
    # name, t0, t1, process, thread, request_id, attrs
    ("submit", 0.0, 0.0, "main", "MainThread", 1, {"charge": "modeled"}),
    ("queue", 0.0, 0.01, "main", "MainThread", 1, {}),
    ("prefill.bucket", 0.01, 0.05, "main", "MainThread", 1, {"bucket": 16}),
    ("decode.window", 0.05, 0.13, "main", "decode-window", None,
     {"tag": "engine", "steps": 8}),
    ("request", 0.0, 0.2, "main", "MainThread", 1, {"tokens": 9}),
    ("submit", 0.02, 0.02, "replica1", "MainThread", 2, {}),
    ("queue", 0.02, 0.04, "replica1", "MainThread", 2, {}),
    ("prefill.paged", 0.04, 0.09, "replica1", "MainThread", 2, {}),
    ("transfer", 0.06, 0.07, "replica1", "MainThread", None,
     {"tag": "replica1", "wire_bytes": 1024}),
    ("transfer", 0.065, 0.08, "replica1", "MainThread", None,
     {"tag": "replica1", "wire_bytes": 512}),  # overlaps: a tree problem
    ("request", 0.02, 0.1, "replica1", "MainThread", 2, {}),
    ("prefill.exact", 0.3, 0.4, "main", "MainThread", 3, {}),  # no root
]


def _traces():
    return (trace.Trace(trace.spans_from_wire(FIXED_SPANS)),
            jax_trace.Trace(jax_trace.spans_from_wire(FIXED_SPANS)))


def test_chrome_events_and_stage_summary_match_jax(tmp_path):
    port, ref = _traces()
    assert port.chrome_events() == ref.chrome_events()
    assert port.stage_summary() == ref.stage_summary()
    assert port.processes() == ref.processes()
    assert ({k: [trace.spans_to_wire([s]) for s in v]
             for k, v in port.by_request().items()}
            == {k: [jax_trace.spans_to_wire([s]) for s in v]
                for k, v in ref.by_request().items()})
    obj = port.export_chrome(tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(
        json.dumps(obj))


def test_tree_problems_and_reconcile_match_jax():
    port, ref = _traces()
    assert port.tree_problems() == ref.tree_problems()
    assert len(port.tree_problems()) == 2  # request 3's root, the overlap
    fields = [dict(request_id=1, client_id=0, t_issue=0.0, t_done=0.2,
                   stage_s={"queue": 0.01, "inference": 0.08}),
              dict(request_id=2, client_id=1, t_issue=0.02, t_done=0.1,
                   stage_s={"preprocess": 0.5}),  # uncovered charge
              dict(request_id=9, client_id=0, t_issue=0.0, t_done=1.0,
                   stage_s={"inference": 1.0})]  # no spans: skipped
    got = port.reconcile([RequestRecord(**f) for f in fields])
    assert got == ref.reconcile([JaxRecord(**f) for f in fields])
    assert any("preprocess" in p for p in got)
    assert trace.Trace([]).reconcile([RequestRecord(**fields[0])]) == \
        jax_trace.Trace([]).reconcile([JaxRecord(**fields[0])])


def test_validate_stamps_matches_jax():
    cases = [((1.0, 2.0, 3.0), {}), ((1.0, 0.0, 3.0), {}),
             ((0.0, 0.0, 0.0), {}), ((2.0, 1.0, 3.0), {}),
             ((1.0, 2.5, 2.0), {"where": "replica9 rebase"}),
             ((3.0, 0.0, 2.0), {}), ((1.0, 0.99, 2.0), {"tol": 0.05})]
    for args, kw in cases:
        outcome = []
        for mod in (trace, jax_trace):
            try:
                mod.validate_stamps(*args, **kw)
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], (args, outcome)


# --------------------------------------------------------------------------- #
# balance, merge and SLO helpers on fixed inputs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("xs", [[], [0, 0], [5], [3, 3, 3], [10, 0],
                                [4.5, 1.25, 7.0, 0.5]])
def test_jain_index_matches_jax(xs):
    assert metrics.jain_index(xs) == jax_metrics.jain_index(xs)


def test_merge_record_streams_matches_jax():
    def streams(cls):
        def rec(rid, t_issue, t_done):
            return cls(request_id=rid, client_id=0, t_issue=t_issue,
                       t_done=t_done, stage_s={"inference": 0.5})

        return ([rec(0, 7200.0, 7201.0), rec(2, 7204.0, 7205.0)],
                [rec(1, -3598.0, -3597.0), rec(3, -3594.0, -3593.0)])

    a, b = streams(RequestRecord)
    got = metrics.merge_record_streams([a, b], offsets=[7200.0, -3600.0])
    ja, jb = streams(JaxRecord)
    want = jax_metrics.merge_record_streams([ja, jb],
                                            offsets=[7200.0, -3600.0])
    assert [(r.request_id, r.t_issue, r.t_done) for r in got] == \
        [(r.request_id, r.t_issue, r.t_done) for r in want]
    assert [r.request_id for r in got] == [0, 1, 2, 3]
    assert a[0].t_issue == 7200.0  # sources never mutated
    assert metrics.merge_record_streams([a, b]) == sorted(
        a + b, key=lambda r: r.t_done)
    with pytest.raises(ValueError, match="offsets length"):
        metrics.merge_record_streams([a, b], offsets=[0.0])


def test_slo_summary_matches_jax():
    def responses(cls):
        return [cls(request_id=0, tokens=[1, 2, 3], ttft_s=0.2, total_s=1.0,
                    stage_s={"queue": 0.1, "inference": 0.5}),
                cls(request_id=1, tokens=[1, 2, 3, 4], ttft_s=0.3,
                    total_s=1.7, stage_s={"queue": 0.3, "inference": 0.7}),
                cls(request_id=2, tokens=[1], ttft_s=0.1, total_s=0.5,
                    stage_s={"transfer": 0.05})]

    for warmup in (0, 1):
        assert metrics.slo_summary(responses(Response), warmup=warmup) == \
            jax_metrics.slo_summary(responses(JaxResponse), warmup=warmup)


# --------------------------------------------------------------------------- #
# registry and sampler
# --------------------------------------------------------------------------- #
def test_counter_gauge_histogram_match_jax():
    snaps = []
    for mod in (obs, jax_obs):
        c = mod.Counter("n")
        c.inc()
        c.inc(4)
        with pytest.raises(ValueError, match="cannot decrease"):
            c.inc(-1)
        g = mod.Gauge("depth")
        g.set(3.5)
        h = mod.Histogram("lat", window=4)
        for v in (1.0, 2.0, 3.0, 4.0, 5.0):
            h.observe(v)
        snaps.append((c.value, g.value, h.snapshot()))
    assert snaps[0] == snaps[1]
    assert snaps[0][2]["p50"] == pytest.approx(3.5)  # the last 4 kept


def test_registry_ingest_snapshot_delta_match_jax():
    out = []
    for mod in (obs, jax_obs):
        reg = mod.Registry()
        assert reg.counter("a") is reg.counter("a")
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("a")
        reg.ingest_counters({"steps": 10, "tokens": 40}, prefix="engine.")
        reg.ingest_counters({"steps": 15, "tokens": 40}, prefix="engine.")
        reg.gauge("depth").set(2)
        reg.histogram("lat").observe(0.25)
        prev = reg.snapshot()
        reg.ingest_counters({"steps": 21}, prefix="engine.")
        reg.ingest_counters({"steps": 0}, prefix="engine.")  # never rewinds
        cur = reg.snapshot()
        out.append((prev, cur, mod.Registry.delta(prev, cur)))
    assert out[0] == out[1]
    assert out[0][2]["engine.steps"] == 6


def test_sampler_observes_and_surfaces_source_failures():
    reg = obs.Registry()
    with obs.Sampler(reg, {"depth": lambda: 7.0}, interval_s=0.001):
        time.sleep(0.05)
    snap = reg.snapshot()["histograms"]["depth"]
    assert snap["count"] >= 1 and snap["p50"] == 7.0

    def boom():
        raise RuntimeError("dead source")

    s = obs.Sampler(reg, {"bad": boom, "ok": lambda: 1.0},
                    interval_s=0.001).start()
    time.sleep(0.02)
    with pytest.raises(RuntimeError, match="dead source"):
        s.stop()
    assert reg.snapshot()["histograms"]["ok"]["count"] >= 1
    with pytest.raises(RuntimeError, match="already started"):
        obs.Sampler(reg, {}).start().start()


# --------------------------------------------------------------------------- #
# the engines' spans, counters and snapshots against the JAX engines'
# --------------------------------------------------------------------------- #
_PAIRS: dict = {}


def _pair(arch):
    """(jax model, jax params, port model, port params): ``arch`` cut to
    the JAX micro widths (llama3-8b) or reduced (mamba2-130m), fp32, one
    weight set."""
    if arch not in _PAIRS:
        def cut(cfg):
            if arch != "llama3-8b":
                return cfg.reduced()
            return dataclasses.replace(
                cfg.reduced(), name="llama3-8b-micro", d_model=64, n_heads=2,
                n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=32)

        jm = JaxModel(cut(jax_get_config(arch)), dtype=jnp.float32)
        jp = jm.init(jax.random.key(1))
        cfg = cut(get_config(arch))
        tm = Model(cfg, dtype=torch.float32, device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
        _PAIRS[arch] = (jm, jp, tm, tp)
    return _PAIRS[arch]


LENS = [5, 17, 33, 12, 40]


class _LongHop(TransportProfile):
    """PAPER_A2 with a second added to every modelled handoff. The JAX tier
    stamps a request's prefill span on the measured timeline and its
    t_done on the modelled one, so a hop wall above the model (a loaded
    CPU) leaves the span of a request finishing at placement outside its
    root: a modelled hop longer than any CPU wall keeps the JAX side's
    tree and reconcile checks deterministic."""

    def handoff_time(self, transport, nbytes):
        return 1.0 + super().handoff_time(transport, nbytes)


LONG_HOP = _LongHop(**{f.name: getattr(PAPER_A2, f.name)
                       for f in dataclasses.fields(PAPER_A2)})


def _traced(side, arch, knobs, disagg=None):
    """Drain LENS (seeded prompts, 5 new tokens, one of them at 1) through
    the JAX or the port engine with tracing on: (multiset of (span name,
    submission index), engine, requests)."""
    jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tm.cfg.vocab_size, s, dtype=np.int32)
               for s in LENS]
    kw = dict(max_batch=2, max_seq=96, **knobs)
    mod = jax_trace if side == "jax" else trace
    mod.enable_tracing(process="main")
    if side == "jax":
        eng = (JaxEngine(jm, jp, **kw) if disagg is None else
               JaxDisagg(jm, jp, transfer_mode=JaxMode(disagg),
                         profile=LONG_HOP, **kw))
        req_cls = JaxRequest
    else:
        eng = (ServingEngine(tm, tp, device="cpu", debug_stamps=True, **kw)
               if disagg is None else
               DisaggregatedEngine(tm, tp, device="cpu", debug_stamps=True,
                                   transfer_mode=TransferMode(disagg), **kw))
        req_cls = Request
    reqs = [req_cls(prompt_tokens=p.copy(), max_new_tokens=1 if i == 1 else 5)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r, time.perf_counter())
    assert len(eng.run_until_drained(max_steps=100_000)) == len(reqs)
    tr = mod.Trace.from_buffer()
    mod.disable_tracing()
    index = {r.request_id: i for i, r in enumerate(reqs)}
    spans = collections.Counter(
        (s.name, None if s.request_id is None else index[s.request_id])
        for s in tr.spans)
    assert tr.tree_problems() == []
    assert tr.reconcile(eng.store.records) == []
    return spans, eng, reqs


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_spans_counters_and_snapshot_match_jax(path):
    arch, knobs = PATHS[path]
    got, teng, treqs = _traced("port", arch, knobs)
    want, jeng, _ = _traced("jax", arch, knobs)
    assert got == want
    names = {n for n, _ in got}
    assert "decode.window" in names and "request" in names
    for i in range(len(LENS)):
        assert got[("request", i)] == got[("submit", i)] == 1
        assert sum(c for (n, j), c in got.items()
                   if j == i and n.startswith("prefill.")) >= 1
    tc, jc = teng.counters(), jeng.counters()
    assert {k: tc[k] for k in SHARED_COUNTERS} == \
        {k: jc[k] for k in SHARED_COUNTERS}
    ts, js = teng.metrics_snapshot(), jeng.metrics_snapshot()
    assert ts["gauges"] == js["gauges"]
    assert {k: ts["counters"]["engine." + k] for k in SHARED_COUNTERS} == \
        {k: js["counters"]["engine." + k] for k in SHARED_COUNTERS}
    assert ts["counters"]["engine.prefill_calls"] == tc["prefill_calls"]


MODES = ["direct_hbm", "direct_dma", "host_staged"]


@pytest.mark.parametrize("mode", MODES)
def test_disaggregated_spans_match_jax(mode):
    got, teng, _ = _traced("port", "llama3-8b", {}, disagg=mode)
    want, _, _ = _traced("jax", "llama3-8b", {}, disagg=mode)
    assert got == want
    assert got[("transfer", None)] == teng.handoffs > 0
    assert teng.trace_tag == "engine"
    assert teng.metrics_snapshot()["counters"]["engine.handoffs"] == \
        teng.handoffs


@pytest.mark.parametrize("mode", MODES)
def test_disaggregated_stamps_ordered_when_hop_wall_exceeds_model(
        mode, monkeypatch):
    """A hop whose measured wall is far above the modelled one (a CPU run
    swaps the one for the other): every request keeps t_arrival <=
    t_first_token <= t_done, the one finishing at placement too, its
    root span holds its prefill span, and its ttft_s / total_s are JAX's
    formula on the placement clock, read by a witness of its own: the
    clock after the hop returns and at the request's placement bracket
    it."""
    from repro_torch.serving import disagg

    move = disagg.xfer.move

    def slow_move(*a, **k):
        time.sleep(0.02)
        return move(*a, **k)

    monkeypatch.setattr(disagg.xfer, "move", slow_move)
    _, _, tm, tp = _pair("llama3-8b")
    rng = np.random.default_rng(5)
    eng = DisaggregatedEngine(tm, tp, device="cpu", debug_stamps=True,
                              transfer_mode=TransferMode(mode), max_batch=2,
                              max_seq=96)
    after_hop, at_place = {}, {}
    hop, place = eng._handoff, eng._place

    def spy_hop(art):
        out = hop(art)
        t = time.perf_counter()
        for r in art.reqs:
            after_hop.setdefault(r.request_id, t)
        return out

    def spy_place(req, slot):
        at_place.setdefault(req.request_id, time.perf_counter())
        return place(req, slot)

    eng._handoff, eng._place = spy_hop, spy_place
    reqs = [Request(prompt_tokens=rng.integers(0, tm.cfg.vocab_size, s,
                                               dtype=np.int32),
                    max_new_tokens=1 if i == 1 else 4)
            for i, s in enumerate((7, 20, 33))]
    trace.enable_tracing(process="main")
    for r in reqs:
        eng.submit(r, time.perf_counter())
    rsps = {r.request_id: r for r in eng.run_until_drained(max_steps=10_000)}
    tr = trace.Trace.from_buffer()
    trace.disable_tracing()
    recs = {r.request_id: r for r in eng.store.records}
    assert len(rsps) == len(reqs)
    assert tr.reconcile(eng.store.records) == []  # tree_problems included
    for req in reqs:
        assert req.t_arrival <= req.t_first_token <= req.t_done
        rec, rsp = recs[req.request_id], rsps[req.request_id]
        adj = rec.stage_s["transfer"] - rec.transfer_wall_s
        assert adj < 0  # the wall exceeds the model: the stamp moved back
        ingress = rec.stage_s.get("request", 0.0) + rec.stage_s.get(
            "copy_in", 0.0)
        lo, hi = after_hop[req.request_id], at_place[req.request_id]
        assert lo <= req.t_first_token - adj <= hi
        # JAX's formula: ttft_s = placed - t_arrival + ingress + adj
        assert lo - req.t_arrival + ingress + adj - 1e-9 <= rsp.ttft_s
        assert rsp.ttft_s <= hi - req.t_arrival + ingress + adj + 1e-9
        assert rsp.total_s == rec.t_done - rec.t_issue


def test_tracing_off_emits_nothing_and_keeps_tokens():
    trace.disable_tracing()
    trace.tracer().clear()
    jm, jp, tm, tp = _pair("llama3-8b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tm.cfg.vocab_size, s, dtype=np.int32)
               for s in LENS]
    toks = []
    for on in (False, True):
        if on:
            trace.enable_tracing()
        eng = ServingEngine(tm, tp, max_batch=2, max_seq=96, device="cpu")
        reqs = [Request(prompt_tokens=p.copy(), max_new_tokens=5)
                for p in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        toks.append([r.generated for r in reqs])
        if not on:
            assert trace.tracer().stats()["emitted"] == 0
    assert toks[0] == toks[1]
