"""The port's copy of the paper's simulator against the JAX package's.

``repro_torch.core.{engines,workloads,simulator}`` are plain Python copies
of ``repro.core``'s; both draw the service-time jitter from
``random.Random(cfg.seed)``, so on every scenario of tests/test_simulator.py
(the paper's findings F1-F7) the port's records equal JAX's record for
record, float for float, and ``local_reference`` agrees. The port's twins
of the F1-F7 assertions follow, then ``llm_workload`` on a dry-run JSON
the test writes. Every number here is the paper's A2 + TensorRT testbed
model (``PAPER_A2``, ``TABLE_II``), not a reading of any card.
"""

import dataclasses
import json

import pytest

from repro.core import ScenarioConfig as JaxScenario
from repro.core import TABLE_II as JAX_TABLE_II
from repro.core import Transport as JaxTransport
from repro.core import llm_workload as jax_llm_workload
from repro.core import local_reference as jax_local_reference
from repro.core import run_scenario as jax_run_scenario
from repro_torch.core.simulator import (
    ScenarioConfig,
    local_reference,
    run_scenario,
)
from repro_torch.core.transport import Transport
from repro_torch.core.workloads import TABLE_II, llm_workload

GDR, RDMA, TCP = Transport.GDR, Transport.RDMA, Transport.TCP
# every ScenarioConfig tests/test_simulator.py runs: (workload, kwargs)
SCENARIOS = {
    **{f"f1_resnet50_{t.value}": ("resnet50", dict(transport=t))
       for t in (GDR, RDMA, TCP)},
    "f1_resnet50_gdr_pre": ("resnet50", dict(transport=GDR,
                                             preprocessed=True)),
    **{f"f1_deeplabv3_{t.value}": ("deeplabv3", dict(transport=t))
       for t in (GDR, RDMA, TCP)},
    **{f"f2_{w}": (w, dict(transport=GDR))
       for w in ("mobilenetv3", "wideresnet101")},
    **{f"f3_{a.value}_{b.value}": ("mobilenetv3", dict(transport=b,
                                                       first_hop=a))
       for a, b in ((TCP, TCP), (TCP, GDR), (TCP, RDMA))},
    **{f"f3_16c_{a.value}_{b.value}": (
        "mobilenetv3", dict(transport=b, first_hop=a, n_clients=16,
                            requests_per_client=20))
       for a, b in ((TCP, GDR), (RDMA, GDR), (TCP, TCP))},
    **{f"f4_{t.value}": ("deeplabv3", dict(transport=t, n_clients=16,
                                           requests_per_client=24))
       for t in (GDR, RDMA, TCP)},
    **{f"f5_streams{m}": ("resnet50", dict(transport=GDR, n_clients=16,
                                           requests_per_client=24,
                                           max_streams=m))
       for m in (1, 0)},
    **{f"f6_{t.value}": ("yolov4", dict(transport=t, n_clients=16,
                                        n_priority_clients=1,
                                        requests_per_client=20,
                                        preprocessed=True))
       for t in (GDR, RDMA)},
    **{f"f7_{t.value}_{s}": ("efficientnetb0", dict(
        transport=t, sharing=s, n_clients=8, requests_per_client=24))
       for t in (GDR, RDMA) for s in ("multi-stream", "multi-context", "mps")},
}


def _jax_kw(kw):
    out = dict(kw)
    for k in ("transport", "first_hop"):
        if k in out:
            out[k] = JaxTransport(out[k].value)
    return out


def run(w, t, **kw):
    return run_scenario(ScenarioConfig(workload=TABLE_II[w], transport=t,
                                       **kw))


def mean_ms(store, **kw):
    return store.summary(**kw)["mean"] * 1e3


def test_workloads_and_transports_are_jax_copies():
    assert {k: dataclasses.asdict(w) for k, w in TABLE_II.items()} == {
        k: dataclasses.asdict(w) for k, w in JAX_TABLE_II.items()}
    assert [t.value for t in Transport] == [t.value for t in JaxTransport]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_records_equal_jax_record_for_record(name):
    w, kw = SCENARIOS[name]
    got = run_scenario(ScenarioConfig(workload=TABLE_II[w], **kw))
    want = jax_run_scenario(JaxScenario(workload=JAX_TABLE_II[w],
                                        **_jax_kw(kw)))
    assert len(got.records) == len(want.records) > 0
    for a, b in zip(got.records, want.records):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert got.summary() == want.summary()
    assert got.cpu_per_request() == want.cpu_per_request()
    pre = kw.get("preprocessed", False)
    assert local_reference(ScenarioConfig(
        workload=TABLE_II[w], preprocessed=pre)) == jax_local_reference(
        JaxScenario(workload=JAX_TABLE_II[w], preprocessed=pre))


# --------------------------------------------------------------------------- #
# the twins of tests/test_simulator.py's findings
# --------------------------------------------------------------------------- #
def test_f1_single_client_ordering_and_magnitude():
    res = {t: mean_ms(run("resnet50", t)) for t in (GDR, RDMA, TCP)}
    assert res[GDR] < res[RDMA] < res[TCP]
    save = (res[TCP] - res[GDR]) / res[TCP]
    assert 0.15 <= save <= 0.50, f"GDR saves {save:.0%}"


def test_f1_gdr_near_local():
    for pre in (False, True):
        s = run("resnet50", GDR, preprocessed=pre)
        loc = local_reference(ScenarioConfig(workload=TABLE_II["resnet50"],
                                             preprocessed=pre))
        assert 0.1 < mean_ms(s) - loc * 1e3 < 0.8


def test_f1_deeplab_tcp_penalty():
    res = {t: mean_ms(run("deeplabv3", t)) for t in (GDR, RDMA, TCP)}
    assert 55 < res[TCP] - res[GDR] < 95
    assert 50 < res[TCP] - res[RDMA] < 90


def test_f2_overhead_ordering():
    over = {}
    for w in ("mobilenetv3", "resnet50", "wideresnet101"):
        loc = local_reference(ScenarioConfig(workload=TABLE_II[w])) * 1e3
        over[w] = (mean_ms(run(w, GDR)) - loc) / loc
    assert over["mobilenetv3"] > over["resnet50"] > over["wideresnet101"]
    assert over["wideresnet101"] < 0.06


def test_f3_proxied_last_hop():
    def proxied(first, second, **kw):
        return mean_ms(run("mobilenetv3", second, first_hop=first, **kw))

    tcp_tcp, tcp_gdr, tcp_rdma = (proxied(TCP, t) for t in (TCP, GDR, RDMA))
    assert tcp_gdr < tcp_rdma < tcp_tcp
    assert (tcp_tcp - tcp_gdr) / tcp_tcp > 0.15
    kw = dict(n_clients=16, requests_per_client=20)
    tg, rg, tt = (proxied(TCP, GDR, **kw), proxied(RDMA, GDR, **kw),
                  proxied(TCP, TCP, **kw))
    assert tg < tt
    assert abs(tg - rg) / rg < 0.45
    assert (tt - tg) / tt > 0.20


def test_f4_rdma_converges_to_tcp():
    kw = dict(n_clients=16, requests_per_client=24)
    gdr, rdma, tcp = (mean_ms(run("deeplabv3", t, **kw))
                      for t in (GDR, RDMA, TCP))
    assert gdr < rdma
    assert rdma / tcp > 0.85
    assert tcp - gdr > 25


def test_f5_stream_limit_tradeoff():
    kw = dict(n_clients=16, requests_per_client=24)
    one = run("resnet50", GDR, max_streams=1, **kw)
    sixteen = run("resnet50", GDR, max_streams=0, **kw)
    assert one.summary()["mean"] > sixteen.summary()["mean"]
    assert one.processing_cov() <= sixteen.processing_cov() + 1e-6


def test_f6_priority_protection():
    kw = dict(n_clients=16, n_priority_clients=1, requests_per_client=20,
              preprocessed=True)

    def ratio(store):
        return (store.summary(priority=1)["mean"]
                / store.summary(priority=0)["mean"])

    gdr, rdma = run("yolov4", GDR, **kw), run("yolov4", RDMA, **kw)
    assert ratio(gdr) < 0.75
    assert ratio(rdma) > ratio(gdr)


def test_f7_sharing_modes():
    kw = dict(n_clients=8, requests_per_client=24)
    modes = ("multi-stream", "multi-context", "mps")
    gdr = {s: mean_ms(run("efficientnetb0", GDR, sharing=s, **kw))
           for s in modes}
    rdma = {s: mean_ms(run("efficientnetb0", RDMA, sharing=s, **kw))
            for s in modes}
    assert gdr["multi-context"] > gdr["mps"]
    assert rdma["multi-context"] > rdma["mps"]
    assert rdma["mps"] <= rdma["multi-stream"] + 1e-6
    assert abs(gdr["mps"] - gdr["multi-stream"]) / gdr["multi-stream"] < 0.10


def test_profiler_stage_accounting():
    rec = run("resnet50", RDMA).records[10]
    accounted = sum(rec.stage_s.values())
    assert accounted <= rec.total + 1e-9
    assert accounted / rec.total > 0.9


def test_cpu_usage_tcp_highest():
    cpu = {t: run("deeplabv3", t).cpu_per_request() for t in (GDR, RDMA, TCP)}
    assert cpu[TCP] > 2 * cpu[GDR]


# --------------------------------------------------------------------------- #
# llm_workload from a dry-run record
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,shape", [("grok-1-314b", "decode_32k"),
                                        ("pixtral-12b", "prefill_32k")])
def test_llm_workload_matches_jax_on_a_written_dryrun(tmp_path, arch, shape):
    rec = {"t_compute": 0.0123, "t_memory": 0.0456, "t_collective": 0.0011,
           "hlo_flops": 3.5e15, "chips": 256}
    (tmp_path / f"{arch}__{shape}__16x16.json").write_text(json.dumps(rec))
    w = llm_workload(arch, shape, results_dir=str(tmp_path))
    jw = jax_llm_workload(arch, shape, results_dir=str(tmp_path))
    assert dataclasses.asdict(w) == dataclasses.asdict(jw)
    assert w.t_inf_s == 0.0456 + 0.0011
    s = run_scenario(ScenarioConfig(workload=w, transport=GDR,
                                    requests_per_client=5))
    js = jax_run_scenario(JaxScenario(workload=jw,
                                      transport=JaxTransport.GDR,
                                      requests_per_client=5))
    assert [dataclasses.asdict(r) for r in s.records] == [
        dataclasses.asdict(r) for r in js.records]
    with pytest.raises(FileNotFoundError):
        llm_workload(arch, "train_4k", results_dir=str(tmp_path))
