"""The port's process-per-replica cluster on the CPU (``device="cpu"``
workers): token identity with the in-process cluster built on the same
seed, weight checksums, request and byte conservation across the RPC
boundary, rebased records and spans, the reaping of every worker on exit,
and failures that surface as errors, never hangs -- a dead worker, a
raising worker, a failing init and a worker that finds no card. Every
wait here is bounded by the ReplicaClient's own call and init timeouts."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import trace  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import ServingCluster, loadgen  # noqa: E402
from repro_torch.serving.ipc import (  # noqa: E402
    ReplicaClient,
    ReplicaError,
    weight_checksum,
)

KW = dict(max_batch=2, max_seq=64)


def micro():
    """benchmarks/serving.py's llama3-8b-micro."""
    import dataclasses

    return dataclasses.replace(
        get_config("llama3-8b").reduced(), name="llama3-8b-micro",
        d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=256,
        head_dim=32)


def _spec(**engine_kw):
    return {"cfg": micro(), "dtype": "float32", "param_seed": 0,
            "device": "cpu", "engine": "fused",
            "engine_kw": dict(KW, **engine_kw), "backlog": 2}


def _trace(cfg, seed=11, n=8):
    return loadgen.poisson_schedule(
        cfg.vocab_size, rate_rps=300.0, n_requests=n,
        prompt_lens=(8, 16, 24), max_new=4, seed=seed)


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    trace.disable_tracing()


def test_process_cluster_token_identity_and_conservation():
    """A seeded trace through backend='process' (2 worker processes, params
    rebuilt from the shared seed) gives the in-process cluster's tokens,
    with the weights' checksums equal, every submit acknowledged and
    emitted once, payload bytes conserved, and the workers' spans rebased
    onto this process's timeline."""
    cfg = micro()
    model = Model(cfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator(device="cpu").manual_seed(0))

    # round_robin: routing independent of timing, so the request ->
    # replica map is the same across backends
    cl = ServingCluster.build(model, params, n_replicas=2,
                              policy="round_robin", device="cpu", **KW)
    out_a = loadgen.run_open_loop(cl, _trace(cfg))
    toks_a = {r.request_id: r.tokens for r in out_a}

    trace.enable_tracing()
    with ServingCluster.build(model, None, n_replicas=2,
                              policy="round_robin", backend="process",
                              param_seed=0, device="cpu", **KW) as pc:
        assert pc.parallelism == "process-per-replica" and pc.async_draining
        for rep in pc.replicas:
            assert rep.init_info["checksum"] == weight_checksum(params)
            assert rep.init_info["device"] == "cpu"
        out_b = loadgen.run_open_loop(pc, _trace(cfg))
        toks_b = {r.request_id: r.tokens for r in out_b}
        assert [toks_a[i] for i in sorted(toks_a)] == \
            [toks_b[i] for i in sorted(toks_b)]
        assert [pc.replica_of(i) for i in sorted(toks_b)] == \
            [cl.replica_of(i) for i in sorted(toks_a)]

        tel = pc.telemetry()
        assert tel["parallelism"] == "process-per-replica"
        assert sum(r["submitted"] for r in tel["ipc"]) == len(out_b)
        for row in tel["ipc"]:
            assert row["submitted"] == row["emitted"]
            assert row["request_payload_bytes"] == row["submitted_bytes"]
            assert row["rpc_bytes_sent"] > 0 and row["rpc_bytes_recv"] > 0
        for rep in pc.replicas:
            t = rep.client.telemetry()
            assert t["foreign_modules"] == []  # no jax, no repro
            assert t["peak_mem_bytes"] is None  # a CPU worker
            assert t["counters"]["requests_finished"] == rep.routed

        recs = pc.store.records
        assert len(recs) == len(out_b)
        assert all(recs[i].t_done <= recs[i + 1].t_done
                   for i in range(len(recs) - 1))
        assert all(r.t_done > r.t_issue for r in recs)
        procs = [rep.client.proc for rep in pc.replicas]
    tr = trace.Trace.from_buffer()
    assert {"replica0", "replica1"} <= set(tr.processes())
    names = {s.name for s in tr.spans}
    assert {"request", "queue", "router.pick", "rpc.submit"} <= names
    assert any(n.startswith("prefill.") for n in names)
    # the workers' request spans sit inside this process's run, rebased
    t_lo = min(r.t_issue for r in recs)
    assert all(s.t_start >= t_lo - 0.05 for s in tr.spans
               if s.process.startswith("replica") and s.name == "request")
    for p in procs:  # the context manager's exit reaps every worker
        assert p.poll() is not None


def test_dead_and_raising_workers_surface_errors():
    """A worker-side exception crosses the wire as a ReplicaError with the
    child's traceback; a worker killed mid-service surfaces a ReplicaError
    naming its exit on the next RPC, never a hang; close() stays safe."""
    client = ReplicaClient(label="doomed", call_timeout_s=60.0,
                           init_timeout_s=120.0)
    try:
        info = client.init(_spec())
        assert info["exact_prefill"] is False and info["device"] == "cpu"
        with pytest.raises(ReplicaError, match="unknown op"):
            client._call("definitely_not_an_op", None)
        client.proc.kill()
        client.proc.wait(timeout=10.0)
        t0 = time.perf_counter()
        with pytest.raises(ReplicaError, match="exited|unresponsive"):
            client.load()
        assert time.perf_counter() - t0 < 30.0  # surfaced, not hung
    finally:
        client.close()
        client.close()  # idempotent
    assert client.proc.poll() is not None


def test_wedged_worker_times_out_and_is_killed():
    """An RPC that outlives its timeout kills the worker and raises: a
    wedged replica never hangs the router. Here the worker is busy
    draining a 400-token request while the call allows 50 ms."""
    from repro_torch.serving import Request

    client = ReplicaClient(label="wedged", init_timeout_s=120.0)
    try:
        client.init(_spec(max_seq=512))
        prompt = np.random.default_rng(0).integers(0, 256, 8, dtype=np.int32)
        client.submit(Request(prompt_tokens=prompt, max_new_tokens=400))
        t0 = time.perf_counter()
        with pytest.raises(ReplicaError, match="timed out"):
            client._call("drain", {"deadline_s": 60.0}, timeout_s=0.05)
        assert time.perf_counter() - t0 < 10.0
        assert client.proc.poll() is not None  # killed, not left running
    finally:
        client.close()


def test_worker_init_failure_reports_traceback():
    """A spec the worker cannot build (a bogus engine kwarg) fails init
    with the child's traceback, and the process is cleaned up."""
    client = ReplicaClient(label="misbuilt", init_timeout_s=120.0)
    try:
        with pytest.raises(ReplicaError, match="failed to initialize"):
            client.init(_spec(no_such_kwarg=True))
    finally:
        client.close()
    assert client.proc.poll() is not None


def test_worker_without_a_card_refuses_cuda():
    """A worker asked for the card (the default) on a machine without one
    raises through the init reply; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    client = ReplicaClient(label="cardless", init_timeout_s=120.0)
    try:
        spec = _spec()
        del spec["device"]
        with pytest.raises(ReplicaError, match="device='cpu'"):
            client.init(spec)
    finally:
        client.close()
    assert client.proc.poll() is not None


@pytest.mark.slow
def test_process_cluster_policy_sweep_drains():
    """A fuller run (slow tier, as tests/test_process_cluster.py's): jsq
    routing over 2 process replicas drains a longer trace with
    conservation intact."""
    cfg = micro()
    model = Model(cfg, dtype=torch.float32, device="cpu")
    with ServingCluster.build(model, None, n_replicas=2, policy="jsq",
                              backend="process", param_seed=0,
                              device="cpu", **KW) as pc:
        out = loadgen.run_open_loop(pc, _trace(cfg, seed=5, n=24))
        assert len(out) == 24
        tel = pc.telemetry()
        assert sum(r["emitted"] for r in tel["ipc"]) == 24
        assert all(r["submitted"] == r["emitted"] for r in tel["ipc"])
