"""Port DisaggregatedEngine vs the JAX DisaggregatedEngine on the CPU.

The same requests through both tiers on the same weights (reduced
llama3-8b and mamba2-130m in fp32, JAX's weights carried across with
``params_from_numpy``), under each of the three mechanisms: the same greedy
tokens and the same handoff counters, the modelled 'transfer' charges
equal at rel 1e-9 (both run on the CPU, where both tiers model the hop),
and TCP's CPU charge pinned to the wire bytes. The direct mechanisms give
the fused engine's tokens. On the paged path with prefix reuse the wire
bytes reconcile exactly with the admission-plan oracle and fall with the
hit rate; at BENCH_prefix.json's workload (llama3-8b-micro, DIRECT_DMA,
max_batch 4, max_seq 256, 16 prompts of 160 tokens, benchmarks/prefix.py's
schedule and priming) the port moves exactly the committed 2,097,472 /
1,048,896 / 131,392 wire bytes at hit rates 0 / 0.5 / 0.9."""

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.transfer import TransferMode as JaxMode  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serving import DisaggregatedEngine as JaxDisagg  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.transfer import MODE_TRANSPORT, TransferMode  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DisaggregatedEngine,
    Request,
    ServingEngine,
)
from repro_torch.serving.loadgen import shared_prefix_schedule  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = ("handoffs", "handoff_wire_bytes", "handoff_request_bytes",
            "handoff_payload_bytes")


def _pair(arch, seed=1):
    cfg = jax_get_config(arch).reduced()
    jm = JaxModel(cfg, dtype=jnp.float32)
    jp = jm.init(jax.random.key(seed))
    tcfg = get_config(arch).reduced()
    tm = Model(tcfg, dtype=torch.float32, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def llama():
    return _pair("llama3-8b")


def _drain(eng, req_cls, prompts, max_new):
    reqs = [req_cls(prompt_tokens=p.copy(), max_new_tokens=max_new)
            for p in prompts]
    for r in reqs:
        eng.submit(r, time.perf_counter())
    out = {r.request_id: r for r in eng.run_until_drained()}
    assert len(out) == len(reqs)
    return reqs, [out[r.request_id] for r in reqs]


def _prompts(vocab, lens, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, s, dtype=np.int32) for s in lens]


def _jax_counters(eng):
    return {k: getattr(eng, k) for k in COUNTERS}


@pytest.mark.parametrize("mode", list(TransferMode))
def test_port_tier_matches_jax_tier(llama, mode):
    jm, jp, tm, tp = llama
    prompts = _prompts(tm.cfg.vocab_size, [5, 9, 17, 26])
    kw = dict(max_batch=2, max_seq=64)
    jeng = JaxDisagg(jm, jp, transfer_mode=JaxMode(mode.value), **kw)
    jreqs, jout = _drain(jeng, JaxRequest, prompts, 5)
    teng = DisaggregatedEngine(tm, tp, transfer_mode=mode, device="cpu", **kw)
    treqs, tout = _drain(teng, Request, prompts, 5)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    got = {k: teng.counters()[k] for k in COUNTERS}
    assert got == _jax_counters(jeng)
    assert got["handoffs"] == 2 and got["handoff_wire_bytes"] > 0
    # the modelled hop on each request's share of the wire bytes
    for a, b in zip(tout, jout):
        assert a.stage_s["transfer"] == pytest.approx(
            b.stage_s["transfer"], rel=1e-9)
    recs = teng.store.records
    if mode is TransferMode.HOST_STAGED:
        assert sum(r.cpu_s for r in recs) == pytest.approx(
            teng.handoff_wire_bytes * teng.profile.tcp_cpu_per_byte,
            rel=1e-9)
        assert all(len(r.generated) == 5 for r in treqs)
    else:
        assert all(r.cpu_s == 0.0 for r in recs)
        fused, _ = _drain(ServingEngine(tm, tp, device="cpu", **kw), Request,
                          prompts, 5)
        assert [r.generated for r in treqs] == [r.generated for r in fused]


def test_modelled_charge_swaps_the_measured_wall_out_of_ttft(llama):
    """A co-admitted pair waits the full hop wall; on the CPU the stamps
    drop all of it and fold in each request's modelled hop."""
    _, _, tm, tp = llama
    eng = DisaggregatedEngine(tm, tp, transfer_mode=TransferMode.DIRECT_DMA,
                              max_batch=2, max_seq=32, device="cpu")
    reqs, out = _drain(eng, Request, _prompts(tm.cfg.vocab_size, [8, 9]), 2)
    assert eng.handoffs == 1
    tot = sum(eng.request_handoff_bytes(len(r.prompt_tokens)) for r in reqs)
    hop = MODE_TRANSPORT[TransferMode.DIRECT_DMA]
    for req, rsp in zip(reqs, out):
        rec = next(r for r in eng.store.records
                   if r.request_id == req.request_id)
        assert rec.transfer_wall_s == pytest.approx(eng.handoff_wall_s)
        share = (eng.handoff_wire_bytes
                 * eng.request_handoff_bytes(len(req.prompt_tokens)) / tot)
        want = eng.profile.handoff_time(hop, share)
        assert rec.stage_s["transfer"] == pytest.approx(want, rel=1e-9)
        ingress = rec.stage_s["request"] + rec.stage_s.get("copy_in", 0.0)
        # t_first_token carries the swap, as t_done does (one timeline);
        # JAX's formula reads the placement clock before it
        raw = req.t_first_token - (want - eng.handoff_wall_s) - req.t_arrival
        assert req.t_arrival <= req.t_first_token <= req.t_done
        assert rsp.ttft_s == pytest.approx(
            raw + ingress - eng.handoff_wall_s + want, abs=1e-9)
    assert eng.handoff_request_bytes <= eng.handoff_wire_bytes
    assert eng.handoff_wire_bytes < eng.padded_tree_wire_bytes()


def test_mamba2_exact_path_hands_off_whole_state_rows():
    """SSM stacks take the exact path: one handoff per request carrying
    its conv and state rows whole, through slots that get reused."""
    jm, jp, tm, tp = _pair("mamba2-130m")
    prompts = _prompts(tm.cfg.vocab_size, [5, 9, 14])
    kw = dict(max_batch=2, max_seq=32)
    jeng = JaxDisagg(jm, jp, transfer_mode=JaxMode.DIRECT_HBM, **kw)
    jreqs, _ = _drain(jeng, JaxRequest, prompts, 4)
    teng = DisaggregatedEngine(tm, tp, device="cpu", **kw)
    treqs, _ = _drain(teng, Request, prompts, 4)
    fused, _ = _drain(ServingEngine(tm, tp, device="cpu", **kw), Request,
                      prompts, 4)
    assert teng.exact_prefill
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.generated for r in treqs] == [r.generated for r in fused]
    c = teng.counters()
    assert {k: c[k] for k in COUNTERS} == _jax_counters(jeng)
    assert c["handoffs"] == 3
    # every request moves the same bytes: its whole rows plus metadata
    assert c["handoff_wire_bytes"] == 3 * teng.request_handoff_bytes(1)


def _micro(cfg):
    """benchmarks/serving.py's llama3-8b-micro."""
    return dataclasses.replace(
        cfg.reduced(), name="llama3-8b-micro", d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=32)


def _prime(sched, plen, vocab, seed=99):
    """benchmarks/prefix.py's priming: one request per distinct prefix,
    the prefix plus one page of its own."""
    rng = np.random.default_rng(seed)
    seen, out = set(), []
    for a in sched:
        key = tuple(int(t) for t in a.request.prompt_tokens[:plen])
        if key in seen:
            continue
        seen.add(key)
        out.append(np.concatenate([a.request.prompt_tokens[:plen],
                                   rng.integers(0, vocab, 16,
                                                dtype=np.int32)]))
    return out


def test_paged_handoff_reproduces_bench_prefix_wire_bytes():
    bench = json.loads((ROOT / "BENCH_prefix.json").read_text())
    rows = bench["prefix"]["hit_rate_sweep"]
    cfg = _micro(get_config("llama3-8b"))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    wire = {}
    for key, row in rows.items():
        plen = row["prefix_len"]
        sched = shared_prefix_schedule(
            cfg.vocab_size, rate_rps=1000.0, n_requests=16, n_prefixes=2,
            prefix_len=plen, suffix_len=160 - plen, zipf_a=1.1, max_new=4,
            seed=7)
        eng = DisaggregatedEngine(
            model, params, transfer_mode=TransferMode.DIRECT_DMA,
            max_batch=4, max_seq=256, paged=True, device="cpu")
        if plen:
            _drain(eng, Request, _prime(sched, plen, cfg.vocab_size), 2)
        c0 = eng.counters()
        _drain(eng, Request, [a.request.prompt_tokens for a in sched], 4)
        c = eng.counters()
        assert c["handoff_wire_bytes"] == c["handoff_payload_bytes"]
        assert c["prefix_hits"] - c0["prefix_hits"] == row["prefix_hits"]
        wire[key] = c["handoff_wire_bytes"] - c0["handoff_wire_bytes"]
        assert wire[key] == row["handoff_wire_bytes"]
    assert wire == {"0.0": 2_097_472, "0.5": 1_048_896, "0.9": 131_392}


def test_paged_reuse_tier_matches_jax_and_fused(llama):
    """Shared-prefix prompts on the paged path with reuse: tokens and every
    counter equal JAX's paged tier, tokens the fused paged engine's, and
    the wire bytes reconcile with the plan oracle exactly."""
    jm, jp, tm, tp = llama
    rng = np.random.default_rng(0)
    fams = [rng.integers(0, tm.cfg.vocab_size, 48, dtype=np.int32)
            for _ in range(2)]
    prompts = [np.concatenate([f, rng.integers(0, tm.cfg.vocab_size, n,
                                               dtype=np.int32)])
               for n in (5, 17, 30) for f in fams]
    kw = dict(max_batch=2, max_seq=128, paged=True)
    mode = TransferMode.DIRECT_DMA
    jeng = JaxDisagg(jm, jp, transfer_mode=JaxMode(mode.value), page_size=16,
                     **kw)
    jreqs, _ = _drain(jeng, JaxRequest, prompts, 4)
    teng = DisaggregatedEngine(tm, tp, transfer_mode=mode, device="cpu", **kw)
    treqs, _ = _drain(teng, Request, prompts, 4)
    fused, _ = _drain(ServingEngine(tm, tp, device="cpu", **kw), Request,
                      prompts, 4)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.generated for r in treqs] == [r.generated for r in fused]
    c = teng.counters()
    assert {k: c[k] for k in COUNTERS} == _jax_counters(jeng)
    assert c["prefix_hits"] == jeng.prefix_hits > 0
    assert c["handoff_wire_bytes"] == c["handoff_payload_bytes"]
