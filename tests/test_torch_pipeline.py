"""The port's threaded host pipeline (``EnginePipeline``) against the
synchronous ``step()`` loop and the JAX package's ``EnginePipeline`` on
the same converted weights and requests (CPU, fp32): token identity,
submitted == emitted conservation, complete records, a thread failure
surfacing on the caller's next call, the refusal of ``legacy=True`` and a
bad backlog, the ``_finished_ids`` prune seeing the backlog, and a stress
run with a shortened switch interval."""

import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serving.engine import EnginePipeline as JaxPipeline  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import EnginePipeline, Request, ServingEngine  # noqa: E402

LENS = [8, 12, 20, 5, 16, 9, 30, 7]
KW = dict(max_batch=3, max_seq=64)


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


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, s, dtype=np.int32) for s in lens]


def _serve(front, req_cls, prompts, max_new, budgets=None):
    reqs = [req_cls(prompt_tokens=p.copy(),
                    max_new_tokens=budgets[i] if budgets else max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        front.submit(r)
    out = front.run_until_drained(max_steps=200_000)
    assert len(out) == len(reqs)
    assert sorted(r.request_id for r in out) == sorted(r.request_id
                                                       for r in reqs)
    return reqs, out


def test_pipeline_tokens_match_step_loop_and_jax_pipeline(models):
    """The three-thread pipeline gives the synchronous engine's tokens and
    the JAX pipeline's on the same weights, and emits one response per
    submission."""
    jm, jp, tm, tp = models
    prompts = _prompts(tm.cfg.vocab_size, LENS)
    base, _ = _serve(ServingEngine(tm, tp, device="cpu", **KW), Request,
                     prompts, 6)
    with EnginePipeline(ServingEngine(tm, tp, device="cpu", **KW)) as pipe:
        assert pipe.async_draining
        reqs, out = _serve(pipe, Request, prompts, 6)
        assert pipe.submitted == pipe.emitted == len(reqs)
        assert pipe.idle
        snap = pipe.load_snapshot()
        assert snap["idle"] and snap["submitted"] == snap["emitted"]
        assert snap["submitted_bytes"] == sum(r.payload_bytes for r in reqs)
        assert snap["steps"] == pipe.engine.decode_steps
        assert pipe.metrics_snapshot()["counters"]["engine.decode_steps"] \
            == pipe.engine.decode_steps
    with JaxPipeline(JaxEngine(jm, jp, **KW)) as jpipe:
        jreqs, _ = _serve(jpipe, JaxRequest, prompts, 6)
    assert [r.generated for r in reqs] == [r.generated for r in base]
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]


def test_pipeline_records_complete(models):
    """Every finished request's record has its t_done and its queue,
    prefill and decode stages: finalize ran once per request."""
    _, _, tm, tp = models
    with EnginePipeline(ServingEngine(tm, tp, device="cpu", **KW)) as pipe:
        _serve(pipe, Request, _prompts(tm.cfg.vocab_size, [8, 16, 24], 1), 5)
        assert len(pipe.store.records) == 3
        for rec in pipe.store.records:
            assert rec.t_done > rec.t_issue
            assert {"queue", "preprocess", "inference"} <= set(rec.stage_s)
            assert rec.stage_s["inference"] >= 0.0


def test_pipeline_thread_failure_surfaces(models):
    """A crash on a pipeline thread re-raises, with its traceback, on the
    caller's next touch instead of hanging the facade."""
    _, _, tm, tp = models
    eng = ServingEngine(tm, tp, device="cpu", **KW)

    def boom():
        raise RuntimeError("synthetic admission failure")

    pipe = EnginePipeline(eng)
    try:
        eng._admit = boom
        with pytest.raises(RuntimeError, match="synthetic admission"):
            for _ in range(200):
                pipe.idle  # noqa: B018 -- poking the facade re-raises
                time.sleep(0.01)
            raise AssertionError("pipeline failure never surfaced")
        with pytest.raises(RuntimeError, match="pipeline thread failed"):
            pipe.submit(Request(prompt_tokens=np.zeros(4, np.int32)))
        with pytest.raises(RuntimeError, match="pipeline thread failed"):
            pipe.step()
    finally:
        pipe.close()
    assert not any(t.is_alive() for t in pipe._threads)


def test_pipeline_rejects_legacy_and_bad_backlog(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="legacy"):
        EnginePipeline(ServingEngine(tm, tp, device="cpu", legacy=True, **KW))
    eng = ServingEngine(tm, tp, device="cpu", **KW)
    with pytest.raises(ValueError, match="backlog"):
        EnginePipeline(eng, backlog=0)
    pipe = EnginePipeline(eng)
    pipe.close()
    pipe.close()  # idempotent
    assert not any(t.is_alive() for t in pipe._threads)


def test_dispatch_counts_the_backlog_and_the_prune_keeps_its_ids(models):
    """With the window empty and a popped step parked in the backlog,
    ``_dispatch(outstanding=1)`` leaves the inference clock alone, and the
    ``_finished_ids`` prune keeps the ids the parked step's snapshot
    references: finalizing it later never hands a finished request another
    token."""
    _, _, tm, tp = models
    eng = ServingEngine(tm, tp, device="cpu", max_batch=2, max_seq=64,
                        inflight=4)
    a, b = (Request(prompt_tokens=p, max_new_tokens=n) for p, n in
            zip(_prompts(tm.cfg.vocab_size, [6, 9], 5), (2, 3)))
    for r in (a, b):
        eng.submit(r)
    eng._admit()
    eng._dispatch()
    assert len(eng.pool.window) == 2  # the budgets cap the window
    s1, s2 = eng.pool.pop_oldest(), eng.pool.pop_oldest()
    eng._backlog_entries.append(s2)
    eng._finalize_harvest(s1, s1.host.wait()[0], 0.0)
    assert len(a.generated) == 2  # a finished in s1
    assert a.request_id in eng._finished_ids  # s2's snapshot still holds a
    mark = eng._t_mark
    eng._dispatch(outstanding=1)
    assert eng._t_mark == mark  # the parked step keeps the clock running
    eng._backlog_entries.popleft()
    eng._finalize_harvest(s2, s2.host.wait()[0], 0.0)
    assert len(a.generated) == 2 and len(b.generated) == 3
    eng.run_until_drained()
    assert eng.idle and [len(r.generated) for r in (a, b)] == [2, 3]


def test_pipeline_stress_conservation(models):
    """Many requests (budgets 1-9) through a backlog-1 pipeline with the
    interpreter switching threads every microsecond: every submission
    emits once, in the step loop's tokens, within a bounded wall."""
    _, _, tm, tp = models
    prompts = _prompts(tm.cfg.vocab_size, [3 + (7 * i) % 29 for i in range(16)],
                       9)
    budgets = [1 + (5 * i) % 9 for i in range(16)]
    base, _ = _serve(ServingEngine(tm, tp, device="cpu", **KW), Request,
                     prompts, 0, budgets)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t0 = time.perf_counter()
    try:
        with EnginePipeline(ServingEngine(tm, tp, device="cpu", **KW),
                            backlog=1) as pipe:
            reqs, out = _serve(pipe, Request, prompts, 0, budgets)
            assert pipe.submitted == pipe.emitted == len(prompts)
            assert pipe.engine._backlog_entries == type(
                pipe.engine._backlog_entries)()
    finally:
        sys.setswitchinterval(old)
    assert time.perf_counter() - t0 < 60.0
    assert [r.generated for r in reqs] == [r.generated for r in base]
    assert [len(r.generated) for r in reqs] == budgets
