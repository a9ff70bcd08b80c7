"""The port's legacy synchronous loop, its construction-time warm-up and the
decode pool's fixed state addresses (what its CUDA graph relies on), held
against the JAX package on the same converted weights (fp32, greedy, CPU).

- Drain equivalence (tests/test_serving_fastpath.py's law): the port's
  legacy tokens == the JAX legacy tokens == the port's fast-path tokens, on
  reduced llama3 and reduced mamba2-130m; the legacy counters equal JAX's.
- The seed's ``max_new_tokens=1`` quirk: 2 tokens under legacy, 1 on the
  fast path, in both packages.
- ``warmup=True`` leaves a pristine pool and changes no token or counter
  (ring, paged, packed), as the JAX warmed engine does.
- Every pool state tensor keeps its address across splice, step, release,
  page-table push and ``reset_state``.

Two frameworks' fp32 sums differ in order, so a JAX-vs-port token stream
may part only where JAX's top-2 logit gap is under GAP_TOL (a tie)."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.transfer import TransferMode  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.schema import tree_map  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DisaggregatedEngine,
    Request,
    ServingEngine,
)

GAP_TOL = 1e-4  # a JAX top-2 logit gap below this is a tie, not a fault
# tests/test_serving_fastpath.py's drain-equivalence setups: (prompt
# lengths, new tokens, prompt seed, max_seq)
SETUPS = {"llama3-8b": ([5, 8, 13, 21, 16, 30], 6, 7, 64),
          "mamba2-130m": ([5, 9, 14], 4, 2, 32)}
_PAIRS: dict = {}
_RUNS: dict = {}


def _pair(name):
    """(jax model, jax params, port model, port params): the reduced
    configuration in fp32 on one weight set (JAX seed 1), once a module."""
    if name not in _PAIRS:
        jm = JaxModel(jax_get_config(name).reduced(), dtype=jnp.float32)
        jp = jm.init(jax.random.key(1))
        cfg = get_config(name).reduced()
        tm = Model(cfg, dtype=torch.float32, device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
        _PAIRS[name] = (jm, jp, tm, tp)
    return _PAIRS[name]


def _prompts(name):
    lens, _, seed, _ = SETUPS[name]
    rng = np.random.default_rng(seed)
    vocab = get_config(name).reduced().vocab_size
    return [rng.integers(0, vocab, s, dtype=np.int32) for s in lens]


def _drain(eng, req_cls, prompts, max_new):
    reqs = [req_cls(prompt_tokens=p.copy(), max_new_tokens=max_new)
            for p in prompts]
    for r in reqs:
        eng.submit(r, time.perf_counter())
    out = eng.run_until_drained()
    assert len(out) == len(reqs)
    return [list(r.generated) for r in reqs]


def _run(side, name, **kw):
    """Drain the setup's prompts through the JAX or the port engine with
    ``kw`` (max_batch 2), once a module: (tokens, engine)."""
    key = (side, name, tuple(sorted(kw.items())))
    if key not in _RUNS:
        jm, jp, tm, tp = _pair(name)
        _, max_new, _, max_seq = SETUPS[name]
        kw = dict(max_batch=2, max_seq=max_seq, **kw)
        if side == "jax":
            eng = JaxEngine(jm, jp, **kw)
            toks = _drain(eng, JaxRequest, _prompts(name), max_new)
        else:
            eng = ServingEngine(tm, tp, device="cpu", **kw)
            toks = _drain(eng, Request, _prompts(name), max_new)
        _RUNS[key] = (toks, eng)
    return _RUNS[key]


def _same_tokens(name, got, want):
    """Equal greedy streams, or parted only at a JAX top-2 tie."""
    jm, jp, _, _ = _pair(name)
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = np.concatenate([_prompts(name)[i], np.asarray(b[:k], np.int32)])
        logits, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(ctx)[None]})
        top = np.sort(np.asarray(logits[0]))[-2:]
        gap = float(top[1] - top[0])
        assert gap < GAP_TOL, (f"request {i}: token {k} differs ({a[k]} vs "
                               f"{b[k]}) at top-2 gap {gap:.2e}")


# --------------------------------------------------------------------------- #
# the legacy loop
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(SETUPS))
def test_legacy_drain_matches_jax_legacy_and_fast_path(name):
    legacy, eng = _run("torch", name, legacy=True)
    jax_legacy, _ = _run("jax", name, legacy=True)
    fast, _ = _run("torch", name, inflight=4)
    assert eng.legacy and eng.inflight == 1
    assert eng.exact_prefill == (name == "mamba2-130m")
    _same_tokens(name, legacy, jax_legacy)
    _same_tokens(name, legacy, fast)
    assert eng.logits_all_finite()


@pytest.mark.parametrize("name", list(SETUPS))
def test_legacy_counters_match_jax(name):
    _, eng = _run("torch", name, legacy=True)
    _, jeng = _run("jax", name, legacy=True)
    c, jc = eng.counters(), jeng.counters()
    for key in ("decode_steps", "useful_steps", "prefill_tokens_total",
                "prefill_padded_tokens"):
        assert c[key] == jc[key], key
    assert c["decode_steps"] == c["useful_steps"] > 0
    assert c["prefill_calls"] == 0  # the seed loop counts no prefill call
    assert c["requests_finished"] == len(SETUPS[name][0])
    stages = eng.store.stage_means()
    assert stages["queue"] > 0 and stages["preprocess"] > 0
    assert stages["inference"] > 0


@pytest.mark.parametrize("legacy", [True, False])
def test_max_new_tokens_one_quirk(legacy):
    """The seed loop always takes one decode step (2 tokens); the fast path
    finishes such a request at its prefill (1 token); in both packages."""
    jm, jp, tm, tp = _pair("llama3-8b")
    prompt = _prompts("llama3-8b")[:1]
    kw = dict(max_batch=1, max_seq=64, legacy=legacy)
    got = _drain(ServingEngine(tm, tp, device="cpu", **kw), Request, prompt, 1)
    want = _drain(JaxEngine(jm, jp, **kw), JaxRequest, prompt, 1)
    assert len(got[0]) == len(want[0]) == (2 if legacy else 1)
    _same_tokens("llama3-8b", got, want)


def test_legacy_refusals():
    jm, jp, tm, tp = _pair("llama3-8b")
    for make in (lambda **k: ServingEngine(tm, tp, device="cpu", **k),
                 lambda **k: JaxEngine(jm, jp, **k)):
        with pytest.raises(ValueError, match="fast path"):
            make(max_batch=2, max_seq=64, legacy=True, temperature=0.7)
        with pytest.raises(ValueError, match="paged"):
            make(max_batch=2, max_seq=64, legacy=True, paged=True)
    with pytest.raises(ValueError, match="fast path"):
        DisaggregatedEngine(tm, tp, max_batch=2, max_seq=64, legacy=True,
                            device="cpu")
    # the knobs the seed loop does not have are off, as in JAX
    eng = ServingEngine(tm, tp, max_batch=2, max_seq=64, legacy=True,
                        packed=True, prefill_chunk=16, inflight=4,
                        device="cpu")
    assert (eng.inflight, eng.packed, eng._chunk_enabled) == (1, False, False)


# --------------------------------------------------------------------------- #
# warm-up
# --------------------------------------------------------------------------- #
WAYS = {"ring": {}, "paged": dict(paged=True), "packed": dict(packed=True)}


def _assert_pristine(eng):
    pool = eng.pool
    B = eng.max_batch
    zero = torch.zeros((B,), dtype=torch.int32)
    for t in (pool.lengths, pool.gen, pool.maxn):
        assert torch.equal(t, zero)
    assert torch.equal(pool.tokens, zero[:, None])
    assert bool(pool.done.all()) and bool(pool.logits_finite)
    kv = pool.blocks if pool.paged else pool.caches
    assert all(not t.any() for t in _leaves(kv))
    if pool.paged:
        assert pool.allocator.live_blocks == 0
        assert not pool.page_table.any() and not pool.pt_host.any()
        assert pool.allocator.free_count == pool.allocator.num_blocks - 1
    assert not pool.window and pool.all_free
    assert torch.equal(pool.rng.get_state(), torch.Generator().manual_seed(
        2 * pool.sample_seed).get_state())
    assert all(v == 0 for v in eng.counters().values())


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("way", list(WAYS))
def test_warm_leaves_a_pristine_pool(way):
    _, _, tm, tp = _pair("llama3-8b")
    eng = ServingEngine(tm, tp, max_batch=2, max_seq=64, warmup=True,
                        device="cpu", **WAYS[way])
    assert eng.warm_s > 0
    _assert_pristine(eng)
    # and again after serving (the pool is free once drained)
    _drain(eng, Request, _prompts("llama3-8b")[:3], 4)
    if eng.prefix_reuse:
        for (p, d) in eng.prefix_index.clear():
            eng.pool.allocator.deref([p])
            eng.pool.allocator.deref([d])
    assert eng.warm() > 0
    eng.decode_steps = eng.useful_steps = 0
    for key in ("prefill_tokens_total", "prefill_tokens_uncached",
                "prefill_padded_tokens", "prefill_calls"):
        setattr(eng, key, 0)
    eng.store.records.clear()
    _assert_pristine(eng)


@pytest.mark.parametrize("way", list(WAYS))
def test_warmed_engine_matches_unwarmed_and_jax(way):
    warm, weng = _run("torch", "llama3-8b", inflight=4, warmup=True,
                      **WAYS[way])
    cold, ceng = _run("torch", "llama3-8b", inflight=4, **WAYS[way])
    jwarm, jeng = _run("jax", "llama3-8b", inflight=4, warmup=True,
                       **WAYS[way])
    assert warm == cold
    assert weng.counters() == ceng.counters()
    _same_tokens("llama3-8b", warm, jwarm)
    jc = jeng.counters()
    for key, v in weng.counters().items():
        if key in jc:
            assert v == jc[key], key


def test_warm_under_legacy_is_a_no_op():
    jm, jp, tm, tp = _pair("llama3-8b")
    eng = ServingEngine(tm, tp, max_batch=2, max_seq=64, legacy=True,
                        warmup=True, device="cpu")
    jeng = JaxEngine(jm, jp, max_batch=2, max_seq=64, legacy=True,
                     warmup=True)
    assert eng.warm_s == jeng.warm_s == 0.0
    assert eng.warm() == jeng.warm() == 0.0


@pytest.mark.parametrize("kw", [dict(prefill_chunk=16),
                                dict(sample_seed=3, temperature=0.9, top_k=8)])
def test_warm_keeps_chunked_and_sampled_streams(kw):
    """A chunked engine warms its chunk shape; a sampling engine's streams
    (prefill and decode) come out of the warm-up as they went in."""
    _, _, tm, tp = _pair("llama3-8b")
    prompts = _prompts("llama3-8b")

    def tokens(**more):
        eng = ServingEngine(tm, tp, max_batch=2, max_seq=64, device="cpu",
                            **kw, **more)
        return _drain(eng, Request, prompts, 5), eng.counters()

    assert tokens(warmup=True) == tokens()


@pytest.mark.parametrize("mode", ["direct_hbm", "direct_dma"])
def test_warmed_disaggregated_tier(mode):
    """warmup= reaches the disaggregated tier (its prefix store included)
    and changes no token, counter or handoff byte."""
    _, _, tm, tp = _pair("llama3-8b")
    prompts = _prompts("llama3-8b")

    def serve(**kw):
        eng = DisaggregatedEngine(tm, tp, max_batch=2, max_seq=64,
                                  paged=True, device="cpu",
                                  transfer_mode=TransferMode(mode), **kw)
        return _drain(eng, Request, prompts, 4), eng.counters()

    assert serve(warmup=True) == serve()


# --------------------------------------------------------------------------- #
# fixed state addresses (the captured graph's invariant) and launch counts
# --------------------------------------------------------------------------- #
def _addresses(pool):
    ts = [pool.lengths, pool.tokens, pool.gen, pool.maxn, pool.done,
          pool.logits_finite]
    if pool.paged:
        ts += [pool.page_table] + _leaves(pool.blocks)
    else:
        ts += _leaves(pool.caches)
    return [t.data_ptr() for t in ts]


@pytest.mark.parametrize("name,kw", [("llama3-8b", {}),
                                     ("llama3-8b", dict(paged=True)),
                                     ("mamba2-130m", {})])
def test_pool_state_keeps_its_addresses(name, kw):
    _, _, tm, tp = _pair(name)
    eng = ServingEngine(tm, tp, max_batch=2, max_seq=64, device="cpu", **kw)
    pool = eng.pool
    first = _addresses(pool)
    prompts = _prompts(name)
    reqs = [Request(prompt_tokens=p.copy(), max_new_tokens=3)
            for p in prompts]
    for r in reqs:
        eng.submit(r)
    seen = 0
    while not eng.idle:  # admissions (splice, set_row), steps, releases
        eng.step()
        seen += 1
        assert _addresses(pool) == first
    assert seen > 1 and all(len(r.generated) == 3 for r in reqs)
    if pool.paged:
        blocks = pool.allocator.alloc(2)
        pool.set_row(0, blocks)
        pool._sync_pt()
        assert pool.page_table[0, :2].tolist() == blocks
        pool.release_slot(0)
        pool._sync_pt()
        assert not pool.page_table.any()
        assert _addresses(pool) == first
    pool.reset_state()
    assert _addresses(pool) == first


def test_host_copy_is_its_steps_own():
    """On the CPU a step's harvest copy must not alias the state the next
    step updates in place."""
    _, _, tm, tp = _pair("llama3-8b")
    eng = ServingEngine(tm, tp, max_batch=2, max_seq=64, inflight=4,
                        device="cpu")
    for p in _prompts("llama3-8b")[:2]:
        eng.submit(Request(prompt_tokens=p.copy(), max_new_tokens=8))
    eng._admit()
    pool = eng.pool
    assert pool.fill_one(eng.params, limit=8)
    first = pool.tokens.clone()
    assert pool.fill_one(eng.params, limit=8)
    assert torch.equal(pool.window[0].host.tokens, first)
    assert not torch.equal(pool.window[0].host.tokens, pool.tokens)


def test_graph_is_off_on_the_cpu_and_launch_counts_add():
    _, _, tm, tp = _pair("llama3-8b")
    assert not ServingEngine(tm, tp, max_batch=2, max_seq=64,
                             device="cpu").pool.use_graph
    ops.reset_launches()
    ops.add_launches({"rmsnorm": 5, "decode_attention": 2}, 3)
    ops.add_launches({"rmsnorm": 5}, -1)
    assert ops.LAUNCHES["rmsnorm"] == 10
    assert ops.LAUNCHES["decode_attention"] == 6
    ops.reset_launches()
