"""Port paged KV pool + radix prefix reuse vs the JAX package (CPU).

The same seeded numpy inputs, and the JAX model's weights carried across by
``params_from_numpy``, go through both sides: the paged decode kernel's
plain version against JAX's interpret-mode Pallas kernel, the prior-aware
flash plain version against JAX's ``chunked_attention``, the block-pool
gather/scatter/write against JAX's, ``prefill_suffix`` logits, and the
paged engine against the JAX paged engine (greedy tokens and every prefix
and prefill counter) and against the port's own ring engine. The radix
index, the allocator and the load generator are JAX-free copies, held to
the JAX originals on the same inputs.

Tolerances: kernels fp32 atol 2e-5 (rtol 1e-2) as in tests/test_kernels.py;
model logits 1e-4 as in tests/test_torch_model.py (two frameworks' fp32
matmuls and softmaxes sum in different orders).
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import kvcache as jkvc  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import loadgen as jloadgen  # noqa: E402
from repro.serving.prefix import RadixPrefixIndex as JaxIndex  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import kvcache as kvc  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving import loadgen  # noqa: E402
from repro_torch.serving.engine import PAGE  # noqa: E402
from repro_torch.serving.prefix import RadixPrefixIndex  # noqa: E402

KTOL = 2e-5  # kernels, fp32
TOL = 1e-4  # model logits, fp32
GAP_TOL = 1e-4  # a JAX top-2 logit gap below this is a tie, not a fault


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params): reduced llama3-8b,
    fp32, one weight set."""
    jm = JaxModel(jax_get_config("llama3-8b").reduced(), dtype=jnp.float32)
    jp = jm.init(jax.random.key(1))
    cfg = get_config("llama3-8b").reduced()
    tm = Model(cfg, dtype=torch.float32, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


def _shuffled_pool(rng, dense, page):
    """Scatter dense [B, W, Hkv, hd] rows into a shuffled block pool (block
    0 = zero sentinel): returns (blocks [B*n_pages + 1, page, Hkv, hd],
    page_table [B, n_pages])."""
    B, W = dense.shape[:2]
    n_pages = W // page
    perm = rng.permutation(B * n_pages) + 1
    blocks = np.zeros((B * n_pages + 1, page) + dense.shape[2:], dense.dtype)
    pt = np.zeros((B, n_pages), np.int32)
    for b in range(B):
        for j in range(n_pages):
            blocks[perm[b * n_pages + j]] = dense[b, j * page:(j + 1) * page]
            pt[b, j] = perm[b * n_pages + j]
    return blocks, pt


# --------------------------------------------------------------------------- #
# kernels' plain versions vs JAX
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("B,W,H,Hkv,hd,lens", [
    (4, 64, 4, 2, 32, [0, 9, 33, 64]),
    (3, 128, 8, 1, 64, [1, 70, 128]),
])
def test_paged_decode_plain_matches_jax_kernel(B, W, H, Hkv, hd, lens):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    kd = rng.normal(size=(B, W, Hkv, hd)).astype(np.float32)
    vd = rng.normal(size=(B, W, Hkv, hd)).astype(np.float32)
    kb, pt = _shuffled_pool(rng, kd, PAGE)
    vb = np.zeros_like(kb)
    for b in range(B):
        for j in range(pt.shape[1]):
            vb[pt[b, j]] = vd[b, j * PAGE:(j + 1) * PAGE]
    # pages past a row's length stay unmapped (the zero sentinel)
    lens = np.asarray(lens, np.int32)
    for b in range(B):
        pt[b, -(-lens[b] // PAGE):] = 0
    t = [torch.from_numpy(a) for a in (q, kb, vb, pt, lens)]
    got = ops.paged_decode_attention(*t)
    want = jops.paged_decode_attention(*(jnp.asarray(a)
                                         for a in (q, kb, vb, pt, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KTOL,
                               rtol=1e-2)
    # the same K/V laid out densely through the ring version: equal
    ring = ops.decode_attention(t[0], torch.from_numpy(kd),
                                torch.from_numpy(vd), t[4])
    torch.testing.assert_close(got, ring, atol=1e-6, rtol=0)
    assert (got[lens == 0] == 0).all()


@pytest.mark.parametrize("window", [0, 24])
def test_flash_prior_plain_matches_jax_chunked_attention(window):
    """Suffix attention over a cached prefix, ragged prior_valid (one row
    shorter than the prior's width), GQA."""
    rng = np.random.default_rng(1)
    B, Sq, Pp, H, Hkv, hd = 2, 24, 32, 4, 2, 32
    q, k, v = (rng.normal(size=(B, Sq, n, hd)).astype(np.float32)
               for n in (H, Hkv, Hkv))
    pk, pv = (rng.normal(size=(B, Pp, Hkv, hd)).astype(np.float32)
              for _ in range(2))
    valid = np.asarray([32, 16], np.int32)
    got = ops.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True, window=window,
        prior_k=torch.from_numpy(pk), prior_v=torch.from_numpy(pv),
        prior_valid=torch.from_numpy(valid))
    want = chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, window=window,
        prior_k=jnp.asarray(pk), prior_v=jnp.asarray(pv),
        prior_valid=jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KTOL,
                               rtol=1e-2)


def test_flash_prior_of_zero_width_is_plain_prefill():
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 16, 4, 32, generator=g)
    k = torch.randn(2, 16, 2, 32, generator=g)
    none = torch.zeros(2, 0, 2, 32)
    got = ops.flash_attention(q, k, k, prior_k=none, prior_v=none,
                              prior_valid=torch.zeros(2, dtype=torch.int32))
    torch.testing.assert_close(got, ops.flash_attention(q, k, k), atol=0,
                               rtol=0)


def test_cpu_paged_calls_count_no_launch_and_bad_args_raise():
    ops.reset_launches()
    q = torch.randn(2, 1, 4, 16)
    blocks = torch.randn(5, PAGE, 2, 16)
    pt = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    lens = torch.tensor([20, 7], dtype=torch.int32)
    ops.paged_decode_attention(q, blocks, blocks, pt, lens)
    assert ops.LAUNCHES["paged_decode_attention"] == 0
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q, blocks, blocks, pt[:1], lens)
    x = torch.randn(2, 8, 4, 16)
    k = torch.randn(2, 8, 2, 16)
    with pytest.raises(ValueError, match="together"):
        ops.flash_attention(x, k, k, prior_k=k)
    with pytest.raises(ValueError, match="together"):
        ops.flash_attention(x, k, k, prior_k=k, prior_v=k,
                            prior_valid=torch.zeros(2, dtype=torch.int32),
                            segment_ids=torch.zeros(2, 8))


# --------------------------------------------------------------------------- #
# block pool: gather / scatter / write vs JAX
# --------------------------------------------------------------------------- #
def test_gather_scatter_and_paged_write_match_jax():
    rng = np.random.default_rng(3)
    N, Hkv, hd, B, n_pages = 9, 2, 8, 3, 2
    pool = rng.normal(size=(N, PAGE, Hkv, hd)).astype(np.float32)
    pool[0] = 0.0
    jtree = {"k": jnp.asarray(pool), "v": jnp.asarray(pool * 2)}
    ttree = {"k": torch.zeros(N + 1, PAGE, Hkv, hd),
             "v": torch.zeros(N + 1, PAGE, Hkv, hd)}
    ttree["k"][:N] = torch.from_numpy(pool)
    ttree["v"][:N] = torch.from_numpy(pool * 2)
    pt = np.asarray([[3, 5], [0, 0], [7, 1]], np.int32)  # row 1: freed slot

    def same(tt, jt):
        for key in ("k", "v"):
            np.testing.assert_array_equal(tt[key][:N].numpy(),
                                          np.asarray(jt[key]))
        assert not tt["k"][0].any() and not tt["v"][0].any()

    got = kvc.gather_pages(ttree, torch.from_numpy(pt))
    want = jkvc.gather_pages(jtree, jnp.asarray(pt))
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))

    # scatter: a dummy row (all sentinel) and an out-of-range page drop
    dense = rng.normal(size=(B, 2 * PAGE, Hkv, hd)).astype(np.float32)
    dest = np.asarray([[2, 4], [0, 0], [6, N + 3]], np.int32)
    kvc.scatter_pages(ttree, {"k": torch.from_numpy(dense),
                              "v": torch.from_numpy(-dense)}, dest)
    jtree = jkvc.scatter_pages(jtree, {"k": jnp.asarray(dense),
                                       "v": jnp.asarray(-dense)},
                               jnp.asarray(dest))
    same(ttree, jtree)

    # one decode token per row: the freed row's write must miss the pool
    new = rng.normal(size=(B, 1, Hkv, hd)).astype(np.float32)
    lens = np.asarray([17, 4, 31], np.int32)
    for key, sign in (("k", 1.0), ("v", -1.0)):
        kvc.paged_write(ttree[key], torch.from_numpy(sign * new),
                        torch.from_numpy(lens), torch.from_numpy(pt))
    jdense = jkvc.gather_pages(jtree, jnp.asarray(pt))
    rows = np.arange(B)
    jdense = {"k": jdense["k"].at[rows, lens].set(new[:, 0]),
              "v": jdense["v"].at[rows, lens].set(-new[:, 0])}
    jtree = jkvc.scatter_token(jtree, jdense, jnp.asarray(lens),
                               jnp.asarray(pt))
    same(ttree, jtree)


def test_paged_specs_add_the_sink_block(models):
    _, _, tm, _ = models
    specs = kvc.paged_specs(tm.cache_specs(2, 64), 9, PAGE)
    cfg = tm.cfg
    assert specs["g0"][1]["l0"]["k"] == (10, PAGE, cfg.n_kv_heads,
                                         cfg.head_dim)
    pool = kvc.init_paged(tm.cache_specs(2, 64), 9, PAGE,
                          dtype=torch.float32, device="cpu")
    assert pool["g0"][0]["l0"]["v"].shape == (10, PAGE, cfg.n_kv_heads,
                                              cfg.head_dim)


# --------------------------------------------------------------------------- #
# model: suffix prefill over a paged prior vs JAX
# --------------------------------------------------------------------------- #
def test_prefill_suffix_matches_jax(models):
    jm, jp, tm, tp = models
    V = tm.cfg.vocab_size
    rng = np.random.default_rng(4)
    B, L, N = 2, 16, 9
    cached = np.asarray([32, 16], np.int32)
    pre = np.zeros((B, 32), np.int32)
    for b in range(B):
        pre[b, :cached[b]] = rng.integers(0, V, cached[b])
    # prefix KV into each side's pool: row 0 -> blocks 3, 5; row 1 -> 7
    dest = np.asarray([[3, 5], [7, 0]], np.int32)
    prior_pt = dest.copy()
    _, jc, _ = jm.prefill_bucketed(jp, {"tokens": jnp.asarray(pre)},
                                   jnp.asarray(cached))
    jpool = jkvc.scatter_pages(
        jkvc.init_paged(jm.cache_specs(B, 64), N, PAGE), jc,
        jnp.asarray(dest))
    _, tc, _ = tm.prefill_bucketed(tp, torch.from_numpy(pre),
                                   torch.from_numpy(cached))
    tpool = kvc.scatter_pages(
        kvc.init_paged(tm.cache_specs(B, 64), N, PAGE, dtype=torch.float32,
                       device="cpu"), tc, dest)

    toks = np.zeros((B, L), np.int32)
    lens = np.asarray([9, 16], np.int32)
    for b in range(B):
        toks[b, :lens[b]] = rng.integers(0, V, lens[b])
    jl, jcache, jtot = jm.prefill_suffix(
        jp, {"tokens": jnp.asarray(toks)}, jnp.asarray(lens),
        jnp.asarray(cached), jkvc.gather_pages(jpool, jnp.asarray(prior_pt)))
    tl, tcache, ttot = tm.prefill_suffix(
        tp, torch.from_numpy(toks), torch.from_numpy(lens),
        torch.from_numpy(cached), torch.from_numpy(prior_pt), tpool)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert ttot.tolist() == np.asarray(jtot).tolist() == [41, 32]
    # the suffix caches hold only the suffix KV; K grows to |k| ~ 20 in the
    # last layer, so its error is held relative to the layer's largest |k|
    jk = np.asarray(jcache["g0"]["l0"]["k"])
    assert jk.shape[2] == L
    for i in range(tm.cfg.n_layers):
        np.testing.assert_allclose(tcache["g0"][i]["l0"]["k"].numpy(), jk[i],
                                   atol=TOL * np.abs(jk[i]).max(), rtol=0)


def test_prefill_suffix_equals_full_prefill(models):
    """The law behind reuse: a suffix prefill over the prefix's cached KV
    gives the logits of a prefill of prefix + suffix."""
    _, _, tm, tp = models
    rng = np.random.default_rng(5)
    full = rng.integers(0, tm.cfg.vocab_size, (1, 40)).astype(np.int32)
    lg_full, _, _ = tm.prefill(tp, torch.from_numpy(full))
    _, tc, _ = tm.prefill(tp, torch.from_numpy(full[:, :32]))
    pool = kvc.scatter_pages(
        kvc.init_paged(tm.cache_specs(1, 64), 4, PAGE, dtype=torch.float32,
                       device="cpu"), tc, np.asarray([[1, 2]], np.int32))
    lg, _, total = tm.prefill_suffix(
        tp, torch.from_numpy(full[:, 32:]), torch.tensor([8], dtype=torch.int32),
        torch.tensor([32], dtype=torch.int32),
        torch.tensor([[1, 2]], dtype=torch.int32), pool)
    assert total.tolist() == [40]
    torch.testing.assert_close(lg, lg_full, atol=5e-4, rtol=0)


# --------------------------------------------------------------------------- #
# engine: vs the JAX paged engine and vs the port's ring engine
# --------------------------------------------------------------------------- #
def _family_prompts(vocab, *, n_families=2, per_family=3, prefix_len=32,
                    suffix_len=16, seed=0):
    """tests/test_paged.py's interleaved families: later admission waves
    hit earlier waves' indexed prefixes."""
    rng = np.random.default_rng(seed)
    fams = [rng.integers(0, vocab, prefix_len, dtype=np.int32)
            for _ in range(n_families)]
    return [np.concatenate([f, rng.integers(0, vocab, suffix_len,
                                            dtype=np.int32)])
            for _ in range(per_family) for f in fams]


def _drain(engine, req_cls, prompts, max_new):
    reqs = [req_cls(prompt_tokens=p, max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        engine.submit(r, time.perf_counter())
    assert len(engine.run_until_drained()) == len(reqs)
    return [list(r.generated) for r in reqs]


def _assert_tokens_match_jax(jm, jp, prompts, want, got):
    """Equal greedy tokens, save where JAX's own top-2 logits tie (the two
    frameworks' fp32 sums may break a tie either way)."""
    for prompt, a, b in zip(prompts, want, got):
        if a == b:
            continue
        k = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = np.concatenate([prompt, np.asarray(a[:k], np.int32)])
        logits, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(ctx)[None, :]})
        top = np.sort(np.asarray(logits[0]))[-2:]
        assert top[1] - top[0] < GAP_TOL, (k, a, b, top)


COUNTERS = ("prefix_hits", "prefix_hit_tokens", "prefill_tokens_total",
            "prefill_tokens_uncached", "prefill_padded_tokens",
            "decode_steps", "useful_steps")


@pytest.fixture(scope="module")
def family_runs(models):
    jm, jp, tm, tp = models
    prompts = _family_prompts(tm.cfg.vocab_size)
    kw = dict(max_batch=2, max_seq=128)
    jeng = JaxEngine(jm, jp, paged=True, page_size=PAGE, **kw)
    jtok = _drain(jeng, JaxRequest, prompts, 4)
    runs = {}
    for name, ekw in (("ring", {}), ("paged", dict(paged=True,
                                                   prefix_reuse=False)),
                      ("reuse", dict(paged=True))):
        eng = ServingEngine(tm, tp, device="cpu", **kw, **ekw)
        runs[name] = (eng, _drain(eng, Request, prompts, 4))
    return prompts, jeng, jtok, runs


def test_paged_engine_matches_jax_paged_engine(models, family_runs):
    jm, jp, _, _ = models
    prompts, jeng, jtok, runs = family_runs
    eng, tok = runs["reuse"]
    _assert_tokens_match_jax(jm, jp, prompts, jtok, tok)
    jc, tc = jeng.counters(), eng.counters()
    assert {k: tc[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}
    # the interleaved families genuinely exercised reuse
    assert tc["prefix_hits"] > 0
    assert tc["prefill_tokens_uncached"] < tc["prefill_tokens_total"]
    assert eng.logits_all_finite()


@pytest.mark.parametrize("name", ["paged", "reuse"])
def test_paged_engine_tokens_equal_ring_engine(family_runs, name):
    _, _, _, runs = family_runs
    assert runs[name][1] == runs["ring"][1]
    if name == "paged":
        assert runs[name][0].counters()["prefix_hits"] == 0


def test_refcounts_leak_no_block_after_clear(family_runs):
    _, _, _, runs = family_runs
    eng = runs["reuse"][0]
    alloc = eng.pool.allocator
    assert alloc.live_blocks > 0  # the index keeps released prefixes warm
    assert not eng.pool.pt_host.any()  # every slot released its row
    for (p, d) in eng.prefix_index.clear():
        alloc.deref([p])
        alloc.deref([d])
    assert alloc.live_blocks == 0
    assert alloc.free_count == alloc.num_blocks - 1
    # block 0 (the sentinel) was never written
    for layer in eng.pool.blocks["g0"]:
        assert not layer["l0"]["k"][0].any() and not layer["l0"]["v"][0].any()


def test_eviction_under_pool_pressure_matches_jax(models):
    """max_batch=1, max_seq=64: 8 usable blocks, one live row takes 4 and
    each prompt indexes 3, so serving 5 distinct prefixes forces LRU
    evictions; counters and tokens stay the JAX engine's."""
    jm, jp, tm, tp = models
    prompts = _family_prompts(tm.cfg.vocab_size, n_families=5, per_family=2,
                              prefix_len=32, suffix_len=16, seed=6)
    kw = dict(max_batch=1, max_seq=64)
    jeng = JaxEngine(jm, jp, paged=True, page_size=PAGE, **kw)
    jtok = _drain(jeng, JaxRequest, prompts, 4)
    eng = ServingEngine(tm, tp, paged=True, device="cpu", **kw)
    assert eng.pool.allocator.num_blocks == 9
    tok = _drain(eng, Request, prompts, 4)
    _assert_tokens_match_jax(jm, jp, prompts, jtok, tok)
    jc, tc = jeng.counters(), eng.counters()
    assert {k: tc[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}
    assert eng.prefix_index.n_pages == jeng.prefix_index.n_pages
    assert eng.pool.allocator.live_blocks == jeng.pool.allocator.live_blocks


def test_max_new_one_releases_its_blocks(models):
    _, _, tm, tp = models
    eng = ServingEngine(tm, tp, max_batch=2, max_seq=64, paged=True,
                        device="cpu")
    prompts = _family_prompts(tm.cfg.vocab_size, per_family=1)
    out = _drain(eng, Request, prompts, 1)
    assert [len(t) for t in out] == [1, 1] and eng.decode_steps == 0
    # only the index's references remain: 2 prompts x 3 pages each
    assert eng.pool.allocator.live_blocks == 6


def test_paged_engine_gates(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="multiple of"):
        ServingEngine(tm, tp, max_batch=2, max_seq=72, paged=True,
                      device="cpu")
    eng = ServingEngine(tm, tp, max_batch=2, max_seq=64, paged=True,
                        device="cpu")
    with pytest.raises(ValueError, match="ring-wraps"):
        eng.submit(Request(prompt_tokens=np.arange(60, dtype=np.int32),
                           max_new_tokens=8))
    eng.submit(Request(prompt_tokens=np.arange(56, dtype=np.int32),
                       max_new_tokens=8))  # exactly max_seq: admitted
    assert eng.prefix_lookup_tokens(np.arange(40)) == 0
    ring = ServingEngine(tm, tp, max_batch=2, max_seq=64, device="cpu")
    ring.submit(Request(prompt_tokens=np.arange(60, dtype=np.int32),
                        max_new_tokens=8))  # the ring pool wraps instead


# --------------------------------------------------------------------------- #
# radix index and allocator: the JAX-free copies vs the originals
# --------------------------------------------------------------------------- #
_tokens = st.lists(st.integers(0, 3), min_size=0, max_size=24)


@given(corpus=st.lists(_tokens, min_size=0, max_size=6), query=_tokens)
@settings(max_examples=150, deadline=None)
def test_radix_longest_prefix_match_law_and_jax_index(corpus, query):
    """match(query) is the longest page-aligned common prefix with any
    inserted prompt, its payloads name pages that share it, and the JAX
    index built from the same corpus answers the same."""
    page = 2
    idx, jidx = RadixPrefixIndex(page), JaxIndex(page)
    for i, toks in enumerate(corpus):
        payloads = [(i, j) for j in range(len(toks) // page)]
        assert idx.insert(toks, payloads) == jidx.insert(toks, payloads)
    got = idx.match(query)
    assert got == jidx.match(query)

    def common_pages(a, b):
        n = 0
        while ((n + 1) * page <= min(len(a), len(b))
               and a[n * page:(n + 1) * page] == b[n * page:(n + 1) * page]):
            n += 1
        return n

    assert len(got) == max((common_pages(t, query) for t in corpus),
                           default=0)
    for j, (i, jj) in enumerate(got):
        assert jj == j and corpus[i][:(j + 1) * page] == query[:(j + 1) * page]
    assert idx.lookup_tokens(query) == len(got) * page
    assert (idx.hits, idx.misses) == (jidx.hits, jidx.misses)


def test_radix_capacity_evicts_lru_leaves():
    idx = RadixPrefixIndex(1, capacity_pages=3)
    idx.insert([1, 2], ["a1", "a2"])
    # shares page [1] (first writer wins there) -> only 1 new page
    idx.insert([1, 3], ["b1", "b2"])
    assert idx.n_pages == 3
    idx.match([1, 2])  # touch the [1,2] chain; [1,3] is now the LRU leaf
    idx.insert([9], ["c1"])
    assert idx.n_pages == 3  # evicted one leaf to fit
    assert idx.match([1, 3], peek=True) == ["a1"]  # leaf gone, trunk kept
    assert idx.match([1, 2], peek=True) == ["a1", "a2"]
    assert idx.evict_lru() == "a2"  # touched before c1 was inserted
    assert sorted(idx.clear()) == ["a1", "c1"] and idx.n_pages == 0


def test_pool_refcount_roundtrip():
    pool = kvc.PagedKVPool(8, PAGE)
    assert pool.live_blocks == 0 and pool.free_count == 7
    ids = pool.alloc(3)
    assert ids == [1, 2, 3]  # deterministic ascending, sentinel never given
    pool.ref(ids)  # a second reader (the prefix index, say)
    assert pool.deref(ids) == [] and pool.live_blocks == 3
    assert sorted(pool.deref(ids)) == ids
    assert pool.live_blocks == 0 and pool.free_count == 7
    with pytest.raises(RuntimeError):
        pool.deref([ids[0]])  # double free
    with pytest.raises(RuntimeError):
        pool.ref([ids[0]])  # ref of a free block
    assert pool.alloc(8) is None  # only 7 non-sentinel blocks exist
    assert sorted(pool.alloc(7)) == list(range(1, 8))
    pool.ref([0])
    assert pool.deref([0]) == []  # the sentinel survives everything
    pool.reset()
    assert pool.live_blocks == 0 and pool.free_count == 7


# --------------------------------------------------------------------------- #
# load generator: the copy draws the JAX original's workload
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["shared_prefix", "poisson"])
def test_schedules_match_jax(kind):
    kw = dict(rate_rps=50.0, n_requests=12, seed=3)
    if kind == "shared_prefix":
        kw.update(n_prefixes=3, prefix_len=32, suffix_len=8, max_new=5)
    fn = f"{kind}_schedule"
    got = getattr(loadgen, fn)(512, **kw)
    want = getattr(jloadgen, fn)(512, **kw)
    assert [a.t for a in got] == [a.t for a in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.request.prompt_tokens,
                                      b.request.prompt_tokens)
        assert a.request.max_new_tokens == b.request.max_new_tokens


def test_open_loop_drives_the_paged_engine(models):
    _, _, tm, tp = models
    sched = loadgen.shared_prefix_schedule(
        tm.cfg.vocab_size, rate_rps=200.0, n_requests=6, n_prefixes=2,
        prefix_len=32, suffix_len=8, max_new=3, seed=7)
    eng = ServingEngine(tm, tp, max_batch=2, max_seq=64, paged=True,
                        device="cpu")
    out = loadgen.run_open_loop(eng, sched)
    assert sorted(r.request_id for r in out) == sorted(
        a.request.request_id for a in sched)
    assert all(len(r.tokens) == 3 for r in out)
    assert eng.idle and eng.prefix_hits > 0


# --------------------------------------------------------------------------- #
# the JAX prefix benchmark's counts, reproduced by the port
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def micro_model():
    """benchmarks/serving.py's llama3-8b-micro, the prefix benchmark's
    model; its weights do not enter the counts."""
    cfg = dataclasses.replace(
        get_config("llama3-8b").reduced(), name="llama3-8b-micro", d_model=64,
        n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=32)
    tm = Model(cfg, dtype=torch.float32, device="cpu")
    return tm, tm.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("rate", ["0.0", "0.5", "0.9"])
def test_prefix_benchmark_counts_reproduced(micro_model, rate):
    """benchmarks/prefix.py's hit-rate sweep (16 requests of 160 prompt
    tokens over 2 Zipf-weighted prefixes, max_batch 4, max_seq 256, one
    priming request per prefix) on the port's fused paged engine: the
    prefill and prefix counters equal the committed BENCH_prefix.json row
    exactly (2560 -> 1280 -> 256 uncached tokens), since they follow from
    the admission logic alone."""
    import json
    from pathlib import Path

    want = json.loads((Path(__file__).resolve().parents[1]
                       / "BENCH_prefix.json").read_text())
    row = want["prefix"]["hit_rate_sweep"][rate]
    tm, tp = micro_model
    plen, n = row["prefix_len"], row["requests"]
    sched = loadgen.shared_prefix_schedule(
        tm.cfg.vocab_size, rate_rps=1000.0, n_requests=n, n_prefixes=2,
        prefix_len=plen, suffix_len=row["suffix_len"], zipf_a=1.1, max_new=4,
        seed=7)
    eng = ServingEngine(tm, tp, max_batch=4, max_seq=256, paged=True,
                        device="cpu")
    if plen:  # benchmarks/prefix.py's priming: prefix + one fresh page
        rng = np.random.default_rng(99)
        seen, primes = set(), []
        for a in sched:
            key = tuple(int(t) for t in a.request.prompt_tokens[:plen])
            if key not in seen:
                seen.add(key)
                primes.append(np.concatenate([
                    a.request.prompt_tokens[:plen],
                    rng.integers(0, tm.cfg.vocab_size, PAGE, dtype=np.int32)]))
        _drain(eng, Request, primes, 2)
    c0 = eng.counters()
    _drain(eng, Request, [a.request.prompt_tokens for a in sched], 4)
    got = {k: eng.counters()[k] - c0[k] for k in (
        "prefill_tokens_total", "prefill_tokens_uncached", "prefix_hits")}
    assert got == {k: row[k] for k in got}
