"""Port token-packed and chunked prefill vs the JAX package (fp32, CPU):
the twins of tests/test_packing.py.

Bottom-up:

* the segment law on the flash plain version: a packed row's per-segment
  rows are bitwise the rows of that segment alone in place (masked terms
  add exact zeros), within 3e-6 of the segment run alone at its own width
  (another summation order), and equal to JAX's ``chunked_attention`` on
  the same packed row at the kernels' fp32 2e-5; the run starts the
  flash kernel skips by, and the soundness of that skip;
* ``prefill_packed`` and the dense-prior ``prefill_suffix_dense`` against
  JAX's (logits within 1e-4, caches within 1e-4 of each leaf's largest
  magnitude, about 20 after two random layers: two frameworks' fp32
  matmuls sum in different orders, and the residual stream grows),
  ``unpack_segments`` and ``splice_suffix`` against JAX's, exactly;
* the engine: packed, chunked (``prefill_chunk=16``), both, and packed +
  paged give the bucketed engine's greedy tokens and the JAX engine's
  with the same knobs, with the same prefill counters; packed through the
  disaggregated tier under each mechanism gives the JAX tier's tokens and
  handoff counters (the direct mechanisms the fused engine's tokens); the
  cross-architecture matrix of tests/test_packing.py:338; chunked prefill
  keeps a running request decoding; the knobs' checks, and the SSM
  downgrade to exact prefill.

Greedy tokens are compared exactly; where they part, the JAX model's top-2
logit gap at that token must be under 1e-4 (a tie, not a fault), as in
tests/test_torch_engine.py.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.transfer import TransferMode as JaxMode  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import kvcache as jkvc  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro.serving import DisaggregatedEngine as JaxDisagg  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.transfer import TransferMode  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import kvcache as kvc  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DisaggregatedEngine,
    Request,
    ServingEngine,
)

KTOL = 2e-5  # kernels, fp32 (tests/test_kernels.py)
TOL = 1e-4  # model logits and caches, fp32
GAP_TOL = 1e-4  # a JAX top-2 logit gap below this is a tie, not a fault
_RAGGED = [5, 17, 33, 50]  # tests/test_packing.py's ragged admission
KW = dict(max_batch=4, max_seq=128)
KNOBS = {
    "packed": dict(packed=True),
    "chunked": dict(prefill_chunk=16),
    "packed_chunked": dict(packed=True, prefill_chunk=16),
    "packed_paged": dict(packed=True, paged=True),
}
COUNTERS = ("prefill_padded_tokens", "prefill_tokens_total",
            "prefill_tokens_uncached", "decode_steps", "useful_steps")
HANDOFF = ("handoffs", "handoff_wire_bytes", "handoff_request_bytes")

_PAIRS: dict = {}
_RUNS: dict = {}


def _pair(name):
    """(jax model, jax params, port model, port params): a reduced
    configuration in fp32, one weight set, cached for the module."""
    if name not in _PAIRS:
        jm = JaxModel(jax_get_config(name).reduced(), dtype=jnp.float32)
        jp = jm.init(jax.random.key(1))
        cfg = get_config(name).reduced()
        tm = Model(cfg, dtype=torch.float32, device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
        _PAIRS[name] = (jm, jp, tm, tp)
    return _PAIRS[name]


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, s, dtype=np.int32) for s in lens]


def _drain(eng, req_cls, prompts, max_new=4):
    reqs = [req_cls(prompt_tokens=p.copy(), max_new_tokens=max_new)
            for p in prompts]
    for r in reqs:
        eng.submit(r, time.perf_counter())
    out = eng.run_until_drained(max_steps=100_000)
    assert len(out) == len(reqs)
    return [list(r.generated) for r in reqs]


def _run(side, name, lens, disagg=None, **knobs):
    """Drain ``lens`` (seeded prompts, 4 new tokens) through the JAX or the
    port engine with ``knobs``, once per module: (tokens, engine)."""
    key = (side, name, tuple(lens), disagg, tuple(sorted(knobs.items())))
    if key not in _RUNS:
        jm, jp, tm, tp = _pair(name)
        kw = dict(max_batch=2, max_seq=128) if len(lens) == 2 else dict(KW)
        kw.update(knobs)
        prompts = _prompts(tm.cfg.vocab_size, lens)
        if side == "jax":
            eng = (JaxEngine(jm, jp, temperature=0.0, **kw) if disagg is None
                   else JaxDisagg(jm, jp, transfer_mode=JaxMode(disagg), **kw))
            toks = _drain(eng, JaxRequest, prompts)
        else:
            eng = (ServingEngine(tm, tp, device="cpu", **kw) if disagg is None
                   else DisaggregatedEngine(tm, tp, device="cpu",
                                            transfer_mode=TransferMode(disagg),
                                            **kw))
            toks = _drain(eng, Request, prompts)
        _RUNS[key] = (toks, eng, prompts)
    return _RUNS[key]


def _same_tokens(name, got, want, prompts):
    """Equal greedy streams, or parted only at a JAX top-2 tie."""
    jm, jp, _, _ = _pair(name)
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = np.concatenate([prompts[i], np.asarray(b[:k], np.int32)])
        logits, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(ctx)[None]})
        top = np.sort(np.asarray(logits[0]))[-2:]
        gap = float(top[1] - top[0])
        assert gap < GAP_TOL, (f"request {i}: token {k} differs ({a[k]} vs "
                               f"{b[k]}) at top-2 gap {gap:.2e}")


# --------------------------------------------------------------------------- #
# The segment law on the flash plain version, and the kernel's tile skip
# --------------------------------------------------------------------------- #
def _pack(parts, pad=0):
    """Concatenate [1, s, ...] parts into one row with ``pad`` pad tokens:
    (packed, segment ids [1, T] with -1 on pads, starts)."""
    T = sum(p.shape[1] for p in parts) + pad
    out = np.zeros((1, T) + parts[0].shape[2:], parts[0].dtype)
    seg = np.full((1, T), -1, np.int32)
    starts, off = [], 0
    for j, p in enumerate(parts):
        s = p.shape[1]
        out[0, off:off + s] = p[0]
        seg[0, off:off + s] = j
        starts.append(off)
        off += s
    return out, seg, starts


def _law_case(seed):
    rng = np.random.default_rng(seed)
    lens = [int(s) for s in rng.integers(1, 12, rng.integers(1, 6))]
    window = int(rng.choice([0, 4]))
    H, Hkv, hd = 4, 2, 8
    parts = [tuple(rng.standard_normal((1, s, h, hd)).astype(np.float32)
                   for h in (H, Hkv, Hkv)) for s in lens]
    pad = int(rng.integers(0, 5))
    packed = [_pack([p[i] for p in parts], pad) for i in range(3)]
    return lens, window, parts, packed


@pytest.mark.parametrize("seed", range(16))
def test_packed_attention_segment_law(seed):
    """Each segment's rows of the packed row: bitwise the segment alone in
    place; within 3e-6 of the segment run alone; JAX's chunked_attention
    on the packed row within 2e-5."""
    lens, window, parts, packed = _law_case(seed)
    (qp, seg, starts), (kp, _, _), (vp, _, _) = packed
    T = qp.shape[1]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = ops.flash_attention(t(qp), t(kp), t(vp), causal=True,
                              window=window, segment_ids=t(seg)).numpy()
    want = chunked_attention(jnp.asarray(qp), jnp.asarray(kp),
                             jnp.asarray(vp), causal=True, window=window,
                             segment_ids=jnp.asarray(seg))
    np.testing.assert_allclose(got, np.asarray(want), atol=KTOL, rtol=1e-2)
    for j, (q, k, v) in enumerate(parts):
        s, a = lens[j], starts[j]

        def alone(x):
            iso = np.zeros((1, T) + x.shape[2:], np.float32)
            iso[0, a:a + s] = x[0]
            return t(iso)

        seg_iso = np.full((1, T), -1, np.int32)
        seg_iso[0, a:a + s] = j
        in_place = ops.flash_attention(alone(q), alone(k), alone(v),
                                       causal=True, window=window,
                                       segment_ids=t(seg_iso)).numpy()
        np.testing.assert_array_equal(got[:, a:a + s], in_place[:, a:a + s])
        lone = ops.flash_attention(t(q), t(k), t(v), causal=True,
                                   window=window).numpy()
        np.testing.assert_allclose(got[:, a:a + s], lone, atol=3e-6, rtol=0)


def test_packed_poison_canary():
    """Corrupting every value of segment A moves not one bit of segment
    B's rows."""
    rng = np.random.default_rng(7)
    mk = lambda s: rng.standard_normal((1, s, 2, 8)).astype(np.float32)  # noqa: E731
    a = (mk(6), mk(6), mk(6))
    b = (mk(5), mk(5), mk(5))
    poison = tuple(np.full_like(x, 1e4) for x in a)

    def run(a_parts):
        (q, seg, st), (k, _, _), (v, _, _) = (
            _pack([a_parts[i], b[i]], pad=3) for i in range(3))
        t = torch.from_numpy
        out = ops.flash_attention(t(q), t(k), t(v), causal=True,
                                  segment_ids=t(seg))
        return out[:, st[1]:st[1] + 5].numpy()

    np.testing.assert_array_equal(run(a), run(poison))


@pytest.mark.parametrize("seed", range(6))
def test_segment_run_starts_and_the_tile_skip(seed):
    """``segment_run_starts`` gives each position's run start; and for
    every q-tile of 64 or 32 rows (the bf16 and fp32 bodies' tiles), every
    key a row of the tile may see (same segment, causal) lies at or after
    the tile's first row's run start: the sweep the kernel skips holds
    none."""
    rng = np.random.default_rng(seed)
    B, T = 2, 300
    seg = np.full((B, T), -1, np.int32)
    for b in range(B):
        off, j = 0, 0
        while True:
            s = int(rng.integers(1, 90))
            if off + s > T - int(rng.integers(0, 20)):
                break
            seg[b, off:off + s] = j
            off, j = off + s, j + 1
    starts = ops.segment_run_starts(torch.from_numpy(seg)).numpy()
    for b in range(B):
        for i in range(T):
            j = i
            while j > 0 and seg[b, j - 1] == seg[b, i]:
                j -= 1
            assert starts[b, i] == j
    for tile in (64, 32):
        for b in range(B):
            for q0 in range(0, T, tile):
                rows = range(q0, min(q0 + tile, T))
                first = min(k for r in rows for k in range(r + 1)
                            if seg[b, k] == seg[b, r])
                assert first >= starts[b, q0]


# --------------------------------------------------------------------------- #
# Model and cache functions against JAX's
# --------------------------------------------------------------------------- #
def _close_cache(got, want):
    """A cache leaf within TOL of its largest magnitude."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * float(np.abs(want).max()))


def _layers(tree):
    """A port cache tree's k/v leaves, layer by layer, as numpy."""
    return [{k: block["l0"][k].numpy() for k in ("k", "v")}
            for block in tree["g0"]]


@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-32b"])
def test_prefill_packed_matches_jax(name):
    jm, jp, tm, tp = _pair(name)
    lens = [5, 17, 9]
    prompts = _prompts(tm.cfg.vocab_size, lens, seed=3)
    T = 40
    toks = np.zeros((1, T), np.int32)
    pos = np.zeros((1, T), np.int32)
    seg = np.full((1, T), -1, np.int32)
    starts = np.zeros((4,), np.int32)
    last = np.zeros((4,), np.int32)
    off = 0
    for j, p in enumerate(prompts):
        toks[0, off:off + len(p)] = p
        pos[0, off:off + len(p)] = np.arange(len(p))
        seg[0, off:off + len(p)] = j
        starts[j], last[j] = off, off + len(p) - 1
        off += len(p)
    t = torch.from_numpy
    tl, tc = tm.prefill_packed(tp, t(toks), t(pos), t(seg), t(last))
    jl, jc = jm.prefill_packed(jp, jnp.asarray(toks), jnp.asarray(pos),
                               jnp.asarray(seg), jnp.asarray(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    out_w = 32
    tu = _layers(kvc.unpack_segments(tc, t(starts), out_w))
    ju = jkvc.unpack_segments(jc, jnp.asarray(starts), out_w)["g0"]["l0"]
    for i, layer in enumerate(tu):
        for key in ("k", "v"):
            _close_cache(layer[key], np.asarray(ju[key][i]))
    # each segment's logits are its lone bucketed prefill's
    for j, p in enumerate(prompts):
        lone, _, _ = tm.prefill(tp, t(p[None]))
        np.testing.assert_allclose(tl[j].numpy(), lone[0].numpy(),
                                   atol=TOL, rtol=TOL)


def test_prefill_suffix_dense_matches_jax():
    """One chunk against a fixed-width dense prior (prior_valid 0, partial
    and full-minus-chunk), as the chunk path calls it."""
    jm, jp, tm, tp = _pair("llama3-8b")
    W, C = 64, 16
    rng = np.random.default_rng(5)
    prior = tm.init_cache(3, W)
    jprior = jm.init_cache(3, W)
    for i, block in enumerate(prior["g0"]):
        for key in ("k", "v"):
            a = rng.standard_normal(block["l0"][key].shape).astype(np.float32)
            block["l0"][key].copy_(torch.from_numpy(a))
            jprior["g0"]["l0"][key] = jprior["g0"]["l0"][key].at[i].set(a)
    cached = np.asarray([0, 21, W - C], np.int32)
    lens = np.asarray([C, 9, C], np.int32)
    toks = rng.integers(0, tm.cfg.vocab_size, (3, C)).astype(np.int32)
    t = torch.from_numpy
    tl, tc, ttot = tm.prefill_suffix_dense(tp, t(toks), t(lens), t(cached),
                                           prior)
    jl, jc, jtot = jm.prefill_suffix(jp, {"tokens": jnp.asarray(toks)},
                                     jnp.asarray(lens), jnp.asarray(cached),
                                     jprior)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(ttot.numpy(), np.asarray(jtot))
    for i, layer in enumerate(_layers(tc)):
        for key in ("k", "v"):
            _close_cache(layer[key], np.asarray(jc["g0"]["l0"][key][i]))


def test_unpack_segments_matches_jax_exactly():
    rng = np.random.default_rng(2)
    T, out_w = 37, 16
    leaf = {k: rng.standard_normal((1, T, 2, 8)).astype(np.float32)
            for k in ("k", "v")}
    starts = np.asarray([0, 5, 30, 36, 0], np.int32)  # clipped and dummy rows
    got = kvc.unpack_segments(
        {"g0": [{"l0": {k: torch.from_numpy(a) for k, a in leaf.items()}}]},
        torch.from_numpy(starts), out_w)["g0"][0]["l0"]
    want = jkvc.unpack_segments({"l0": {k: jnp.asarray(a)
                                        for k, a in leaf.items()}},
                                jnp.asarray(starts), out_w)["l0"]
    for k in ("k", "v"):
        assert got[k].shape == (5, out_w, 2, 8)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("offset", [0, 7, 48, 60])  # 60 clamps to W - C
def test_splice_suffix_matches_jax_exactly(offset):
    rng = np.random.default_rng(offset)
    W, C = 64, 16
    prior = {k: rng.standard_normal((1, W, 2, 8)).astype(np.float32)
             for k in ("k", "v")}
    suffix = {k: rng.standard_normal((1, C, 2, 8)).astype(np.float32)
              for k in ("k", "v")}
    tprior = {"g0": [{"l0": {k: torch.from_numpy(a.copy())
                             for k, a in prior.items()}}]}
    tsuffix = {"g0": [{"l0": {k: torch.from_numpy(a)
                              for k, a in suffix.items()}}]}
    got = kvc.splice_suffix(tprior, tsuffix,
                            torch.tensor([offset], dtype=torch.int32))
    assert got is tprior  # in place
    want = jkvc.splice_suffix({"l0": {k: jnp.asarray(a)
                                      for k, a in prior.items()}},
                              {"l0": {k: jnp.asarray(a)
                                      for k, a in suffix.items()}},
                              jnp.int32(offset))["l0"]
    for k in ("k", "v"):
        np.testing.assert_array_equal(got["g0"][0]["l0"][k].numpy(),
                                      np.asarray(want[k]))


# --------------------------------------------------------------------------- #
# The engine against the bucketed engine and the JAX engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_engine_tokens_match_bucketed_and_jax(knob):
    got, eng, prompts = _run("port", "llama3-8b", _RAGGED, **KNOBS[knob])
    base, _, _ = _run("port", "llama3-8b", _RAGGED)
    jgot, jeng, _ = _run("jax", "llama3-8b", _RAGGED, **KNOBS[knob])
    assert eng.packed == jeng.packed
    assert eng._chunk_enabled == jeng._chunk_enabled
    assert eng.prefix_reuse == jeng.prefix_reuse
    _same_tokens("llama3-8b", got, base, prompts)
    _same_tokens("llama3-8b", got, jgot, prompts)
    assert eng.idle and eng.logits_all_finite()


@pytest.mark.parametrize("knob", sorted(KNOBS) + ["bucketed"])
def test_engine_counters_match_jax(knob):
    knobs = KNOBS.get(knob, {})
    _, eng, _ = _run("port", "llama3-8b", _RAGGED, **knobs)
    _, jeng, _ = _run("jax", "llama3-8b", _RAGGED, **knobs)
    got = {k: eng.counters()[k] for k in COUNTERS}
    assert got == {k: jeng.counters()[k] for k in COUNTERS}


def test_packed_padded_token_win():
    """On the ragged admission packing dispatches fewer padded token-rows
    than bucketing (tests/test_packing.py's FLOPs proxy), the true-token
    counters agree, and the packed width is the pow2 roof of the admission's
    true tokens: 128 rows for 105 tokens against 4 x (16 + 32 + 64 + 64)."""
    _, packed, _ = _run("port", "llama3-8b", _RAGGED, packed=True)
    _, bucketed, _ = _run("port", "llama3-8b", _RAGGED)
    assert packed.prefill_tokens_total == bucketed.prefill_tokens_total == 105
    assert packed.prefill_padded_tokens == 128
    assert bucketed.prefill_padded_tokens == 448
    assert packed.prefill_calls == 1 and bucketed.prefill_calls == 3
    _, chunked, _ = _run("port", "llama3-8b", _RAGGED, prefill_chunk=16)
    # every chunk dispatches exactly chunk-width token rows
    assert chunked.prefill_padded_tokens % 16 == 0


@pytest.mark.parametrize("mode", [m.value for m in TransferMode])
def test_packed_disagg_matches_jax_tier(mode):
    """Packed admissions take the same handoff: the JAX tier's tokens and
    handoff counters under each mechanism; the direct mechanisms also the
    fused bucketed engine's tokens."""
    got, eng, prompts = _run("port", "llama3-8b", _RAGGED, disagg=mode,
                             packed=True)
    jgot, jeng, _ = _run("jax", "llama3-8b", _RAGGED, disagg=mode,
                         packed=True)
    _same_tokens("llama3-8b", got, jgot, prompts)
    assert ({k: eng.counters()[k] for k in HANDOFF}
            == {k: getattr(jeng, k) for k in HANDOFF})
    base, _, _ = _run("port", "llama3-8b", _RAGGED)
    if mode == "host_staged":  # int8 KV: the first tokens come before it
        assert [g[0] for g in got] == [b[0] for b in base]
    else:
        _same_tokens("llama3-8b", got, base, prompts)


def test_chunked_disagg_matches_fused():
    """A chunk's prior stays on the prefill side and only the final
    artifact hops (tests/test_packing.py's disaggregated chunk case)."""
    got, eng, prompts = _run("port", "llama3-8b", _RAGGED,
                             disagg="direct_hbm", prefill_chunk=16)
    base, _, _ = _run("port", "llama3-8b", _RAGGED)
    _same_tokens("llama3-8b", got, base, prompts)
    # one handoff per bucketed group (the 5-token prompt) or chunked
    # request (17, 33 and 50 tokens)
    assert eng.handoffs == 4


@pytest.mark.parametrize("name", ["llama3-8b", "starcoder2-3b", "qwen3-32b"])
def test_cross_arch_packed_chunked_identity(name):
    """tests/test_packing.py:338 on the port: packed + chunked (C = 32)
    gives the bucketed engine's tokens, and JAX's, on each dense arch."""
    lens = [9, 40]
    got, eng, prompts = _run("port", name, lens, packed=True,
                             prefill_chunk=32)
    assert eng.packed and eng._chunk_enabled
    base, _, _ = _run("port", name, lens)
    jbase, _, _ = _run("jax", name, lens)
    _same_tokens(name, got, base, prompts)
    _same_tokens(name, got, jbase, prompts)


def test_chunked_prefill_keeps_decode_moving():
    """While a long admission is mid-chunk, a running request keeps
    producing tokens (tests/test_packing.py's interleave case)."""
    _, _, tm, tp = _pair("llama3-8b")
    eng = ServingEngine(tm, tp, max_batch=2, max_seq=128, prefill_chunk=16,
                        device="cpu")
    victim = Request(prompt_tokens=_prompts(tm.cfg.vocab_size, [8], 1)[0],
                     max_new_tokens=48)
    eng.submit(victim)
    while len(victim.generated) < 4:
        eng.step()
    big = Request(prompt_tokens=_prompts(tm.cfg.vocab_size, [100], 2)[0],
                  max_new_tokens=4)
    eng.submit(big)
    progressed = []
    while eng._chunk_jobs or not big.generated:
        mid_chunk = bool(eng._chunk_jobs)
        before = len(victim.generated)
        eng.step()
        if mid_chunk:
            progressed.append(len(victim.generated) > before)
        assert len(progressed) < 10_000
    assert len(progressed) >= 6 and any(progressed)
    eng.run_until_drained()
    assert len(victim.generated) == 48 and len(big.generated) == 4


def test_knob_validation():
    _, _, tm, tp = _pair("llama3-8b")
    with pytest.raises(ValueError, match="ring"):
        ServingEngine(tm, tp, max_batch=2, max_seq=64, paged=True,
                      prefill_chunk=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq"):
        ServingEngine(tm, tp, max_batch=2, max_seq=64, prefill_chunk=128,
                      device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        ServingEngine(tm, tp, max_batch=2, max_seq=64, prefill_chunk=-1,
                      device="cpu")
    eng = ServingEngine(tm, tp, max_batch=2, max_seq=64, paged=True,
                        packed=True, device="cpu")
    assert eng.packed and not eng.prefix_reuse


def test_ssm_stack_downgrades_to_exact_prefill():
    """mamba2-130m: the knobs turn off silently (pad and neighbour tokens
    would flow into the recurrent state), and the tokens are the default
    engine's."""
    cfg = get_config("mamba2-130m").reduced()
    tm = Model(cfg, dtype=torch.float32, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    prompts = _prompts(cfg.vocab_size, [9, 40])
    eng = ServingEngine(tm, tp, max_batch=2, max_seq=128, packed=True,
                        prefill_chunk=32, device="cpu")
    assert eng.exact_prefill and not eng.packed and not eng._chunk_enabled
    got = _drain(eng, Request, prompts)
    base = ServingEngine(tm, tp, max_batch=2, max_seq=128, device="cpu")
    assert got == _drain(base, Request, prompts)
    assert eng.prefill_calls == 2
    assert eng.prefill_padded_tokens == 49


def test_packed_sampling_is_deterministic():
    """Device-side sampling through a packed admission: the same seed gives
    the same tokens, and top_k = 1 is greedy."""
    _, _, tm, tp = _pair("llama3-8b")
    prompts = _prompts(tm.cfg.vocab_size, [6, 11, 19], seed=5)

    def tokens(**kw):
        eng = ServingEngine(tm, tp, max_batch=4, max_seq=64, packed=True,
                            prefill_chunk=16, device="cpu", **kw)
        return _drain(eng, Request, prompts, 5)

    assert (tokens(temperature=0.9, top_k=8, sample_seed=3)
            == tokens(temperature=0.9, top_k=8, sample_seed=3))
    assert tokens(temperature=1.3, top_k=1, sample_seed=4) == tokens()


def test_launcher_grows_no_knob():
    """The knobs live on the engine, as in JAX: neither launcher has one."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve

    for mod in (serve, jax_serve):
        src = open(mod.__file__).read()
        assert "packed" not in src and "prefill_chunk" not in src
