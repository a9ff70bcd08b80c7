"""Feature payloads (reduced pixtral-12b) in the port against the JAX package
(fp32, CPU, the same numpy inputs and converted weights).

* the model: features [B, F, FRONTEND_DIM] cast to the model's dtype,
  projected and prepended; logits of a forward, a prefill (lengths F + S)
  and decode steps at 1e-4 of JAX's;
* the engine: a mixed drain of feature and text requests gives the JAX
  engine's tokens and prefill and decode counters on the bucketed, packed,
  chunked and legacy engines (feature requests take the exact path on
  each; the counters count prompt tokens, not frames); the paged pool and
  a model without a frontend refuse a feature request;
* the disaggregated tier: the twin of tests/test_disagg.py's
  ``test_disagg_exact_path_feature_request`` under all three mechanisms
  (the handoff moves the frames + prompt prefix), equal to the JAX tier's
  tokens and handoff counters;
* the Router's picks and the RPC wire form of feature requests equal
  JAX's.
"""

import dataclasses
import pickle
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.transfer import TransferMode as JaxMode  # noqa: E402
from repro.models import FRONTEND_DIM as JAX_FRONTEND_DIM  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import kvcache as jkvc  # noqa: E402
from repro.serving import DisaggregatedEngine as JaxDisagg  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import ipc as jipc  # noqa: E402
from repro.serving.cluster import Router as JaxRouter  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.transfer import TransferMode  # noqa: E402
from repro_torch.models import FRONTEND_DIM, Model  # noqa: E402
from repro_torch.models import kvcache as kvc  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DisaggregatedEngine,
    Request,
    ServingEngine,
)
from repro_torch.serving import ipc  # noqa: E402
from repro_torch.serving.cluster import Router  # noqa: E402

ARCH = "pixtral-12b"
TOL = 1e-4
GAP_TOL = 1e-4
KW = dict(max_batch=4, max_seq=64)
# (prompt tokens, feature frames or 0): two photos with a question, two
# plain chat turns (the chunked engine chunks the two longer ones)
MIX = [(6, 12), (17, 0), (9, 20), (33, 0)]
ENGINES = {"bucketed": {}, "packed": dict(packed=True),
           "chunked": dict(prefill_chunk=16), "legacy": dict(legacy=True)}
COUNTERS = ("prefill_padded_tokens", "prefill_tokens_total",
            "prefill_tokens_uncached", "decode_steps", "useful_steps")

_PAIR: list = []
_RUNS: dict = {}


def _pair():
    """(jax model, jax params, port model, port params), once a module."""
    if not _PAIR:
        jm = JaxModel(jax_get_config(ARCH).reduced(), dtype=jnp.float32)
        jp = jm.init(jax.random.key(1))
        cfg = get_config(ARCH).reduced()
        tm = Model(cfg, dtype=torch.float32, device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
        _PAIR.extend((jm, jp, tm, tp))
    return _PAIR


def _mix(vocab, mix=MIX, seed=11):
    """(prompt, features or None) per request, seeded."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, s, dtype=np.int32),
             rng.normal(size=(1, f, FRONTEND_DIM)).astype(np.float32)
             if f else None) for s, f in mix]


def _drain(eng, req_cls, items, max_new=5):
    reqs = [req_cls(prompt_tokens=p.copy(), max_new_tokens=max_new,
                    features=None if f is None else f.copy())
            for p, f in items]
    for r in reqs:
        eng.submit(r, time.perf_counter())
    out = eng.run_until_drained(max_steps=100_000)
    assert len(out) == len(reqs)
    return [list(r.generated) for r in reqs]


def _run(side, way, **kw):
    key = (side, way, tuple(sorted(kw.items())))
    if key not in _RUNS:
        jm, jp, tm, tp = _pair()
        items = _mix(tm.cfg.vocab_size)
        if way in ENGINES:
            eng = (JaxEngine(jm, jp, **KW, **ENGINES[way]) if side == "jax"
                   else ServingEngine(tm, tp, device="cpu", **KW,
                                      **ENGINES[way]))
        else:  # a transfer mode: the tier, fed the 6 + 12 request alone
            items = items[:1]
            eng = (JaxDisagg(jm, jp, transfer_mode=JaxMode(way), max_batch=2,
                             max_seq=32) if side == "jax" else
                   DisaggregatedEngine(tm, tp, device="cpu", max_batch=2,
                                       max_seq=32,
                                       transfer_mode=TransferMode(way)))
        toks = _drain(eng, JaxRequest if side == "jax" else Request, items)
        _RUNS[key] = (toks, eng, items)
    return _RUNS[key]


def _same_tokens(got, want, items):
    """Equal greedy streams, or parted only at a JAX top-2 tie."""
    jm, jp, _, _ = _pair()
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        prompt, feats = items[i]
        batch = {"tokens": jnp.asarray(np.concatenate(
            [prompt, np.asarray(b[:k], np.int32)]))[None]}
        if feats is not None:
            batch["features"] = jnp.asarray(feats)
        logits, _, _ = jm.prefill(jp, batch)
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        assert top2[1] - top2[0] < GAP_TOL, (i, k, a, b)


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #
def test_frontend_schema_matches_jax():
    jm, jp, tm, tp = _pair()
    assert FRONTEND_DIM == JAX_FRONTEND_DIM == 1024
    assert tuple(tp["frontend_proj"].shape) == (1024, tm.cfg.d_model)
    assert set(tp) == set(jp)
    assert tm.attention_only  # bucketed, packed, chunked and paged stay on


def test_logits_with_features_match_jax():
    jm, jp, tm, tp = _pair()
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 11), dtype=np.int32)
    feats = rng.normal(size=(2, 7, FRONTEND_DIM)).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "features": jnp.asarray(feats)}
    full, aux, _ = tm.forward(tp, torch.from_numpy(toks),
                              torch.from_numpy(feats))
    jfull, _, _ = jm.forward(jp, jb)
    assert tuple(full.shape[:2]) == (2, 18) and float(aux) == 0.0
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=0,
                               atol=TOL)
    last, caches, lengths = tm.prefill(tp, torch.from_numpy(toks),
                                       torch.from_numpy(feats))
    jlast, jc, jlens = jm.prefill(jp, jb)
    assert lengths.tolist() == np.asarray(jlens).tolist() == [18, 18]
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0,
                               atol=TOL)
    caches, jc = kvc.grow_cache(caches, 32), jkvc.grow_cache(jc, 32)
    step = np.asarray(jnp.argmax(jlast, axis=-1), np.int32)[:, None]
    for _ in range(4):
        lg, caches, lengths = tm.decode_step(tp, caches,
                                             torch.from_numpy(step), lengths)
        jlg, jc, jlens = jm.decode_step(jp, jc, jnp.asarray(step), jlens)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                                   atol=TOL)
        step = np.asarray(jnp.argmax(jlg, axis=-1), np.int32)[:, None]


def test_features_cast_before_the_projector():
    """bf16: the frames are cast to the model's dtype before
    ``frontend_proj`` (JAX's rounding order), bit for bit against doing so
    by hand."""
    cfg = get_config(ARCH).reduced()
    tm = Model(cfg, dtype=torch.bfloat16, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    feats = torch.randn(1, 5, FRONTEND_DIM, dtype=torch.float32)
    toks = torch.arange(3, dtype=torch.int32)[None]
    x = tm._embed_inputs(tp, toks, feats)
    want = feats.to(torch.bfloat16) @ tp["frontend_proj"]
    assert x.dtype == torch.bfloat16 and tuple(x.shape) == (1, 8, 256)
    assert torch.equal(x[:, :5], want)


# --------------------------------------------------------------------------- #
# The engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("way", list(ENGINES))
def test_mixed_drain_matches_jax(way):
    toks, eng, items = _run("port", way)
    jtoks, jeng, _ = _run("jax", way)
    _same_tokens(toks, jtoks, items)
    for c in COUNTERS:
        assert getattr(eng, c) == getattr(jeng, c), c
    if way != "legacy":  # the legacy loop counts no prefill, in both
        prompts = sum(s for s, _ in MIX)
        assert eng.prefill_tokens_total == prompts  # frames not counted


def test_feature_requests_take_the_exact_path_on_every_engine():
    """The bucketed engine's tokens are every engine's (attention masks
    pads and packs exactly, and no MoE routes them); each feature request
    is one exact prefill call of its S prompt rows."""
    base, eng, _ = _run("port", "bucketed")
    for way in ("packed", "chunked", "legacy"):
        assert _run("port", way)[0] == base, way
    # 2 exact calls (6 and 9 rows) + the text: buckets 32 and 64 at 4 rows
    assert eng.prefill_calls == 4
    assert eng.prefill_padded_tokens == 6 + 9 + 4 * 32 + 4 * 64


def test_paged_and_frontendless_engines_refuse_features():
    _, _, tm, tp = _pair()
    feats = np.zeros((1, 4, FRONTEND_DIM), np.float32)
    eng = ServingEngine(tm, tp, device="cpu", paged=True, **KW)
    with pytest.raises(ValueError, match="paged KV pool serves token"):
        eng.submit(Request(prompt_tokens=np.zeros(4, np.int32),
                           features=feats))
    cfg = get_config("llama3-8b").reduced()
    lm = Model(cfg, dtype=torch.float32, device="cpu")
    lp = lm.init(torch.Generator().manual_seed(0))
    eng = ServingEngine(lm, lp, device="cpu", **KW)
    with pytest.raises(ValueError, match="no frontend"):
        eng.submit(Request(prompt_tokens=np.zeros(4, np.int32),
                           features=feats))


# --------------------------------------------------------------------------- #
# The disaggregated tier
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", [m.value for m in TransferMode])
def test_disagg_feature_request_matches_jax(mode):
    """frames 12 + prompt 6 = 18 > the 16-slot block a 6-token prefix would
    round to: the handoff must move the model's F + S prefix."""
    toks, eng, items = _run("port", mode)
    jtoks, jeng, _ = _run("jax", mode)
    base = _drain(ServingEngine(*_pair()[2:], device="cpu", max_batch=2,
                                max_seq=32), Request, items)
    if mode == "host_staged":
        assert toks[0][0] == base[0][0] and len(toks[0]) == 5
    else:
        assert toks == base
        _same_tokens(toks, jtoks, items)
    for c in ("handoffs", "handoff_wire_bytes", "handoff_request_bytes"):
        assert getattr(eng, c) == getattr(jeng, c), c
    assert eng.handoff_request_bytes == eng.request_handoff_bytes(18)
    assert eng.handoff_request_bytes > eng.request_handoff_bytes(6)


# --------------------------------------------------------------------------- #
# Routing and the RPC wire
# --------------------------------------------------------------------------- #
class _StubEngine:
    def __init__(self, packed):
        self.exact_prefill = False
        self.bucketed_prefill = True
        self.packed = packed
        self.max_seq = 128

    def _bucket(self, s):
        return min(max(1 << max(s - 1, 0).bit_length(), 16), self.max_seq)

    def prefix_lookup_tokens(self, tokens):
        return 0


class _StubReplica:
    def __init__(self, jobs, outstanding, free, packed):
        self.jobs = jobs
        self.outstanding_tokens = outstanding
        self.free_slots = free
        self.engine = _StubEngine(packed)


@pytest.mark.parametrize("policy", list(Router.POLICIES))
def test_router_picks_feature_requests_as_jax(policy):
    """Feature and text requests over evolving stub loads: a feature
    request keys on its exact (length, feature shape), text on its bucket;
    the port picks what JAX picks."""
    router, jrouter = Router(policy), JaxRouter(policy)
    rng = np.random.default_rng(23)
    got, want = [], []
    for i in range(40):
        reps = [_StubReplica(int(rng.integers(0, 3)), int(rng.integers(0, 60)),
                             int(rng.integers(0, 3)), packed=(i % 5 == 4))
                for _ in range(3)]
        prompt = rng.integers(0, 256, int(rng.integers(1, 100)),
                              dtype=np.int32)
        f = int(rng.choice([0, 8, 16, 24]))
        feats = (np.zeros((1, f, FRONTEND_DIM), np.float32) if f else None)
        got.append(router.pick(Request(prompt_tokens=prompt, features=feats),
                               reps))
        want.append(jrouter.pick(JaxRequest(prompt_tokens=prompt,
                                            features=feats), reps))
    assert got == want


def test_feature_request_wire_form_matches_jax():
    feats = np.random.default_rng(2).normal(size=(1, 6, FRONTEND_DIM)).astype(
        np.float32)
    prompt = np.arange(9, dtype=np.int32)
    req = Request(prompt_tokens=prompt, features=feats, max_new_tokens=3,
                  request_id=77)
    jreq = JaxRequest(prompt_tokens=prompt, features=feats, max_new_tokens=3,
                      request_id=77)
    wire, jwire = ipc.request_to_wire(req), jipc.request_to_wire(jreq)
    assert wire.keys() == jwire.keys()
    back = ipc.request_from_wire(pickle.loads(pickle.dumps(wire)))
    assert np.array_equal(back.features, feats)
    assert back.payload_bytes == jreq.payload_bytes == 36 + 6 * 1024 * 4
    assert dataclasses.asdict(back).keys() == dataclasses.asdict(jreq).keys()
