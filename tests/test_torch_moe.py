"""The port's MoE layer and reduced grok-1-314b against the JAX package
(fp32, CPU, the same numpy inputs and converted weights).

Bottom-up:

* ``capacity``, ``router_topk`` (ties included: the lower expert first, as
  ``jax.lax.top_k``), ``load_balance_loss`` and ``moe_apply`` against JAX's
  at 1e-5, with tokens dropped (the default capacity factor 1.25) and
  without (``nodrop``), with and without a shared expert;
* reduced grok-1 logits: a full forward, its aux loss, a prefill and 4
  decode steps, at 1e-4;
* the engine at the default capacity factor, where pad rows take capacity
  and drops differ between paths: each path's tokens and prefill and
  decode counters equal the JAX engine's on the SAME path (bucketed,
  packed, chunked, paged, legacy, warmed, and DisaggregatedEngine under
  DIRECT_HBM with its handoff counters);
* under ``nodrop`` the laws hold: prefill + decode == forward.

Greedy tokens are compared exactly; where they part, the JAX model's top-2
logit gap at that token must be under GAP_TOL (a tie, not a fault).
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import nodrop  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.transfer import TransferMode as JaxMode  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import kvcache as jkvc  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import DisaggregatedEngine as JaxDisagg  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.transfer import TransferMode  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import kvcache as kvc  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DisaggregatedEngine,
    Request,
    ServingEngine,
)

ARCH = "grok-1-314b"
MTOL = 1e-5  # the MoE layer alone, fp32
TOL = 1e-4  # model logits, fp32
GAP_TOL = 1e-4
LENS = [5, 17, 33, 50]  # tests/test_packing.py's ragged admission
KW = dict(max_batch=4, max_seq=128)
PATHS = {
    "bucketed": {},
    "packed": dict(packed=True),
    "chunked": dict(prefill_chunk=16),
    "paged": dict(paged=True),
    "legacy": dict(legacy=True),
    "warmed": dict(warmup=True),
}
COUNTERS = ("prefill_padded_tokens", "prefill_tokens_total",
            "prefill_tokens_uncached", "decode_steps", "useful_steps")


def _cfgs(drop=True, shared=0):
    """(JAX config, port config): reduced grok-1, optionally nodrop and with
    ``shared`` shared experts."""
    out = []
    for c in (jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()):
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, n_shared_experts=shared))
        out.append(c if drop else nodrop(c))
    return out


_PAIRS: dict = {}
_RUNS: dict = {}


def _pair(drop=True):
    """(jax model, jax params, port model, port params), once a module."""
    if drop not in _PAIRS:
        jcfg, cfg = _cfgs(drop)
        jm = JaxModel(jcfg, dtype=jnp.float32)
        jp = jm.init(jax.random.key(1))
        tm = Model(cfg, dtype=torch.float32, device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
        _PAIRS[drop] = (jm, jp, tm, tp)
    return _PAIRS[drop]


def _np_tree(tree, i=None):
    if isinstance(tree, dict):
        return {k: _np_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree if i is None else tree[i])


# --------------------------------------------------------------------------- #
# The layer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("T", [1, 4, 7, 8, 64, 100, 8192])
@pytest.mark.parametrize("drop", [True, False])
def test_capacity_matches_jax(T, drop):
    jcfg, cfg = _cfgs(drop)
    c = moe.capacity(T, cfg.moe)
    assert c == jmoe.capacity(T, jcfg.moe)
    assert c >= 8 and c % 8 == 0


def test_router_topk_and_aux_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(64, 8)).astype(np.float32)
    # exact ties in a row, as bf16 router logits give: the lower expert
    # comes first in both packages
    logits[:8, 5] = logits[:8, 2]
    logits[8:16, 1] = logits[8:16, 6] = logits[8:16].max(axis=1) + 1.0
    w, ids = moe.router_topk(torch.from_numpy(logits), 2)
    jw, jids = jmoe.router_topk(jnp.asarray(logits), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    assert (ids[8:16, 0] == 1).all() and (ids[8:16, 1] == 6).all()
    aux = moe.load_balance_loss(torch.from_numpy(logits), ids, 8)
    jaux = jmoe.load_balance_loss(jnp.asarray(logits), jids, 8)
    assert abs(float(aux) - float(jaux)) <= 1e-5


@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("T", [6, 40, 96])
def test_moe_apply_matches_jax(drop, shared, T):
    jcfg, cfg = _cfgs(drop, shared)
    p = _np_tree(JaxModel(jcfg, dtype=jnp.float32).init(
        jax.random.key(T))["decoder"]["g0"]["l0"]["moe"], 0)
    x = np.random.default_rng(T).normal(size=(T, cfg.d_model)).astype(
        np.float32)
    if T == 96:  # skewed towards expert 0, so that first choices overflow
        r0 = p["router"][:, 0]
        x += 8.0 * r0 / np.linalg.norm(r0)
    jout, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jcfg,
                                jnp.asarray(x))
    tp = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
              {kk: torch.from_numpy(vv) for kk, vv in v.items()})
          for k, v in p.items()}
    out, aux = moe.moe_apply(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=MTOL * max(1.0, np.abs(jout).max()))
    assert abs(float(aux) - float(jaux)) <= 1e-5
    # the skewed case drops choices at the default capacity factor, and
    # nothing drops under nodrop
    _, ids = moe.router_topk(torch.from_numpy(x) @ tp["router"], cfg.moe.top_k)
    _, keep, slot_tok = moe.dispatch_plan(ids, cfg.moe.n_experts,
                                          moe.capacity(T, cfg.moe))
    if not drop or T <= 8:
        assert bool(keep.all())
    elif T == 96:
        assert not bool(keep.all())
    # every kept choice sits in exactly one slot, and empty slots are T
    assert int((slot_tok < T).sum()) == int(keep.sum())


def test_dispatch_is_row_major_and_k_major():
    """Slots fill by token order within a choice, and all first choices
    before any second choice: a second choice never takes a first
    choice's slot (the JAX per-k cumsum)."""
    ids = torch.tensor([[0, 1], [0, 1], [1, 0], [0, 2]])
    pos, keep, slot_tok = moe.dispatch_plan(ids, 3, 3)
    assert pos.tolist() == [[0, 1], [1, 2], [0, 3], [2, 0]]
    assert keep.tolist() == [[True, True], [True, True], [True, False],
                             [True, True]]
    assert slot_tok.tolist() == [[0, 1, 3], [2, 0, 1], [3, 4, 4]]


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #
def test_schema_writes_moe_where_jax_does():
    jm, jp, tm, tp = _pair()
    layer = tp["decoder"]["g0"][0]["l0"]
    assert "moe" in layer and "ffn" not in layer
    assert set(layer["moe"]) == set(jp["decoder"]["g0"]["l0"]["moe"])
    E, d, f = 4, tm.cfg.d_model, tm.cfg.moe.d_ff
    assert tuple(layer["moe"]["w_gate"].shape) == (E, d, f)
    assert tuple(layer["moe"]["w_down"].shape) == (E, f, d)


def test_grok_logits_prefill_and_decode_match_jax():
    jm, jp, tm, tp = _pair()
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (2, 21),
                                             dtype=np.int32)
    full, aux, _ = tm.forward(tp, torch.from_numpy(toks))
    jfull, jaux, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=0,
                               atol=TOL)
    assert float(aux) > 0 and abs(float(aux) - float(jaux)) <= 1e-5
    last, caches, lengths = tm.prefill(tp, torch.from_numpy(toks[:, :16]))
    jlast, jc, jlens = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :16])})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0,
                               atol=TOL)
    caches = kvc.grow_cache(caches, 32)
    jc = jkvc.grow_cache(jc, 32)
    for t in range(16, 20):
        step = torch.from_numpy(toks[:, t:t + 1])
        lg, caches, lengths = tm.decode_step(tp, caches, step, lengths)
        jlg, jc, jlens = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                        jlens)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                                   atol=TOL)


def test_nodrop_prefill_plus_decode_equals_forward():
    """With nothing dropped, routing is per token, so a prefill of the
    first 12 tokens then 6 decode steps gives the full forward's logits."""
    _, _, tm, tp = _pair(drop=False)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tm.cfg.vocab_size, (2, 18), dtype=np.int32))
    full, _, _ = tm.forward(tp, toks)
    last, caches, lengths = tm.prefill(tp, toks[:, :12])
    torch.testing.assert_close(last, full[:, 11], rtol=0, atol=TOL)
    caches = kvc.grow_cache(caches, 32)
    for t in range(12, 18):
        lg, caches, lengths = tm.decode_step(tp, caches, toks[:, t:t + 1],
                                             lengths)
        torch.testing.assert_close(lg, full[:, t], rtol=0, atol=TOL)


# --------------------------------------------------------------------------- #
# The engine, path by path, against the JAX engine on the same path
# --------------------------------------------------------------------------- #
def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, s, dtype=np.int32) for s in lens]


def _drain(eng, req_cls, prompts, max_new=6):
    reqs = [req_cls(prompt_tokens=p.copy(), max_new_tokens=max_new)
            for p in prompts]
    for r in reqs:
        eng.submit(r, time.perf_counter())
    out = eng.run_until_drained(max_steps=100_000)
    assert len(out) == len(reqs)
    return [list(r.generated) for r in reqs]


def _run(side, path):
    key = (side, path)
    if key not in _RUNS:
        jm, jp, tm, tp = _pair()
        prompts = _prompts(tm.cfg.vocab_size)
        if path == "disagg":
            eng = (JaxDisagg(jm, jp, transfer_mode=JaxMode.DIRECT_HBM, **KW)
                   if side == "jax" else
                   DisaggregatedEngine(tm, tp, device="cpu", **KW,
                                       transfer_mode=TransferMode.DIRECT_HBM))
        else:
            eng = (JaxEngine(jm, jp, **KW, **PATHS[path]) if side == "jax"
                   else ServingEngine(tm, tp, device="cpu", **KW,
                                      **PATHS[path]))
        toks = _drain(eng, JaxRequest if side == "jax" else Request, prompts)
        _RUNS[key] = (toks, eng, prompts)
    return _RUNS[key]


def _same_tokens(got, want, prompts):
    jm, jp, _, _ = _pair()
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = np.concatenate([prompts[i], np.asarray(b[:k], np.int32)])
        logits, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(ctx)[None]})
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        assert top2[1] - top2[0] < GAP_TOL, (i, k, a, b)


@pytest.mark.parametrize("path", [*PATHS, "disagg"])
def test_engine_path_matches_jax_same_path(path):
    toks, eng, prompts = _run("port", path)
    jtoks, jeng, _ = _run("jax", path)
    _same_tokens(toks, jtoks, prompts)
    assert all(len(t) == 6 for t in toks)
    for c in COUNTERS:
        assert getattr(eng, c) == getattr(jeng, c), c
    if path == "disagg":
        for c in ("handoffs", "handoff_wire_bytes", "handoff_request_bytes"):
            assert getattr(eng, c) == getattr(jeng, c), c


def test_direct_hbm_and_warmed_give_the_bucketed_tokens():
    """The handoff moves the KV bit for bit and warm-up changes nothing, so
    both give the fused bucketed engine's tokens (the same rows, hence the
    same drops)."""
    base = _run("port", "bucketed")[0]
    assert _run("port", "disagg")[0] == base
    assert _run("port", "warmed")[0] == base


def test_default_capacity_drops_on_a_bucketed_prefill(monkeypatch):
    """The engine comparisons above run where drops happen: a bucketed
    prefill of LENS (4 rows padded to 64) overflows an expert."""
    _, _, tm, tp = _pair()
    seen = []
    plan = moe.dispatch_plan

    def spy(ids, E, C):
        out = plan(ids, E, C)
        seen.append(int((~out[1]).sum()))
        return out

    monkeypatch.setattr(moe, "dispatch_plan", spy)
    toks = np.zeros((4, 64), np.int32)
    for j, p in enumerate(_prompts(tm.cfg.vocab_size)):
        toks[j, :len(p)] = p
    tm.prefill_bucketed(tp, torch.from_numpy(toks),
                        torch.tensor(LENS, dtype=torch.int32))
    assert len(seen) == 2 and max(seen) > 0


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("variant", ["scanned", "unscanned_shared",
                                     "frontend"])
def test_params_from_numpy_carries_moe_and_frontend_bits(variant):
    """bf16 JAX weights cross bit for bit: the nested ``moe`` leaves (router,
    the expert-major w_gate/w_up/w_down, ``shared.*``) in scanned (a leading
    layer axis, split per superblock) and unscanned groups, and the
    top-level ``frontend_proj``."""
    jcfg = {"scanned": jax_get_config(ARCH).reduced(),
            "unscanned_shared": dataclasses.replace(
                _cfgs(shared=1)[0], n_layers=3, moe=dataclasses.replace(
                    _cfgs(shared=1)[0].moe, first_dense=1)),
            "frontend": jax_get_config("pixtral-12b").reduced()}[variant]
    jm = JaxModel(jcfg, dtype=jnp.bfloat16)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(2)))
    cfg = get_config(jcfg.name.removesuffix("-reduced")).reduced()
    cfg = dataclasses.replace(cfg, n_layers=jcfg.n_layers, moe=jcfg.moe)
    tp = params_from_numpy(jp, cfg, device="cpu")
    tm = Model(cfg, dtype=torch.bfloat16, device="cpu")
    n = 0
    for gi, g in enumerate(tm.groups):
        for i in range(g.count):
            for j in range(len(g.sigs)):
                leaf = jp["decoder"][f"g{gi}"][f"l{j}"]
                got = tp["decoder"][f"g{gi}"][i][f"l{j}"]
                want = _np_tree(leaf, i if g.count > 1 else None)
                for path in (("moe", "router"), ("moe", "w_gate"),
                             ("moe", "w_up"), ("moe", "w_down"),
                             ("moe", "shared", "w_gate"),
                             ("moe", "shared", "w_down"), ("ffn", "w_up")):
                    a, b = got, want
                    for k in path:
                        if k not in a:
                            break
                        a, b = a[k], b[k]
                    else:
                        assert a.dtype == torch.bfloat16
                        torch.testing.assert_close(
                            _bits(a), _bits(torch.from_numpy(
                                b.view(np.int16)).view(torch.bfloat16)),
                            rtol=0, atol=0)
                        n += 1
    if variant == "frontend":
        fp = tp["frontend_proj"]
        assert tuple(fp.shape) == (1024, cfg.d_model)
        assert np.array_equal(_bits(fp).numpy(),
                              jp["frontend_proj"].view(np.int16))
    elif variant == "scanned":
        assert len(tm.groups) == 1 and tm.groups[0].count == 2 and n == 8
    else:  # one superblock: a dense layer, then two MoE layers with shared
        assert tm.groups[0].count == 1 and n == 1 + 2 * 6


@pytest.mark.parametrize("arch", ["grok-1-314b", "pixtral-12b"])
def test_launcher_serves_from_the_registry_on_cpu(arch, capsys):
    """``launch/serve.py --arch grok-1-314b|pixtral-12b --reduced --device
    cpu``: token requests, as the JAX launcher sends."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--clients", "2", "--requests", "1",
                      "--prompt-len", "4:24", "--new-tokens", "3"])
    assert len(out["responses"]) == 2
    assert all(len(r.tokens) == 3 for r in out["responses"])
    assert f"{arch}-reduced (2 layers)" in capsys.readouterr().out
