"""The port's hybrid attention + SSD + MoE stack (jamba-v0.1-52b) against the
JAX package (fp32, CPU, the same numpy inputs and converted weights).

The reduced hybrid keeps four layers in one period of jamba's interleave
(``attn_every=4, attn_offset=3``): SSM + dense, SSM + MoE, SSM + dense,
attention + MoE, so every layer kind jamba has is in it.

* the config copy equals JAX's, field for field and in its parameter count
  (the 8-layer cut the card runs too); the layer groups and cache specs;
* prefill and decode logits against JAX's at 1e-4, with tokens dropped
  (the default capacity factor) and without; prefill + decode == forward
  without drops;
* the engine on every path JAX allows a hybrid stack (the exact-shape
  admission, legacy, warmed, the tier under all three mechanisms): tokens
  and counters equal the JAX engine's on the same path, with and without
  drops, the tier's wire bytes too; the pipeline and the in-process
  cluster give JAX's tokens; paged raises, packed and chunked turn off;
* the handoff's payload at jamba's published widths: 4,096 bytes a token
  for the attention layer, 573,632 bytes a request for each SSM layer;
* the launcher serves it.

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
from repro.models.transformer import layer_groups as jax_groups  # noqa: E402
from repro.serving import DisaggregatedEngine as JaxDisagg  # noqa: E402
from repro.serving import ServingCluster as JaxCluster  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.engine import EnginePipeline as JaxPipeline  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import transfer as xfer  # noqa: E402
from repro_torch.core.transfer import TransferMode  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import kvcache as kvc  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import layer_groups  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DisaggregatedEngine,
    EnginePipeline,
    Request,
    ServingCluster,
    ServingEngine,
)

ARCH = "jamba-v0.1-52b"
TOL = 1e-4  # model logits, fp32
LAW_TOL = 5e-4  # prefill + decode == forward (tests/test_decode_equivalence)
GAP_TOL = 1e-4
LENS = [5, 17, 33]
NEW = 4
KW = dict(max_batch=2, max_seq=64)
PATHS = {"exact": {}, "legacy": dict(legacy=True),
         "warmed": dict(warmup=True)}
MODES = [m.value for m in TransferMode]
COUNTERS = ("prefill_padded_tokens", "prefill_tokens_total",
            "prefill_tokens_uncached", "decode_steps", "useful_steps")
TIER_COUNTERS = ("handoffs", "handoff_wire_bytes", "handoff_request_bytes")


def _hybrid(cfg, drop=True):
    """The reduced config cut to one 4-layer period of the interleave."""
    cfg = dataclasses.replace(cfg.reduced(), n_layers=4, attn_every=4,
                              attn_offset=3)
    return cfg if drop else nodrop(cfg)


_PAIRS: dict = {}
_RUNS: dict = {}


def _pair(drop=True):
    """(jax model, jax params, port model, port params), once a module."""
    if drop not in _PAIRS:
        jm = JaxModel(_hybrid(jax_get_config(ARCH), drop), dtype=jnp.float32)
        jp = jm.init(jax.random.key(1))
        cfg = _hybrid(get_config(ARCH), drop)
        tm = Model(cfg, dtype=torch.float32, device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
        _PAIRS[drop] = (jm, jp, tm, tp)
    return _PAIRS[drop]


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


# --------------------------------------------------------------------------- #
# Config, groups and caches
# --------------------------------------------------------------------------- #
def test_config_copy_matches_jax():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    # the card's cut: one period of the interleave at published widths,
    # 1 attention + MoE, 3 SSM + MoE and 4 SSM + dense layers
    cut = dataclasses.replace(cfg, n_layers=8)
    assert cut.param_count() == 13_267_540_608
    assert [(cut.layer_kind(i), cut.layer_is_moe(i)) for i in range(8)] == [
        ("ssm", False), ("ssm", True), ("ssm", False), ("attn", True),
        ("ssm", False), ("ssm", True), ("ssm", False), ("ssm", True)]


@pytest.mark.parametrize("n_layers", [4, 8, 32])
def test_layer_groups_and_cache_specs_match_jax(n_layers):
    cfg = dataclasses.replace(get_config(ARCH), n_layers=n_layers)
    jcfg = dataclasses.replace(jax_get_config(ARCH), n_layers=n_layers)
    assert [(g.sigs, g.count) for g in layer_groups(cfg)] == \
        [(g.sigs, g.count) for g in jax_groups(jcfg)]
    tm = Model(cfg, device="cpu")
    jspecs = JaxModel(jcfg).cache_specs(2, 128)
    for gi, g in enumerate(tm.groups):
        for j, sig in enumerate(g.sigs):
            want = jspecs[f"g{gi}"][f"l{j}"]
            for i, block in enumerate(tm.cache_specs(2, 128)[f"g{gi}"]):
                got = block[f"l{j}"]
                assert set(got) == set(want)
                for k, shape in got.items():
                    w = want[k].shape
                    assert shape == (w[1:] if g.count > 1 else w), (k, i)


def test_handoff_payload_at_published_widths():
    """The attention layer's KV is 8 kv heads x 128 x 2 x bf16 = 4,096
    bytes a token; each SSM layer carries a fixed 573,632 bytes a request
    (its fp32 [128, 64, 16] state, 524,288, and its bf16 [3, 8224] conv
    window, 49,344), whatever the prompt's length."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=8)
    tm = Model(cfg, device="cpu")
    tree = {g: [{name: kvc.init_layer_cache(shapes, tm.dtype, "meta")
                 for name, shapes in block.items()} for block in group]
            for g, group in tm.cache_specs(1, 2048).items()}
    per_token, per_request = 4096, 7 * 573_632
    for n in (1, 64, 1024):
        assert kvc.request_cache_nbytes(tree, n) == n * per_token + per_request
    # phase 4's traffic: 12 prompts of 8,269 tokens in all
    assert 8269 * per_token == 33_869_824
    assert 12 * per_request == 48_185_088
    assert kvc.request_cache_nbytes(
        tree, 10, itemsize=lambda t: xfer.wire_itemsize(
            t.dtype, TransferMode.HOST_STAGED)) == 10 * 2048 + 7 * (
        524_288 // 4 + 49_344 // 2)


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("drop", [True, False])
def test_logits_prefill_and_decode_match_jax(drop):
    """A prefill of 16 tokens and 4 decode steps."""
    jm, jp, tm, tp = _pair(drop)
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (2, 20),
                                             dtype=np.int32)
    last, caches, lengths = tm.prefill(tp, torch.from_numpy(toks[:, :16]))
    jlast, jc, jlens = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :16])})
    _close(last, jlast)
    caches, jc = kvc.grow_cache(caches, 32), jkvc.grow_cache(jc, 32)
    for t in range(16, 20):
        lg, caches, lengths = tm.decode_step(
            tp, caches, torch.from_numpy(toks[:, t:t + 1]), lengths)
        jlg, jc, jlens = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                        jlens)
        _close(lg, jlg)
    assert lengths.tolist() == np.asarray(jlens).tolist()


def test_prefill_plus_decode_equals_forward():
    """tests/test_decode_equivalence.py's law on the port (nothing
    dropped): the SSM layers' state and conv window and the attention
    layer's ring carry a prefill into decode exactly."""
    _, _, tm, tp = _pair(drop=False)
    B, S, K = 2, 16, 4
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (B, S + K), dtype=np.int32))
    full, aux, _ = tm.forward(tp, toks)
    assert float(aux) > 0.0  # the MoE layers' load-balance loss
    lg, caches, lengths = tm.prefill(tp, toks[:, :S])
    caches = kvc.grow_cache(caches, S + K)
    errs = [float((lg - full[:, S - 1]).abs().max())]
    for k in range(K):
        lg, caches, lengths = tm.decode_step(tp, caches,
                                             toks[:, S + k:S + k + 1], lengths)
        errs.append(float((lg - full[:, S + k]).abs().max()))
    assert max(errs) < LAW_TOL, errs


def test_padded_prefills_raise():
    """Right-padding would push pad tokens into the SSM layers' state."""
    _, _, tm, tp = _pair()
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="exact-shape"):
        tm.prefill_bucketed(tp, toks, torch.ones(1, dtype=torch.int32))


# --------------------------------------------------------------------------- #
# The engine, path by path, against the JAX engine on the same path
# --------------------------------------------------------------------------- #
def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, s, dtype=np.int32) for s in lens]


def _drain(front, req_cls, prompts, max_new=NEW):
    reqs = [req_cls(prompt_tokens=p.copy(), max_new_tokens=max_new)
            for p in prompts]
    for r in reqs:
        front.submit(r, time.perf_counter())
    out = front.run_until_drained(max_steps=100_000)
    assert len(out) == len(reqs)
    return [list(r.generated) for r in reqs]


def _run(side, path, drop):
    key = (side, path, drop)
    if key not in _RUNS:
        jm, jp, tm, tp = _pair(drop)
        prompts = _prompts(tm.cfg.vocab_size)
        if path in MODES:
            eng = (JaxDisagg(jm, jp, transfer_mode=JaxMode(path), **KW)
                   if side == "jax" else
                   DisaggregatedEngine(tm, tp, device="cpu", **KW,
                                       transfer_mode=TransferMode(path)))
        else:
            eng = (JaxEngine(jm, jp, **KW, **PATHS[path]) if side == "jax"
                   else ServingEngine(tm, tp, device="cpu", **KW,
                                      **PATHS[path]))
        toks = _drain(eng, JaxRequest if side == "jax" else Request, prompts)
        _RUNS[key] = (toks, eng, prompts)
    return _RUNS[key]


def _same_tokens(got, want, prompts, drop):
    jm, jp, _, _ = _pair(drop)
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = np.concatenate([prompts[i], np.asarray(b[:k], np.int32)])
        logits, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(ctx)[None]})
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        assert top2[1] - top2[0] < GAP_TOL, (i, k, a, b)


ENGINE_CASES = ([(p, True) for p in [*PATHS, *MODES]]
                + [(p, False) for p in ("exact", "legacy", "direct_dma")])


@pytest.mark.parametrize("path,drop", ENGINE_CASES)
def test_engine_path_matches_jax_same_path(path, drop):
    toks, eng, prompts = _run("port", path, drop)
    jtoks, jeng, _ = _run("jax", path, drop)
    assert eng.exact_prefill
    if path == "host_staged":  # int8 payload: the first tokens from prefill
        assert [t[0] for t in toks] == [t[0] for t in jtoks]
    else:
        _same_tokens(toks, jtoks, prompts, drop)
    assert all(len(t) == NEW for t in toks)
    if path != "legacy":  # the legacy loop counts neither, as in JAX
        # one exact-shape prefill a request, no padding
        assert eng.prefill_calls == len(prompts)
        assert eng.prefill_padded_tokens == sum(LENS)
    for c in COUNTERS + (TIER_COUNTERS if path in MODES else ()):
        assert getattr(eng, c) == getattr(jeng, c), c


def test_paths_agree_without_drops():
    """Without drops the legacy loop and the direct tier give the exact
    path's tokens: the hop carries the attention layer's prefix and the
    SSM layers' whole state rows unchanged."""
    base = _run("port", "exact", False)[0]
    for path in ("legacy", "direct_dma"):
        assert _run("port", path, False)[0] == base, path


def test_gates_as_in_jax():
    """paged raises as JAX's does; packed and chunked prefill turn off
    silently (the exact-shape admission)."""
    jm, jp, tm, tp = _pair()
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(tm, tp, device="cpu", paged=True, **KW)
    with pytest.raises(ValueError, match="paged"):
        JaxEngine(jm, jp, paged=True, **KW)
    eng = ServingEngine(tm, tp, device="cpu", packed=True, prefill_chunk=16,
                        **KW)
    jeng = JaxEngine(jm, jp, packed=True, prefill_chunk=16, **KW)
    assert eng.exact_prefill and not eng.packed and not eng._chunk_enabled
    prompts = _prompts(tm.cfg.vocab_size, [9, 40])
    assert _drain(eng, Request, prompts) == _drain(jeng, JaxRequest, prompts)
    assert eng.prefill_padded_tokens == jeng.prefill_padded_tokens == 49


def test_pipeline_matches_jax_pipeline():
    jm, jp, tm, tp = _pair()
    prompts = _prompts(tm.cfg.vocab_size)
    with EnginePipeline(ServingEngine(tm, tp, device="cpu", **KW)) as pipe:
        got = _drain(pipe, Request, prompts)
    with JaxPipeline(JaxEngine(jm, jp, **KW)) as jpipe:
        want = _drain(jpipe, JaxRequest, prompts)
    assert got == want == _run("port", "exact", True)[0]


@pytest.mark.parametrize("engine", ["fused", "disagg"])
def test_in_process_cluster_matches_jax(engine):
    jm, jp, tm, tp = _pair()
    prompts = _prompts(tm.cfg.vocab_size)
    cl = ServingCluster.build(tm, tp, n_replicas=2, engine=engine,
                              policy="round_robin", device="cpu", **KW)
    jcl = JaxCluster.build(jm, jp, n_replicas=2, engine=engine,
                           policy="round_robin", **KW)
    got = _drain(cl, Request, prompts)
    want = _drain(jcl, JaxRequest, prompts)
    assert got == want
    assert [r.routed for r in cl.replicas] == [r.routed for r in jcl.replicas]


def test_launcher_serves_jamba_on_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--clients", "2", "--requests", "1",
                      "--prompt-len", "4:24", "--new-tokens", "3"])
    assert len(out["responses"]) == 2
    assert all(len(r.tokens) == 3 for r in out["responses"])
    assert out["engine"].exact_prefill
    assert f"{ARCH}-reduced (2 layers)" in capsys.readouterr().out
