"""The rest of the dense family on the port: starcoder2-3b (GQA, kv 2),
qwen3-32b (qk-norm), granite-34b (MQA) and a sliding-window ring, held
against the JAX package on the same weights (fp32, CPU).

The three configurations are field-for-field copies of the JAX ones. On
their reduced forms the port's ``prefill_bucketed`` and 3 decode steps give
JAX's logits at atol/rtol 1e-4 (two frameworks' fp32 matmuls and softmaxes
sum in different orders). Port twins of tests/test_decode_equivalence.py
close the file, at its tolerance 5e-4: prefill + decode == forward (all
three), bucketed == exact (llama3-8b and qwen3-32b), and a W-slot ring ==
sliding-window attention (llama3-8b reduced with ``sliding_window=8``,
decoded past the window)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.kvcache import grow_cache as jax_grow_cache  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.kvcache import grow_cache  # noqa: E402

TOL = 1e-4
LAW_TOL = 5e-4  # tests/test_decode_equivalence.py's TOL
DENSE = ("starcoder2-3b", "qwen3-32b", "granite-34b")

_PAIRS: dict = {}


def _pair(name, window=0):
    """(jax model, jax params, port model, port params) for a reduced
    configuration, one weight set, cached for the module."""
    key = (name, window)
    if key not in _PAIRS:
        jcfg = jax_get_config(name).reduced()
        cfg = get_config(name).reduced()
        if window:
            jcfg = dataclasses.replace(jcfg, sliding_window=window)
            cfg = dataclasses.replace(cfg, sliding_window=window)
        jm = JaxModel(jcfg, dtype=jnp.float32)
        jp = jm.init(jax.random.key(1))
        tm = Model(cfg, dtype=torch.float32, device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
        _PAIRS[key] = (jm, jp, tm, tp)
    return _PAIRS[key]


def _ragged(vocab, lens, L, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), L), np.int32)
    for i, s in enumerate(lens):
        toks[i, :s] = rng.integers(0, vocab, s)
    return toks, np.asarray(lens, np.int32)


@pytest.mark.parametrize("name", DENSE)
def test_config_copy_matches_jax(name):
    a, b = get_config(name), jax_get_config(name)
    assert a.__dict__ == b.__dict__
    assert a.reduced().__dict__ == b.reduced().__dict__
    assert name in ARCHITECTURES


def test_family_features_reach_the_port():
    """What each configuration exercises: qk-norm weights (qwen3), one KV
    head (granite), two (starcoder2)."""
    _, _, tm, tp = _pair("qwen3-32b")
    lp = tp["decoder"]["g0"][0]["l0"]["attn"]
    assert lp["q_norm"].shape == lp["k_norm"].shape == (tm.cfg.head_dim,)
    assert _pair("granite-34b")[2].cfg.n_kv_heads == 1
    assert _pair("starcoder2-3b")[2].cfg.n_kv_heads == 2


@pytest.mark.parametrize("name", DENSE)
def test_prefill_bucketed_and_decode_match_jax(name):
    jm, jp, tm, tp = _pair(name)
    cfg = tm.cfg
    L, K, W = 32, 3, 48
    toks, lens = _ragged(cfg.vocab_size, [5, 17, 32, 9], L, seed=3)
    jl, jc, jlen = jm.prefill_bucketed(jp, {"tokens": jnp.asarray(toks)},
                                       jnp.asarray(lens))
    tl, tc, tlen = tm.prefill_bucketed(tp, torch.from_numpy(toks),
                                       torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    jc, tc = jax_grow_cache(jc, W), grow_cache(tc, W)
    rng = np.random.default_rng(4)
    for _ in range(K):
        nxt = rng.integers(0, cfg.vocab_size, (len(lens), 1)).astype(np.int32)
        jl, jc, jlen = jm.decode_step(jp, jc, jnp.asarray(nxt), jlen)
        tl, tc, tlen = tm.decode_step(tp, tc, torch.from_numpy(nxt), tlen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


@pytest.mark.parametrize("name", DENSE)
def test_prefill_decode_matches_forward(name):
    """Port twin of tests/test_decode_equivalence.py:20."""
    _, _, tm, tp = _pair(name)
    B, S, K = 2, 16, 4
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(
        rng.integers(0, tm.cfg.vocab_size, (B, S + K)).astype(np.int32))
    full, _, _ = tm.forward(tp, toks)
    lg, caches, lengths = tm.prefill(tp, toks[:, :S])
    caches = grow_cache(caches, S + K)
    errs = [float((lg - full[:, S - 1]).abs().max())]
    for k in range(K):
        lg, caches, lengths = tm.decode_step(tp, caches,
                                             toks[:, S + k:S + k + 1], lengths)
        errs.append(float((lg - full[:, S + k]).abs().max()))
    assert max(errs) < LAW_TOL, errs


@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-32b"])
def test_bucketed_prefill_matches_exact(name):
    """Port twin of tests/test_decode_equivalence.py:51."""
    _, _, tm, tp = _pair(name)
    toks, lens = _ragged(tm.cfg.vocab_size, [5, 17, 32, 9], 32, seed=3)
    lg_b, _, lens_b = tm.prefill_bucketed(tp, torch.from_numpy(toks),
                                          torch.from_numpy(lens))
    assert lens_b.tolist() == lens.tolist()
    for i, s in enumerate(lens):
        lg_e, _, _ = tm.prefill(tp, torch.from_numpy(toks[i:i + 1, :s]))
        err = float((lg_b[i] - lg_e[0]).abs().max())
        assert err < LAW_TOL, f"row {i} (len {s}): {err:.2e}"


def test_ring_buffer_sliding_window_equivalence():
    """Port twin of tests/test_decode_equivalence.py:76: token-by-token
    decode through a W-slot ring (W = the window, 8) equals windowed
    attention over the whole sequence at every steady-state position, on
    the port's forward and on JAX's."""
    jm, jp, tm, tp = _pair("llama3-8b", window=8)
    W = tm.cfg.sliding_window
    B, S = 1, 24
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    full, _, _ = tm.forward(tp, torch.from_numpy(toks))
    jfull, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=TOL,
                               rtol=TOL)
    caches = tm.init_cache(B, W)
    assert caches["g0"][0]["l0"]["k"].shape[1] == W
    lengths = torch.zeros((B,), dtype=torch.int32)
    outs = []
    for t in range(S):
        lg, caches, lengths = tm.decode_step(
            tp, caches, torch.from_numpy(toks[:, t:t + 1]), lengths)
        outs.append(lg)
    for t in range(W, S):  # steady-state ring positions only
        err = float((outs[t] - full[:, t]).abs().max())
        assert err < LAW_TOL, f"pos {t}: {err:.2e}"
