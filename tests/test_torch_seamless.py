"""The port's encoder-decoder (seamless-m4t-large-v2) against the JAX package
(fp32, CPU, the same numpy inputs and the same weights).

The JAX package drives this model through its ``Model`` API alone (no
serving engine takes it), and so does the port:

* the config copy equals JAX's, field for field and in its parameter count;
* the schema, JAX's weights carried across bit for bit (the encoder's
  scanned group split into per-layer entries), and the cache specs with
  the static cross leaves (``seq_len // 8`` encoder rows);
* the forward, prefill and decode logits at 1e-4 of JAX's, and prefill +
  decode == forward;
* the cross leaves are static: grow, slice and the bytes a request leave
  them whole;
* the serving engine refuses an encoder-decoder, as the JAX engine has no
  path for one.

The logit comparisons run on weights drawn by the port's init rule (each
layer's fan-in) and stacked for JAX: JAX's init of a scanned group takes the
layer count as the fan-in (1/sqrt(2) here, not 1/sqrt(256)), which makes the
reduced model's attention scores so sharp that fp32 reassociation alone
parts the two sides by up to 1e-3 of logits near 1.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import kvcache as jkvc  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import FRONTEND_DIM, Model  # noqa: E402
from repro_torch.models import kvcache as kvc  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.schema import tree_map  # noqa: E402
from repro_torch.serving import DisaggregatedEngine, ServingEngine  # noqa: E402

ARCH = "seamless-m4t-large-v2"
TOL = 1e-4  # model logits, fp32
LAW_TOL = 5e-4  # prefill + decode == forward (tests/test_decode_equivalence)
B, F, S, K = 2, 12, 6, 4  # utterances, frames, target prompt, decode steps

_PAIR: list = []


def _to_jax(tree):
    """The port's tree in JAX's layout: a list of per-layer entries (a
    scanned group; the encoder's always) stacked along a leading axis, a
    one-entry decoder group unstacked."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        if len(tree) == 1:
            return _to_jax(tree[0])
        return jax.tree.map(lambda *a: jnp.stack(a),
                            *[_to_jax(t) for t in tree])
    return jnp.asarray(tree.numpy())


def _pair():
    """(jax model, jax params, port model, port params), once a module:
    the port's seeded init, the same values in JAX's layout."""
    if not _PAIR:
        cfg = get_config(ARCH).reduced()
        tm = Model(cfg, dtype=torch.float32, device="cpu")
        tp = tm.init(torch.Generator().manual_seed(0))
        jm = JaxModel(jax_get_config(ARCH).reduced(), dtype=jnp.float32)
        _PAIR.extend((jm, _to_jax(tp), tm, tp))
    return _PAIR


def _inputs(seed, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, get_config(ARCH).reduced().vocab_size, (B, s),
                        dtype=np.int32)
    feats = rng.normal(size=(B, F, FRONTEND_DIM)).astype(np.float32)
    return toks, feats


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=tol)


def test_config_copy_matches_jax():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.is_encdec and cfg.encoder_layers == 24
    assert cfg.param_count() == jcfg.param_count() == 2_034_783_232
    assert Model(cfg, device="cpu").attention_only


def test_jax_weights_cross_bit_for_bit():
    """JAX's own init (its encoder a scanned group of 2) carried into the
    port: every leaf equal, the encoder's split into per-layer entries."""
    jm = JaxModel(jax_get_config(ARCH).reduced(), dtype=jnp.bfloat16)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(3)))
    cfg = get_config(ARCH).reduced()
    tp = params_from_numpy(jp, cfg, device="cpu")
    assert set(tp) == set(jp) == {"embed", "final_norm", "decoder",
                                  "encoder", "enc_norm", "frontend_proj"}
    assert len(tp["encoder"]["g0"]) == cfg.encoder_layers
    for i, layer in enumerate(tp["encoder"]["g0"]):
        for name, leaf in layer["attn"].items():
            want = jp["encoder"]["g0"]["attn"][name][i]
            assert torch.equal(leaf.view(torch.int16),
                               torch.from_numpy(want.view(np.int16).copy()))
    blk = tp["decoder"]["g0"][1]
    assert set(blk["l0"]) == {"ln1", "attn", "ln_x", "xattn", "ln2", "ffn"}
    want = jp["decoder"]["g0"]["l0"]["xattn"]["wk"][1]
    assert torch.equal(blk["l0"]["xattn"]["wk"].view(torch.int16),
                       torch.from_numpy(want.view(np.int16).copy()))
    # the port's schema is JAX's, leaf for leaf
    shapes = tree_map(lambda t: tuple(t.shape),
                      Model(cfg, device="cpu").init(torch.Generator()))
    assert shapes == tree_map(lambda t: tuple(t.shape), tp)


def test_cache_specs_match_jax():
    jm, _, tm, _ = _pair()
    got = tm.cache_specs(2, 128)["g0"][0]["l0"]
    want = jm.cache_specs(2, 128)["g0"]["l0"]
    assert set(got) == set(want) == {"k", "v", "xk", "xv"}
    for k in got:
        assert got[k] == want[k].shape[1:], k  # JAX stacks the group
    assert got["xk"] == (2, 128 // 8, tm.cfg.n_kv_heads, tm.cfg.head_dim)


def test_forward_prefill_and_decode_match_jax():
    jm, jp, tm, tp = _pair()
    toks, feats = _inputs(1, S + K)
    jb = {"tokens": jnp.asarray(toks), "features": jnp.asarray(feats)}
    full, aux, _ = tm.forward(tp, torch.from_numpy(toks),
                              torch.from_numpy(feats))
    jfull, _, _ = jm.forward(jp, jb)
    assert tuple(full.shape[:2]) == (B, S + K) and float(aux) == 0.0
    _close(full, jfull)
    pre = {"tokens": jnp.asarray(toks[:, :S]), "features": jb["features"]}
    last, caches, lengths = tm.prefill(tp, torch.from_numpy(toks[:, :S]),
                                       torch.from_numpy(feats))
    jlast, jc, jlens = jm.prefill(jp, pre)
    assert lengths.tolist() == np.asarray(jlens).tolist() == [S] * B
    _close(last, jlast)
    leaf = caches["g0"][0]["l0"]
    assert tuple(leaf["xk"].shape) == (B, F, tm.cfg.n_kv_heads,
                                       tm.cfg.head_dim)
    np.testing.assert_allclose(leaf["xv"].numpy(),
                               np.asarray(jc["g0"]["l0"]["xv"][0]), rtol=0,
                               atol=TOL)
    caches, jc = kvc.grow_cache(caches, S + K), jkvc.grow_cache(jc, S + K)
    for t in range(S, S + K):
        step = toks[:, t:t + 1]
        lg, caches, lengths = tm.decode_step(tp, caches,
                                             torch.from_numpy(step), lengths)
        jlg, jc, jlens = jm.decode_step(jp, jc, jnp.asarray(step), jlens)
        _close(lg, jlg)
        _close(lg, full[:, t].numpy(), LAW_TOL)  # prefill + decode == forward


def test_cross_leaves_are_static():
    """grow_cache pads only the self-attention ring; slice_cache and the
    bytes a request keep every encoder row."""
    _, _, tm, tp = _pair()
    toks, feats = _inputs(2)
    _, caches, _ = tm.prefill(tp, torch.from_numpy(toks),
                              torch.from_numpy(feats))
    grown = kvc.grow_cache(caches, 32)
    leaf = grown["g0"][0]["l0"]
    assert leaf["k"].shape[1] == 32 and leaf["xk"].shape[1] == F
    cut = kvc.slice_cache(grown, 1, 4)["g0"][0]["l0"]
    assert cut["k"].shape[:2] == (1, 4) and cut["xv"].shape[:2] == (1, F)
    hd, hk = tm.cfg.head_dim, tm.cfg.n_kv_heads
    per_layer = 2 * hk * hd * 4 * (3 + F)  # fp32 k/v of 3 tokens + cross
    assert kvc.request_cache_nbytes(grown, 3) == \
        tm.cfg.n_layers * per_layer


def test_padded_prefills_refuse_an_encoder_decoder():
    _, _, tm, tp = _pair()
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="encoder-decoder"):
        tm.prefill_bucketed(tp, toks, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="encoder"):
        tm.prefill(tp, toks)  # no features for the encoder


@pytest.mark.parametrize("engine", [ServingEngine, DisaggregatedEngine])
def test_serving_engine_refuses_an_encoder_decoder(engine):
    _, _, tm, tp = _pair()
    with pytest.raises(ValueError, match="encoder-decoder"):
        engine(tm, tp, max_batch=2, max_seq=64, device="cpu")
