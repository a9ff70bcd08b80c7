"""Port model vs the JAX model on the same weights (fp32, CPU).

The JAX model's params cross to the port through ``params_from_numpy``;
the same seeded numpy tokens go through both, and the logits of
``prefill_bucketed`` and of the decode steps after it agree at atol/rtol
1e-4 (two frameworks' fp32 matmuls and softmaxes sum in different orders).
Port twins of the serving laws of tests/test_decode_equivalence.py close
the file: prefill + decode == forward, and bucketed == exact prefill."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.kvcache import grow_cache as jax_grow_cache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.kvcache import grow_cache  # noqa: E402

TOL = 1e-4
LAW_TOL = 5e-4  # tests/test_decode_equivalence.py's TOL


def micro(cfg):
    """benchmarks/serving.py's llama3-8b-micro (serving-overhead regime)."""
    import dataclasses

    return dataclasses.replace(
        cfg.reduced(), name="llama3-8b-micro", d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=32)


CONFIGS = {"reduced": lambda c: c.reduced(), "micro": micro}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(jax model, jax params, port model, port params) on one weight set."""
    jcfg = CONFIGS[request.param](jax_get_config("llama3-8b"))
    cfg = CONFIGS[request.param](get_config("llama3-8b"))
    jm = JaxModel(jcfg, dtype=jnp.float32)
    jp = jm.init(jax.random.key(1))
    tm = Model(cfg, dtype=torch.float32, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


def _ragged(cfg, lens, L, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), L), np.int32)
    for i, s in enumerate(lens):
        toks[i, :s] = rng.integers(0, cfg.vocab_size, s)
    return toks, np.asarray(lens, np.int32)


def test_config_copy_matches_jax():
    a, b = get_config("llama3-8b"), jax_get_config("llama3-8b")
    assert a.__dict__ == b.__dict__
    assert a.reduced().__dict__ == b.reduced().__dict__


def test_params_from_numpy_names_shapes_and_values(pair):
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    assert tp["embed"].shape == tuple(jp["embed"].shape)
    np.testing.assert_array_equal(tp["final_norm"].numpy(),
                                  np.asarray(jp["final_norm"]))
    g = jp["decoder"]["g0"]["l0"]
    for i in range(cfg.n_layers):
        lp = tp["decoder"]["g0"][i]["l0"]
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(lp["attn"][name].numpy(),
                                          np.asarray(g["attn"][name][i]))
        np.testing.assert_array_equal(lp["ffn"]["w_down"].numpy(),
                                      np.asarray(g["ffn"]["w_down"][i]))
    # the port's schema declares exactly the carried-across leaves
    want = jax.tree.map(lambda a: a.shape[1:], jp["decoder"]["g0"])
    got = jax.tree.map(lambda t: tuple(t.shape), tp["decoder"]["g0"][0])
    assert want == got


def test_params_from_numpy_bf16_round_trip_is_bit_exact():
    jcfg = jax_get_config("llama3-8b").reduced()
    jp = JaxModel(jcfg).init(jax.random.key(0))  # bf16 params
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tree, get_config("llama3-8b").reduced(),
                           device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    bits = lambda a: a.view(np.int16)  # noqa: E731
    np.testing.assert_array_equal(tp["embed"].view(torch.int16).numpy(),
                                  bits(tree["embed"]))
    wq = tree["decoder"]["g0"]["l0"]["attn"]["wq"]
    for i in range(jcfg.n_layers):
        np.testing.assert_array_equal(
            tp["decoder"]["g0"][i]["l0"]["attn"]["wq"].view(torch.int16).numpy(),
            bits(wq[i]))


def test_cache_specs_match_jax(pair):
    jm, _, tm, _ = pair
    want = jm.cache_specs(3, 40)["g0"]["l0"]
    got = tm.cache_specs(3, 40)["g0"]
    assert len(got) == tm.cfg.n_layers
    for key in ("k", "v"):
        assert all(blk["l0"][key] == want[key].shape[1:] for blk in got)
    cache = tm.init_cache(3, 40)
    assert cache["g0"][1]["l0"]["v"].shape == want["v"].shape[1:]
    assert not cache["g0"][1]["l0"]["v"].any()


def test_prefill_bucketed_and_decode_match_jax(pair):
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    L, K, W = 32, 3, 48
    toks, lens = _ragged(cfg, [5, 17, 32, 9], L, seed=3)
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


def test_prefill_decode_matches_forward(pair):
    """Port twin of tests/test_decode_equivalence.py:20."""
    _, _, tm, tp = pair
    B, S, K = 2, 16, 4
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(
        rng.integers(0, tm.cfg.vocab_size, (B, S + K)).astype(np.int32))
    full, _ = tm.forward(tp, toks)
    lg, caches, lengths = tm.prefill(tp, toks[:, :S])
    caches = grow_cache(caches, S + K)
    errs = [float((lg - full[:, S - 1]).abs().max())]
    for k in range(K):
        lg, caches, lengths = tm.decode_step(tp, caches, toks[:, S + k:S + k + 1],
                                             lengths)
        errs.append(float((lg - full[:, S + k]).abs().max()))
    assert max(errs) < LAW_TOL, errs


def test_bucketed_prefill_matches_exact(pair):
    """Port twin of tests/test_decode_equivalence.py:51."""
    _, _, tm, tp = pair
    toks, lens = _ragged(tm.cfg, [5, 17, 32, 9], 32, seed=3)
    lg_b, _, lens_b = tm.prefill_bucketed(tp, torch.from_numpy(toks),
                                          torch.from_numpy(lens))
    assert lens_b.tolist() == lens.tolist()
    for i, s in enumerate(lens):
        lg_e, _, _ = tm.prefill(tp, torch.from_numpy(toks[i:i + 1, :s]))
        assert float((lg_b[i] - lg_e[0]).abs().max()) < LAW_TOL


def test_cpu_prefill_counts_no_kernel_launch(pair):
    """The model calls the kernel wrappers; on CPU tensors they run the
    plain versions and count no launch."""
    _, _, tm, tp = pair
    ops.reset_launches()
    tm.prefill(tp, torch.zeros((1, 8), dtype=torch.int32))
    assert sum(ops.LAUNCHES.values()) == 0


@pytest.mark.parametrize("change", [
    {"family": "ssm"},
    {"moe": "moe"},
    {"mla": "mla"},
])
def test_unported_layer_kinds_raise(change):
    import dataclasses

    from repro_torch.configs.base import MLAConfig, MoEConfig

    kinds = {"moe": MoEConfig(n_experts=4, top_k=2, d_ff=64), "mla": MLAConfig()}
    change = {k: kinds.get(v, v) for k, v in change.items()}
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), **change)
    with pytest.raises(NotImplementedError, match="slice"):
        Model(cfg, device="cpu")
