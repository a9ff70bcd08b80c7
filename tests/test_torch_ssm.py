"""The port's Mamba-2 path against the JAX package on the same inputs (CPU).

The plain SSD version is held against the JAX Pallas kernel in interpret
mode and against the sequential JAX oracle at tests/test_kernels.py's SSD
tolerances; the Mamba-2 block, the model and the serving engine on a reduced
mamba2-130m (d_model 256, d_state 16, head_dim 32, chunk 32, fp32) against
their JAX twins on the same weights, carried across with
``params_from_numpy``. Seeded numpy makes every input."""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.mamba import mamba_forward as jax_mamba_forward  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import kvcache as kvc  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.mamba import mamba_forward  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

TOL = 1e-4  # two frameworks' fp32 sums in different orders
LAW_TOL = 5e-4  # tests/test_decode_equivalence.py's TOL
ARCH = "mamba2-130m"
SSM_LEAVES = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
              "gate_norm", "out_proj")


def _ssd_inputs(b, S, nh, hd, ds, seed, dtype=np.float32):
    """test_kernels.py's SSD inputs: x, B, C normal; dt in [0.01, ...);
    A negative."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, S, nh, hd)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, S, nh))) * 0.1 + 0.01).astype(np.float32)
    A = (-np.abs(rng.normal(size=(nh,))) - 0.1).astype(np.float32)
    B = rng.normal(size=(b, S, 1, ds)).astype(np.float32)
    C = rng.normal(size=(b, S, 1, ds)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,S,nh,hd,ds,chunk", [
    (1, 64, 2, 32, 16, 16),
    (2, 96, 4, 32, 16, 32),
    (1, 128, 1, 64, 64, 64),
    (2, 100, 3, 16, 8, 32),  # ragged: zero-padded to a chunk multiple
    (1, 80, 16, 64, 16, 32),  # jamba's SSD widths (hd 64, ds 16), 16 heads
])
def test_ssd_plain_matches_jax_kernel_and_oracle(dtype, b, S, nh, hd, ds,
                                                  chunk):
    x, dt, A, B, C = _ssd_inputs(b, S, nh, hd, ds, seed=S + nh)
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jx, jd, jB, jC = (jnp.asarray(a, jdt) for a in (x, dt, B, C))
    jA = jnp.asarray(A)
    yk, stk = jax_ops.ssd_scan(jx, jd, jA, jB, jC, chunk=chunk, interpret=True)
    yo, sto = jax_ref.ssd_scan_ref(jx, jd, jA, jB, jC)
    tx, td, tB, tC = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                      .to(tdt) for a in (jx, jd, jB, jC))
    y, st = ref.ssd_scan_ref(tx, td, torch.from_numpy(A), tB, tC, chunk)
    assert y.dtype == tdt and st.dtype == torch.float32
    atol = 3e-5 if dtype == "fp32" else 5e-2
    for want_y, want_st in ((yk, stk), (yo, sto)):
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want_y.astype(jnp.float32)),
                                   atol=atol, rtol=2e-2)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st),
                                   atol=atol, rtol=2e-2)


def test_ssd_plain_is_chunk_invariant():
    """S = 77 in one chunk of min(32, S) per 32 positions vs chunks of 16:
    the same y and state up to rounding (tests/test_properties.py's law)."""
    x, dt, A, B, C = (torch.from_numpy(a)
                      for a in _ssd_inputs(1, 77, 2, 8, 4, seed=5))
    y1, s1 = ref.ssd_scan_ref(x, dt, A, B, C, 32)
    y2, s2 = ref.ssd_scan_ref(x, dt, A, B, C, 16)
    y3, s3 = ref.ssd_scan_ref(x, dt, A, B, C, 256)  # one chunk of 77
    for y, s in ((y2, s2), (y3, s3)):
        torch.testing.assert_close(y, y1, atol=1e-4, rtol=1e-3)
        torch.testing.assert_close(s, s1, atol=1e-4, rtol=1e-3)


def test_ssd_op_takes_the_plain_version_on_cpu():
    x, dt, A, B, C = (torch.from_numpy(a)
                      for a in _ssd_inputs(1, 40, 2, 16, 8, seed=6))
    ops.reset_launches()
    y, s = ops.ssd_scan(x, dt, A, B, C, chunk=32)
    want = ref.ssd_scan_ref(x, dt, A, B, C, 32)
    assert torch.equal(y, want[0]) and torch.equal(s, want[1])
    assert ops.LAUNCHES["ssd_scan"] == 0
    with pytest.raises(ValueError, match="ssd_scan"):
        ops.ssd_scan(x, dt[:, :-1], A, B, C, chunk=32)


# --------------------------------------------------------------------------- #
# the reduced mamba2-130m on the same weights
# --------------------------------------------------------------------------- #
def _perturbed(tree, seed):
    """The JAX init leaves A_log, dt_bias, conv_b at zero and D, gate_norm
    at one; give every SSM layer random ones so the test sees them. It also
    draws a stacked group's matrices with the layer count as their fan-in;
    redraw them at N(0, 1/fan_in) of one layer (the port's rule), so the
    block's activations sit at the model's scale."""
    rng = np.random.default_rng(seed)
    ssm = tree["decoder"]["g0"]["l0"]["ssm"]
    for name in ("in_proj", "conv_w", "out_proj"):
        a = ssm[name]  # [layers, fan_in, ...]
        ssm[name] = (rng.normal(size=a.shape) / np.sqrt(a.shape[1])).astype(
            a.dtype)
    for name, scale, shift in (("A_log", 0.5, 0.0), ("dt_bias", 0.5, 0.0),
                               ("conv_b", 0.1, 0.0), ("D", 0.5, 1.0),
                               ("gate_norm", 0.1, 1.0)):
        a = ssm[name]
        ssm[name] = (rng.normal(size=a.shape) * scale + shift).astype(a.dtype)
    return tree


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params, numpy tree) of the
    reduced mamba2-130m on one fp32 weight set."""
    jm = JaxModel(jax_get_config(ARCH).reduced(), dtype=jnp.float32)
    tree = _perturbed(jax.tree.map(np.asarray, jm.init(jax.random.key(1))), 2)
    jp = jax.tree.map(jnp.asarray, tree)
    cfg = get_config(ARCH).reduced()
    tm = Model(cfg, dtype=torch.float32, device="cpu")
    tp = params_from_numpy(tree, cfg, device="cpu")
    return jm, jp, tm, tp, tree


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_config_copy_matches_jax():
    a, b = get_config(ARCH), jax_get_config(ARCH)
    asdict = dataclasses.asdict  # the SSMConfig classes differ: compare values
    assert asdict(a) == asdict(b)
    assert asdict(a.reduced()) == asdict(b.reduced())
    r = a.reduced()
    assert (r.d_model, r.ssm.d_state, r.ssm.head_dim, r.ssm.chunk) == (
        256, 16, 32, 32)


def test_ssm_params_cross_bit_for_bit():
    """bf16 JAX params: every SSM leaf of every layer arrives with the same
    bits, the stacked group unstacked, and the port's schema declares
    exactly these leaves (no ln2/ffn in an ssm-family stack)."""
    jcfg = jax_get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.key(0)))
    cfg = get_config(ARCH).reduced()
    tp = params_from_numpy(tree, cfg, device="cpu")
    g = tree["decoder"]["g0"]["l0"]
    assert sorted(g) == ["ln1", "ssm"] and sorted(g["ssm"]) == sorted(SSM_LEAVES)
    for i in range(cfg.n_layers):
        lp = tp["decoder"]["g0"][i]["l0"]
        for name in SSM_LEAVES:
            t = lp["ssm"][name]
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          g["ssm"][name][i].view(np.int16))
    want = jax.tree.map(lambda a: a.shape[1:], tree["decoder"]["g0"])
    got = jax.tree.map(lambda t: tuple(t.shape),
                       Model(cfg, device="cpu").init(
                           torch.Generator().manual_seed(0))["decoder"]["g0"][0])
    assert want == got


def test_cache_specs_and_dtypes_match_jax(pair):
    jm, _, tm, _, _ = pair
    want = jm.cache_specs(3, 40)["g0"]["l0"]  # stacked: [layers, B, ...]
    cache = tm.init_cache(3, 40)
    for i in range(tm.cfg.n_layers):
        leaves = cache["g0"][i]["l0"]
        assert sorted(leaves) == ["conv", "state"]
        for key, spec in want.items():
            assert tuple(leaves[key].shape) == spec.shape[1:]
            assert not leaves[key].any()
    bf = Model(tm.cfg, device="cpu").init_cache(2, 40)["g0"][0]["l0"]
    assert bf["conv"].dtype == torch.bfloat16
    assert bf["state"].dtype == torch.float32  # fp32 whatever the model's
    grown = kvc.grow_cache(cache, 64)
    assert grown["g0"][0]["l0"]["conv"] is cache["g0"][0]["l0"]["conv"]


def test_mamba_block_prefill_and_decode_match_jax(pair):
    """One block: prefill over a ragged length (S = 45, padded to two
    chunks of 32 inside the scan), then decode steps that carry the conv
    window and state; the port writes them into its cache in place."""
    jm, jp, tm, tp, tree = pair
    cfg = tm.cfg
    jl = jax.tree.map(lambda a: a[0], jp["decoder"]["g0"]["l0"]["ssm"])
    tl = tp["decoder"]["g0"][0]["l0"]["ssm"]
    rng = np.random.default_rng(3)
    u = rng.normal(size=(2, 48, cfg.d_model)).astype(np.float32)
    jo, jc = jax_mamba_forward(jl, jm.cfg, jnp.asarray(u[:, :45]))
    to, tc = mamba_forward(tl, cfg, torch.from_numpy(u[:, :45]))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    for key in ("conv", "state"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=TOL, rtol=TOL)
    state = tc["state"]
    for t in range(45, 48):
        jo, jc = jax_mamba_forward(jl, jm.cfg, jnp.asarray(u[:, t:t + 1]),
                                   state=jc["state"], conv_state=jc["conv"],
                                   decode=True)
        to, tc2 = mamba_forward(tl, cfg, torch.from_numpy(u[:, t:t + 1]),
                                cache=tc)
        assert tc2 is tc and tc["state"] is state  # updated in place
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL,
                                   rtol=TOL)
        for key in ("conv", "state"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       atol=TOL, rtol=TOL)


def test_prefill_and_decode_match_jax_model(pair):
    jm, jp, tm, tp, _ = pair
    toks = _tokens(tm.cfg, 2, 41, seed=4)
    jl, jc, jlen = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc, tlen = tm.prefill(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    rng = np.random.default_rng(5)
    for _ in range(4):
        nxt = rng.integers(0, tm.cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc, jlen = jm.decode_step(jp, jc, jnp.asarray(nxt), jlen)
        tl, tc, tlen = tm.decode_step(tp, tc, torch.from_numpy(nxt), tlen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


@pytest.mark.parametrize("S", [3, 40, 70])
def test_prefill_decode_matches_forward(pair, S):
    """Port twin of tests/test_decode_equivalence.py:20 on the SSM stack:
    prefill(S) + k decode steps == forward(S + k), for a prompt shorter
    than the conv window, one inside a chunk and one spanning chunks."""
    _, _, tm, tp, _ = pair
    K = 4
    toks = torch.from_numpy(_tokens(tm.cfg, 2, S + K, seed=S))
    full, _, _ = tm.forward(tp, toks)
    lg, caches, lengths = tm.prefill(tp, toks[:, :S])
    errs = [float((lg - full[:, S - 1]).abs().max())]
    for k in range(K):
        lg, caches, lengths = tm.decode_step(tp, caches,
                                             toks[:, S + k:S + k + 1], lengths)
        errs.append(float((lg - full[:, S + k]).abs().max()))
    assert max(errs) < LAW_TOL, errs


def test_padded_prefills_raise_and_cpu_counts_no_launch(pair):
    _, _, tm, tp, _ = pair
    toks = torch.zeros((2, 16), dtype=torch.int32)
    lens = torch.tensor([5, 16], dtype=torch.int32)
    with pytest.raises(ValueError, match="exact-shape"):
        tm.prefill_bucketed(tp, toks, lens)
    with pytest.raises(ValueError, match="exact-shape"):
        tm.prefill_suffix(tp, toks, lens, lens, torch.zeros((2, 1)), None)
    assert not tm.attention_only
    ops.reset_launches()
    tm.prefill(tp, toks)
    assert sum(ops.LAUNCHES.values()) == 0


# --------------------------------------------------------------------------- #
# serving: the port's engine against the JAX engine
# --------------------------------------------------------------------------- #
LENS = [5, 9, 14, 40, 77]  # below a chunk, a chunk and a ragged tail


def _drain(engine, req_cls, prompts, max_new):
    reqs = [req_cls(prompt_tokens=p, max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        engine.submit(r, time.perf_counter())
    out = engine.run_until_drained()
    assert len(out) == len(reqs)
    return reqs


@pytest.fixture(scope="module")
def drained(pair):
    """Five prompts through two slots: slots are reused, so a recurrent
    state left by a finished request would show in the next one's tokens."""
    jm, jp, tm, tp, _ = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tm.cfg.vocab_size, s, dtype=np.int32)
               for s in LENS]
    jeng = JaxEngine(jm, jp, max_batch=2, max_seq=96, inflight=4)
    teng = ServingEngine(tm, tp, max_batch=2, max_seq=96, inflight=4,
                         device="cpu")
    jreqs = _drain(jeng, JaxRequest, prompts, 5)
    treqs = _drain(teng, Request, prompts, 5)
    return jeng, teng, jreqs, treqs, prompts


def test_engine_tokens_match_jax_engine(drained):
    jeng, teng, jreqs, treqs, _ = drained
    assert not jeng.bucketed_prefill and teng.exact_prefill
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]


def test_engine_counters_match_jax_engine(drained):
    jeng, teng, _, _, _ = drained
    tc, jc = teng.counters(), jeng.counters()
    for key in ("prefill_tokens_total", "prefill_tokens_uncached",
                "prefill_padded_tokens", "prefix_hits", "prefix_hit_tokens",
                "decode_steps", "useful_steps", "requests_finished"):
        assert tc[key] == jc[key], key
    assert tc["prefill_calls"] == len(LENS)  # one exact prefill per request
    assert tc["prefill_padded_tokens"] == sum(LENS)
    assert teng.done_mask.all() and teng.logits_all_finite()


def test_reused_slot_starts_from_the_prompt_alone(pair, drained):
    """Through one slot, every request after the first lands where a
    finished request's conv window and state were (and where the frozen
    lane kept stepping): its tokens must be those it gets alone."""
    _, _, tm, tp, _ = pair
    _, _, _, treqs, prompts = drained
    eng = ServingEngine(tm, tp, max_batch=1, max_seq=96, device="cpu")
    reqs = _drain(eng, Request, prompts[::-1], 5)
    for r, alone in zip(reqs, treqs[::-1]):
        assert r.generated == alone.generated


def test_paged_and_feature_payloads_raise(pair):
    _, _, tm, tp, _ = pair
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(tm, tp, max_batch=2, max_seq=64, paged=True,
                      device="cpu")
    eng = ServingEngine(tm, tp, max_batch=2, max_seq=64, device="cpu")
    req = Request(prompt_tokens=np.zeros(4, np.int32),
                  features=np.zeros((1, 8, 1024), np.float32))
    with pytest.raises(ValueError, match="no frontend"):
        eng.submit(req)


def test_launcher_serves_mamba2_on_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--clients", "2", "--requests", "1",
                      "--prompt-len", "4:40", "--new-tokens", "3"])
    assert len(out["responses"]) == 2
    assert all(len(r.tokens) == 3 for r in out["responses"])
    assert out["engine"].exact_prefill
    assert "mamba2-130m-reduced (2 layers)" in capsys.readouterr().out
