"""The port's MLA (multi-head latent attention) and reduced deepseek-v2-236b
against the JAX package (fp32, CPU, the same numpy inputs and converted
weights).

Bottom-up:

* ``mla_schema`` in both query branches, and bf16 weights carried bit for
  bit;
* ``latent_kv``, ``mla_prefill`` and ``mla_decode_update`` (a fresh and a
  wrapped ring) against JAX's at 1e-5;
* the plain MLA decode (ring and paged) against JAX's ``attend`` plus its
  normalisation, read out of ``mla_decode_update`` through identity
  weights;
* the latent cache's helpers (grow, slice, bytes, pages) on 3-D leaves;
* reduced deepseek-v2 logits against JAX at 1e-4, and prefill + decode ==
  forward at 5e-4 (nothing dropped);
* the engine on every path JAX allows an MLA stack (bucketed, paged
  without reuse, legacy, warmed, the tier under all three mechanisms):
  tokens and counters equal the JAX engine's on the same path, at the
  default capacity factor and without drops; packed and chunked turn off
  silently;
* HOST_STAGED's int8 latent payload equals JAX's ``kv_transfer``.

Greedy tokens are compared exactly; where they part, the JAX model's top-2
logit gap at that token must be under GAP_TOL (a tie, not a fault).
"""

import dataclasses
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import nodrop  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import transfer as jxfer  # noqa: E402
from repro.core.transfer import TransferMode as JaxMode  # noqa: E402
from repro.launch.mesh import make_serving_pod_mesh  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import kvcache as jkvc  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.serving import DisaggregatedEngine as JaxDisagg  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import MLAConfig, get_config  # noqa: E402
from repro_torch.core import transfer as xfer  # noqa: E402
from repro_torch.core.transfer import TransferMode  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import kvcache as kvc  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DisaggregatedEngine,
    Request,
    ServingEngine,
)

ARCH = "deepseek-v2-236b"
LTOL = 1e-5  # one MLA layer, fp32
TOL = 1e-4  # model logits, fp32
LAW_TOL = 5e-4  # prefill + decode == forward (tests/test_decode_equivalence)
GAP_TOL = 1e-4
LENS = [5, 17, 33, 50]
KW = dict(max_batch=2, max_seq=128)
PATHS = {
    "bucketed": ({}, {}),
    "paged": (dict(paged=True, prefix_reuse=False),
              dict(paged=True, page_size=16, prefix_reuse=False)),
    "legacy": (dict(legacy=True), dict(legacy=True)),
    "warmed": (dict(warmup=True), dict(warmup=True)),
}
MODES = [m.value for m in TransferMode]
COUNTERS = ("prefill_padded_tokens", "prefill_tokens_total",
            "prefill_tokens_uncached", "decode_steps",
            "useful_steps")
TIER_COUNTERS = ("handoffs", "handoff_wire_bytes", "handoff_request_bytes")


def _cfgs(drop=True):
    """(JAX config, port config): reduced deepseek-v2, optionally nodrop."""
    out = (jax_get_config(ARCH).reduced(), get_config(ARCH).reduced())
    return out if drop else tuple(nodrop(c) for c in out)


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


def _layer(drop=True):
    """Layer 0's attention params: (JAX jnp tree, port tensor tree)."""
    jm, jp, _, tp = _pair(drop)
    jl = jp["decoder"]["g0"]["l0"]["attn"]
    if jm.groups[0].count > 1:  # a scanned group carries a layer axis
        jl = jax.tree.map(lambda a: a[0], jl)
    return jl, tp["decoder"]["g0"][0]["l0"]["attn"]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=LTOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=tol * max(1.0, np.abs(_np(want)).max()))


# --------------------------------------------------------------------------- #
# Schema and weights
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_schema_matches_jax(q_lora):
    jcfg, cfg = _cfgs()
    if not q_lora:
        jcfg, cfg = (dataclasses.replace(c, mla=dataclasses.replace(
            c.mla, q_lora_rank=0)) for c in (jcfg, cfg))
    js, ts = jmla.mla_schema(jcfg), mla.mla_schema(cfg)
    assert set(js) == set(ts)
    assert ("wq" in ts) != q_lora and ("wq_a" in ts) == q_lora
    for k in js:
        assert tuple(ts[k].shape) == tuple(js[k].shape), k
        assert ts[k].init == js[k].init, k


def _bits(t):
    return t.contiguous().view(torch.int16)


def test_params_from_numpy_carries_mla_bits():
    """bf16 JAX weights cross bit for bit: every ``attn`` leaf of MLA
    (wq_a, q_norm, wq_b, wkv_a, kv_norm, wk_b, wv_b, wo) in both layers (a
    dense-FFN layer, then an MoE one)."""
    jcfg, cfg = _cfgs()
    jp = jax.tree.map(np.asarray, JaxModel(jcfg, dtype=jnp.bfloat16).init(
        jax.random.key(2)))
    tp = params_from_numpy(jp, cfg, device="cpu")
    tm = Model(cfg, dtype=torch.bfloat16, device="cpu")
    names = {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b",
             "wo"}
    n = 0
    for gi, g in enumerate(tm.groups):
        for i in range(g.count):
            for j in range(len(g.sigs)):
                want = jp["decoder"][f"g{gi}"][f"l{j}"]["attn"]
                got = tp["decoder"][f"g{gi}"][i][f"l{j}"]["attn"]
                assert set(got) == names == set(want)
                for k in names:
                    w = want[k][i] if g.count > 1 else want[k]
                    assert got[k].dtype == torch.bfloat16
                    assert np.array_equal(_bits(got[k]).numpy(),
                                          np.asarray(w).view(np.int16)), k
                    n += 1
    assert n == 2 * len(names)
    assert tuple(tp["decoder"]["g0"][0]["l0"]["attn"]["wk_b"].shape) == (
        64, 4, 32)


# --------------------------------------------------------------------------- #
# The layer
# --------------------------------------------------------------------------- #
def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_latent_kv_and_prefill_match_jax():
    jcfg, cfg = _cfgs()
    jl, tl = _layer()
    B, S = 2, 19
    x = _x((B, S, cfg.d_model), 3)
    pos = np.arange(S, dtype=np.int32)[None, :] + np.array([[0], [7]])
    jc, jr = jmla.latent_kv(jl, jcfg, jnp.asarray(x), jnp.asarray(pos))
    c, r = mla.latent_kv(tl, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    _close(c, jc)
    _close(r, jr)
    assert tuple(c.shape) == (B, S, 64) and tuple(r.shape) == (B, S, 16)
    jout, jcache = jmla.mla_prefill(jl, jcfg, jnp.asarray(x),
                                    jnp.asarray(pos[:1]))
    out, cache = mla.mla_prefill(tl, cfg, torch.from_numpy(x),
                                 torch.from_numpy(pos[:1]))
    _close(out, jout)
    for k in ("ckv", "krope"):
        _close(cache[k], jcache[k])


@pytest.mark.parametrize("wrapped", [False, True])
def test_mla_decode_update_matches_jax(wrapped):
    """One decode token against a random latent ring, written at ``lengths
    % W``: the output and both leaves equal JAX's. A wrapped ring (lengths
    past W) attends every slot, in slot order, not position order."""
    jcfg, cfg = _cfgs()
    jl, tl = _layer()
    B, W = 3, 24
    lengths = np.array([30, 57, 24] if wrapped else [0, 5, 23], np.int32)
    valid = np.minimum(lengths + 1, W).astype(np.int32)
    x = _x((B, 1, cfg.d_model), 4)
    ckv = _x((B, W, 64), 5)
    krope = _x((B, W, 16), 6)
    jout, jcache = jmla.mla_decode_update(
        jl, jcfg, jnp.asarray(x), {"ckv": jnp.asarray(ckv),
                                   "krope": jnp.asarray(krope)},
        jnp.asarray(lengths), jnp.asarray(lengths[:, None]),
        valid_len=jnp.asarray(valid))
    cache = {"ckv": torch.from_numpy(ckv.copy()),
             "krope": torch.from_numpy(krope.copy())}
    out = mla.mla_decode_update(tl, cfg, torch.from_numpy(x), cache,
                                torch.from_numpy(lengths),
                                torch.from_numpy(lengths[:, None]),
                                valid_len=torch.from_numpy(valid))
    _close(out, jout)
    for k in ("ckv", "krope"):
        _close(cache[k], jcache[k])  # written in place
    assert not np.array_equal(cache["ckv"].numpy(), ckv)


def _identity_cfg():
    """An MLA config whose decode output IS the attention's latent context:
    no query low rank, nope == latent rank == v_head_dim, d = H (r + rope)."""
    H, r, rope = 2, 8, 4
    m = MLAConfig(kv_lora_rank=r, q_lora_rank=0, qk_nope_dim=r,
                  qk_rope_dim=rope, v_head_dim=r)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_heads=H,
                              n_kv_heads=H, d_model=H * (r + rope), mla=m)
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), n_heads=H,
                               n_kv_heads=H, d_model=H * (r + rope),
                               mla=jax_get_config(ARCH).reduced().mla.__class__(
                                   **dataclasses.asdict(m)))
    return jcfg, cfg


def _jax_attend(jcfg, q_lat, q_rope, ckv, krope, valid):
    """JAX's ``attend`` + normalisation, read out of ``mla_decode_update``
    through identity weights: wq = I (q is x), wk_b = I per head (q_abs is
    q_nope), wv_b = I per head and wo = [I 0] (the output is the context);
    positions 0 (RoPE is the identity) and the new entry written at slot
    W - 1, which ``valid`` keeps out of sight."""
    H, r = q_lat.shape[2], q_lat.shape[3]
    rope = q_rope.shape[3]
    B, W = ckv.shape[:2]
    d = H * (r + rope)
    eye = np.broadcast_to(np.eye(r, dtype=np.float32)[:, None, :], (r, H, r))
    wo = np.zeros((H * r, d), np.float32)
    wo[:, :H * r] = np.eye(H * r, dtype=np.float32)
    p = {"wq": jnp.eye(d, dtype=jnp.float32), "wk_b": jnp.asarray(eye),
         "wv_b": jnp.asarray(eye), "wo": jnp.asarray(wo),
         "wkv_a": jnp.zeros((d, r + rope), jnp.float32),
         "kv_norm": jnp.ones((r,), jnp.float32)}
    x = np.concatenate([q_lat, q_rope], axis=-1).reshape(B, 1, d)
    last = np.full((B,), W - 1, np.int32)
    out, _ = jmla.mla_decode_update(
        p, jcfg, jnp.asarray(x), {"ckv": jnp.asarray(ckv),
                                  "krope": jnp.asarray(krope)},
        jnp.asarray(last), jnp.zeros((B, 1), jnp.int32),
        valid_len=jnp.asarray(valid))
    return np.asarray(out)[..., :H * r].reshape(B, 1, H, r)


def test_plain_mla_decode_matches_jax_attend_ring_and_paged():
    jcfg, cfg = _identity_cfg()
    B, W, H, r, rope, page = 3, 32, 2, 8, 4, 4
    q_lat, q_rope = _x((B, 1, H, r), 7) * 2, _x((B, 1, H, rope), 8) * 2
    ckv, krope = _x((B, W, r), 9), _x((B, W, rope), 10)
    valid = np.array([1, 17, 31], np.int32)  # slot W - 1 stays masked
    want = _jax_attend(jcfg, q_lat, q_rope, ckv, krope, valid)
    scale = 1.0 / math.sqrt(r + rope)
    t = [torch.from_numpy(a) for a in (q_lat, q_rope, ckv, krope, valid)]
    got = ref.mla_decode_attention_ref(*t, scale=scale)
    _close(got, want)
    # through the ops entry point on CPU tensors: the plain version, no launch
    ops.reset_launches()
    _close(ops.mla_decode_attention(*t, scale=scale), want)
    # paged: the same rows scattered over a shuffled pool, a sentinel block 0
    n_pages = W // page
    perm = np.random.default_rng(11).permutation(B * n_pages) + 1
    table = perm.reshape(B, n_pages).astype(np.int32)
    cb = np.zeros((B * n_pages + 1, page, r), np.float32)
    rb = np.zeros((B * n_pages + 1, page, rope), np.float32)
    cb[table.reshape(-1)] = ckv.reshape(B * n_pages, page, r)
    rb[table.reshape(-1)] = krope.reshape(B * n_pages, page, rope)
    pt = [torch.from_numpy(a) for a in (cb, rb, table)]
    got = ops.paged_mla_decode_attention(t[0], t[1], *pt, t[4], scale=scale)
    _close(got, want)
    assert sum(ops.LAUNCHES.values()) == 0
    # a row of length 0 gives zeros, not NaN
    zero = ref.mla_decode_attention_ref(*t[:4], torch.zeros(B, dtype=torch.int32),
                                        scale=scale)
    assert not zero.any()


def test_mla_ops_check_shapes():
    q, qr = torch.zeros(2, 1, 16, 512), torch.zeros(2, 1, 16, 64)
    ckv, kr = torch.zeros(2, 8, 512), torch.zeros(2, 8, 64)
    vl = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="mla_decode_attention"):
        ops.mla_decode_attention(q, qr, ckv, torch.zeros(2, 8, 32), vl,
                                 scale=1.0)
    with pytest.raises(ValueError, match="mla_decode_attention"):
        ops.mla_decode_attention(q[:, :, :8], qr, ckv, kr, vl, scale=1.0)
    with pytest.raises(ValueError, match="page_table"):
        ops.paged_mla_decode_attention(q, qr, ckv, kr, torch.zeros(3, 2),
                                       vl, scale=1.0)


def test_flash_takes_v_at_its_own_head_dim():
    """MLA's prefill: q/k at 192, v at 128 -> [B,S,H,128] with scale
    1/sqrt(192); the plain version equals attention computed by hand. A
    prior or segment ids still need v at q's head dim."""
    rng = np.random.default_rng(12)
    B, S, H = 2, 9, 2
    q, k = (torch.from_numpy(rng.normal(size=(B, S, H, 192)).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(B, S, H, 128)).astype(np.float32))
    out = ops.flash_attention(q, k, v, causal=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(192)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    assert tuple(out.shape) == (B, S, H, 128)
    _close(out, want)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v, segment_ids=torch.zeros(B, S,
                                                             dtype=torch.int32))


# --------------------------------------------------------------------------- #
# The latent cache's helpers on 3-D leaves
# --------------------------------------------------------------------------- #
def _rand_tree(tree, seed):
    rng = np.random.default_rng(seed)
    for _, t in xfer.leaf_paths(tree):
        t.copy_(torch.from_numpy(rng.normal(size=t.shape)).to(t.dtype))
    return tree


def _stack(tree):
    """The port's per-layer list stacked into JAX's cache layout."""
    return {g: {l: {k: jnp.asarray(np.stack([blk[l][k].numpy()
                                             for blk in group]))
                    if len(group) > 1 else jnp.asarray(group[0][l][k].numpy())
                    for k in group[0][l]}
                for l in group[0]}
            for g, group in tree.items()}


def test_latent_cache_helpers_take_3d_leaves():
    jm, _, tm, _ = _pair()
    assert tm.cache_specs(2, 32)["g0"][0]["l0"] == {"ckv": (2, 32, 64),
                                                    "krope": (2, 32, 16)}
    tc = _rand_tree(tm.init_cache(4, 32), 13)
    jc = _stack(tc)
    assert jax.tree.structure(jc) == jax.tree.structure(jm.init_cache(4, 32))
    # grow pads the ring dim only
    grown, jgrown = kvc.grow_cache(tc, 48), jkvc.grow_cache(jc, 48)
    for (p, a), b in zip(xfer.leaf_paths(grown), jax.tree.leaves(jgrown)):
        assert tuple(a.shape) == (4, 48, a.shape[2])
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # slice, pad back, and the bytes of one request
    cut, jcut = kvc.slice_cache(tc, 3, 16), jkvc.slice_cache(jc, 3, 16)
    for (_, a), b in zip(xfer.leaf_paths(cut), jax.tree.leaves(jcut)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = kvc.pad_cache_rows(cut, 4)
    for (_, a), (_, f) in zip(xfer.leaf_paths(back), xfer.leaf_paths(tc)):
        assert torch.equal(a[:3], f[:3, :16]) and not a[3:].any()
    for n in (1, 17, 32, 40):
        assert kvc.request_cache_nbytes(tc, n) == jkvc.request_cache_nbytes(
            jc, n) == 2 * min(n, 32) * (64 + 16) * 4
    # pages: specs, scatter, the token write and a gather back
    specs = kvc.paged_specs(tm.cache_specs(2, 32), 9, 8)
    assert specs["g0"][0]["l0"] == {"ckv": (10, 8, 64), "krope": (10, 8, 16)}
    pool = kvc.init_paged(tm.cache_specs(2, 32), 9, 8, dtype=torch.float32,
                          device="cpu")
    dense = kvc.slice_cache(tc, 2, 16)  # 2 rows of 2 pages
    dest = np.array([[3, 1], [0, 7]])  # row 1's first page is dummy
    kvc.scatter_pages(pool, dense, dest)
    table = torch.tensor([[3, 1, 0, 0], [5, 7, 0, 0]], dtype=torch.int32)
    got = kvc.gather_pages(pool, table)
    for (_, g), (_, d) in zip(xfer.leaf_paths(got), xfer.leaf_paths(dense)):
        assert torch.equal(g[0, :16], d[0]) and torch.equal(g[1, 8:16], d[1, 8:])
        assert not g[1, :8].any()  # block 5 was never written
    blk = pool["g0"][0]["l0"]["ckv"]
    new = torch.from_numpy(_x((2, 1, 64), 14))
    kvc.paged_write(blk, new, torch.tensor([9, 3], dtype=torch.int32), table)
    assert torch.equal(blk[1, 1], new[0, 0]) and torch.equal(blk[5, 3], new[1, 0])


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #
def test_deepseek_logits_prefill_and_decode_match_jax():
    """A prefill of 16 tokens and 4 decode steps (the full forward is held
    to them by the law below)."""
    jm, jp, tm, tp = _pair()
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (2, 21),
                                             dtype=np.int32)
    last, caches, lengths = tm.prefill(tp, torch.from_numpy(toks[:, :16]))
    jlast, jc, jlens = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :16])})
    _close(last, jlast, TOL)
    caches, jc = kvc.grow_cache(caches, 32), jkvc.grow_cache(jc, 32)
    for t in range(16, 20):
        lg, caches, lengths = tm.decode_step(
            tp, caches, torch.from_numpy(toks[:, t:t + 1]), lengths)
        jlg, jc, jlens = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                        jlens)
        _close(lg, jlg, TOL)


def test_prefill_plus_decode_equals_forward():
    """tests/test_decode_equivalence.py's law on the port (nothing
    dropped): prefill of S tokens, then K decode steps, give the forward's
    logits. An off-by-one in the shared key's RoPE position shows here."""
    _, _, tm, tp = _pair(drop=False)
    B, S, K = 2, 16, 4
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (B, S + K), dtype=np.int32))
    full, _, _ = tm.forward(tp, toks)
    lg, caches, lengths = tm.prefill(tp, toks[:, :S])
    caches = kvc.grow_cache(caches, S + K)
    errs = [float((lg - full[:, S - 1]).abs().max())]
    for k in range(K):
        lg, caches, lengths = tm.decode_step(tp, caches,
                                             toks[:, S + k:S + k + 1], lengths)
        errs.append(float((lg - full[:, S + k]).abs().max()))
    assert max(errs) < LAW_TOL, errs


def test_prior_and_segment_ids_raise_as_in_jax():
    _, _, tm, tp = _pair()
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="packed prefill"):
        tm.prefill_packed(tp, toks, toks, torch.zeros_like(toks),
                          torch.zeros(1, dtype=torch.int32))
    prior = tm.init_cache(1, 16)
    with pytest.raises(ValueError, match="prefix-reuse"):
        tm.prefill_suffix_dense(tp, toks, torch.ones(1, dtype=torch.int32),
                                torch.ones(1, dtype=torch.int32), prior)


# --------------------------------------------------------------------------- #
# The engine, path by path, against the JAX engine on the same path
# --------------------------------------------------------------------------- #
def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, s, dtype=np.int32) for s in lens]


def _drain(eng, req_cls, prompts, max_new=5):
    reqs = [req_cls(prompt_tokens=p.copy(), max_new_tokens=max_new)
            for p in prompts]
    for r in reqs:
        eng.submit(r, time.perf_counter())
    out = eng.run_until_drained(max_steps=100_000)
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
            port_kw, jax_kw = PATHS[path]
            eng = (JaxEngine(jm, jp, **KW, **jax_kw) if side == "jax"
                   else ServingEngine(tm, tp, device="cpu", **KW, **port_kw))
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


# every path at the default capacity factor; without drops, the fused paths
# that must then all agree and the tier's direct mechanism
ENGINE_CASES = ([(p, True) for p in [*PATHS, *MODES]]
                + [(p, False) for p in ("bucketed", "paged", "legacy",
                                        "warmed", "direct_dma")])


@pytest.mark.parametrize("path,drop", ENGINE_CASES)
def test_engine_path_matches_jax_same_path(path, drop):
    toks, eng, prompts = _run("port", path, drop)
    jtoks, jeng, _ = _run("jax", path, drop)
    if path == "host_staged":  # int8 KV: the first tokens come from prefill
        assert [t[0] for t in toks] == [t[0] for t in jtoks]
    else:
        _same_tokens(toks, jtoks, prompts, drop)
    assert all(len(t) == 5 for t in toks)
    for c in COUNTERS + (TIER_COUNTERS if path in MODES else ()):
        assert getattr(eng, c) == getattr(jeng, c), c
    if path == "paged":
        assert eng.paged and not eng.prefix_reuse and eng.prefix_hits == 0


def test_paths_agree_without_drops():
    """Without drops every fused path, and the direct tier, gives the
    bucketed engine's tokens: the paged twin of the decode, the legacy loop
    and the handoff change nothing."""
    base = _run("port", "bucketed", False)[0]
    for path in ("paged", "legacy", "warmed", "direct_dma"):
        assert _run("port", path, False)[0] == base, path


def test_mla_auto_downgrades():
    """tests/test_packing.py's twin: MLA stacks bucket fine but neither pack
    nor chunk (the latent cache has no segment masking), and page without
    prefix reuse; all three turn off silently, and the tokens are the
    bucketed engine's."""
    _, _, tm, tp = _pair(drop=False)
    eng = ServingEngine(tm, tp, device="cpu", max_batch=2, max_seq=64,
                        packed=True, prefill_chunk=32)
    assert not eng.exact_prefill
    assert not eng.packed and not eng._chunk_enabled
    paged = ServingEngine(tm, tp, device="cpu", max_batch=2, max_seq=64,
                          paged=True)
    assert paged.paged and not paged.prefix_reuse
    prompts = _prompts(tm.cfg.vocab_size, [9, 40])
    base = _drain(ServingEngine(tm, tp, device="cpu", max_batch=2,
                                max_seq=64), Request, prompts)
    assert _drain(eng, Request, prompts) == base


# --------------------------------------------------------------------------- #
# The handoff's latent payload
# --------------------------------------------------------------------------- #
def test_host_staged_latent_payload_equals_jax_kv_transfer():
    """A stacked group of three MLA layers (ckv, krope at very different
    magnitudes a layer) under HOST_STAGED: one scale per JAX leaf over the
    group's layers, and the int8 values, the scales and the landed values
    equal JAX's ``kv_transfer``'s."""
    L, B, W, r, rope = 3, 2, 16, 64, 16
    rng = np.random.default_rng(15)
    mag = np.array([0.01, 1.0, 30.0], np.float32)[:, None, None, None]
    ckv = (rng.normal(size=(L, B, W, r)) * mag).astype(np.float32)
    krope = rng.normal(size=(L, B, W, rope)).astype(np.float32)
    leaves = {"ckv": ckv, "krope": krope}
    tree = {"caches": {"g0": [{"l0": {k: torch.from_numpy(v[i].copy())
                                      for k, v in leaves.items()}}
                              for i in range(L)]}}
    packed = xfer.pack(tree)
    bufs = xfer.HopBuffers(TransferMode.HOST_STAGED, "cpu")
    bufs.fit(packed)
    landed = xfer.move(packed, bufs).unpack()
    jtree = {"caches": {"g0": {"l0": {k: jnp.asarray(v)
                                      for k, v in leaves.items()}}}}
    jland = jxfer.pod_take(jxfer.kv_transfer(
        jxfer.pod_tile(jtree, 1, 0), make_serving_pod_mesh(1),
        mode=jxfer.TransferMode.HOST_STAGED, perm=[(0, 0)]), 0)
    for i, key in enumerate(("ckv", "krope")):
        got = np.stack([blk["l0"][key].numpy()
                        for blk in landed["caches"]["g0"]])
        np.testing.assert_array_equal(
            got, np.asarray(jland["caches"]["g0"]["l0"][key]))
        x = jnp.asarray(leaves[key])
        jscale = jxfer._pod_scales(x[None])[0]
        jq = jnp.clip(jnp.round(x / jscale), -127, 127).astype(jnp.int8)
        (_, _, _, q), (_, _, _, scale) = bufs.stages[i]
        assert float(scale) == float(jscale)
        np.testing.assert_array_equal(q.view(jq.shape).numpy(),
                                      np.asarray(jq))
    wire = xfer.payload_wire_bytes(tree, TransferMode.HOST_STAGED)
    assert wire == jxfer.payload_wire_bytes(
        jtree, jxfer.TransferMode.HOST_STAGED) == L * B * W * (r + rope) + 8


def test_handoff_prices_1152_bytes_a_token_a_layer():
    """deepseek-v2-236b at published widths: a token's latent cache is 512
    + 64 bf16 values a layer, 1,152 bytes (int8 on the wire under
    HOST_STAGED: 576), over its 60 layers; the reduced tier's request
    bytes equal JAX's."""
    tm = Model(get_config(ARCH), device="cpu")
    tc = {g: [{name: kvc.init_layer_cache(shapes, tm.dtype, "meta")
               for name, shapes in block.items()} for block in group]
          for g, group in tm.cache_specs(1, 2048).items()}
    assert kvc.request_cache_nbytes(tc, 1) == 60 * 1152
    assert kvc.request_cache_nbytes(tc, 1000) == 1000 * 60 * 1152
    assert kvc.request_cache_nbytes(
        tc, 1000, itemsize=lambda t: xfer.wire_itemsize(
            t.dtype, TransferMode.HOST_STAGED)) == 1000 * 60 * 576
    _, eng, _ = _run("port", "direct_hbm", True)
    _, jeng, _ = _run("jax", "direct_hbm", True)
    for n in (1, 17, 50, 128):
        assert eng.request_handoff_bytes(n) == jeng.request_handoff_bytes(n)


def test_launcher_serves_deepseek_on_cpu(capsys):
    """``launch/serve.py --arch deepseek-v2-236b --reduced --device cpu``."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--clients", "2", "--requests", "1",
                      "--prompt-len", "4:24", "--new-tokens", "3"])
    assert len(out["responses"]) == 2
    assert all(len(r.tokens) == 3 for r in out["responses"])
    assert f"{ARCH}-reduced (2 layers)" in capsys.readouterr().out
