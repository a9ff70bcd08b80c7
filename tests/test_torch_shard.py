"""The port's sharded decode against the JAX package's ``shard_map`` on 4
forced host devices.

One module-scoped fixture runs the JAX side once, in a subprocess with
``--xla_force_host_platform_device_count=4`` (as tests/test_placement.py
runs its two-pod case), and writes inputs and outputs to a temporary npz:
the vocab-parallel ``embed_lookup``, ``decode_attention_update`` and
``mla_decode_update`` on a 1 x 4 (data, model) mesh under ``DECODE_32K``'s
rules (ragged lengths, a wrapped ring, rows whose later shards hold no
valid slot), and ``prefill`` plus two ``decode_step``s of reduced
llama3-8b and deepseek-v2-236b under ``DECODE_32K`` on 1 x 4 and
``LONG_500K`` on 2 x 2. The port runs the same inputs on a DeviceMesh that
names the CPU in every slot: the same shard arithmetic, one shard a
kernel call. All in fp32: the embedding exact, the shard bodies within
2e-5, the logits within 1e-4 of the largest logit; every cache shard is
checked. The plain decode versions' ``lse`` is held against a masked
``logsumexp``."""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference runs in a subprocess)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import DECODE_32K, LONG_500K  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.mesh import DeviceMesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention, layers, mla  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import layer_groups  # noqa: E402
from repro_torch.sharding.partition import (  # noqa: E402
    Sharded,
    make_ctx,
    place_for_ctx,
)

BODY_TOL = 2e-5
LOGIT_TOL = 1e-4
ARCHS = ("llama3-8b", "deepseek-v2-236b")
MESHES = {"decode_1x4": ((1, 4), DECODE_32K, 4),
          "long_2x2": ((2, 2), LONG_500K, 1)}  # (mesh shape, rules, batch)
W = 64  # ring slots: 16 a shard on four
LENS = {4: [3, 17, 40, 70], 1: [41]}  # row 0: shards 1-3 empty; 70 wraps
PROMPT = 12

_SCRIPT = r"""
import functools, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.shapes import DECODE_32K, LONG_500K
from repro.models import Model
from repro.models import attention, layers, mla
from repro.sharding.partition import make_ctx

assert len(jax.devices()) == 4, jax.devices()
W, LENS, PROMPT = %(W)d, %(LENS)r, %(PROMPT)d
MESHES = {"decode_1x4": ((1, 4), DECODE_32K, 4),
          "long_2x2": ((2, 2), LONG_500K, 1)}
out = {}

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[prefix + "/" + key] = np.asarray(leaf)

def mesh_of(shape):
    return Mesh(np.asarray(jax.devices()).reshape(shape), ("data", "model"))

rng = np.random.default_rng(0)
def normal(*shape, s=0.5):
    return (rng.standard_normal(shape) * s).astype(np.float32)

# the shard bodies on 1 x 4, DECODE_32K's rules of reduced llama3-8b
cfg = get_config("llama3-8b").reduced()
ctx = make_ctx(cfg, mesh_of((1, 4)), DECODE_32K)
table = normal(512, 32)
tokens = rng.integers(0, 512, (4, 9)).astype(np.int32)
emb = jax.jit(lambda t, x: layers.embed_lookup(t, x, ctx))(table, tokens)
put("embed", {"table": table, "tokens": tokens, "out": emb})

B, H, Hkv, hd = 4, 8, 2, 32
lens = np.asarray(LENS[4], np.int32)
valid = np.minimum(lens + 1, W).astype(np.int32)
ins = {"q": normal(B, 1, H, hd), "k_new": normal(B, 1, Hkv, hd),
       "v_new": normal(B, 1, Hkv, hd), "k": normal(B, W, Hkv, hd),
       "v": normal(B, W, Hkv, hd), "lengths": lens, "valid": valid}
fn = jax.jit(lambda q, kn, vn, k, v, l, vl: attention.decode_attention_update(
    q, kn, vn, k, v, l, valid_len=vl, shard_ctx=ctx))
o, k2, v2 = fn(*(ins[n] for n in ("q", "k_new", "v_new", "k", "v",
                                  "lengths", "valid")))
put("dec", dict(ins, out=o, k_out=k2, v_out=v2))

dcfg = get_config("deepseek-v2-236b").reduced()
dctx = make_ctx(dcfg, mesh_of((1, 4)), DECODE_32K)
dm = Model(dcfg, dtype=jnp.float32)
dp = dm.init(jax.random.key(0))
lp = dp["decoder"]["g0"]["l0"]["attn"]
m = dcfg.mla
x = normal(B, 1, dcfg.d_model, s=1.0)
cache = {"ckv": normal(B, W, m.kv_lora_rank), "krope": normal(B, W, m.qk_rope_dim)}
fn = jax.jit(lambda p, x, c, l, vl: mla.mla_decode_update(
    p, dcfg, x, c, l, l[:, None], valid_len=vl, shard_ctx=dctx))
o, c2 = fn(lp, x, cache, lens, valid)
put("mla", {"x": x, "ckv": cache["ckv"], "krope": cache["krope"],
            "lengths": lens, "valid": valid, "out": o,
            "ckv_out": c2["ckv"], "krope_out": c2["krope"]})

# the models: prefill and two decode steps under each mesh's rules
for arch in ("llama3-8b", "deepseek-v2-236b"):
    cfg = get_config(arch).reduced()
    model = Model(cfg, dtype=jnp.float32)
    params = model.init(jax.random.key(0))
    put(arch + "/params", params)
    for name, (shape, rules, B) in MESHES.items():
        ctx = make_ctx(cfg, mesh_of(shape), rules)
        key = arch + "/" + name
        toks = rng.integers(0, cfg.vocab_size, (B, PROMPT + 2)).astype(np.int32)
        pre = jax.jit(lambda p, t: model.prefill(p, {"tokens": t},
                                                 shard_ctx=ctx)[0])
        out[key + "/tokens"] = toks
        out[key + "/prefill_logits"] = np.asarray(pre(params, toks[:, :PROMPT]))
        caches = jax.tree.map(lambda s: normal(*s.shape, s=0.5),
                              model.cache_specs(B, W))
        put(key + "/caches_in", caches)
        lens = np.asarray(LENS[B], np.int32)
        step = jax.jit(functools.partial(model.decode_step, shard_ctx=ctx))
        for t in range(2):
            logits, caches, lens = step(params, caches,
                                        toks[:, PROMPT + t:PROMPT + t + 1], lens)
            out[key + "/decode_logits%%d" %% t] = np.asarray(logits)
        put(key + "/caches_out", caches)
np.savez(sys.argv[1], **out)
print("JAX_SHARD_OK")
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = tmp_path_factory.mktemp("shard") / "jax_shard.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    script = _SCRIPT % {"W": W, "LENS": LENS, "PROMPT": PROMPT}
    proc = subprocess.run([sys.executable, "-c", script, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "JAX_SHARD_OK" in proc.stdout
    with np.load(path) as z:
        return dict(z)


def _tree(npz, prefix):
    """The nested dict under ``prefix/`` of the npz's flat keys."""
    out = {}
    for key, arr in npz.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = out, key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _mesh(shape):
    return DeviceMesh(np.full(shape, "cpu", dtype=object), ("data", "model"))


def _close(got, want, tol):
    got = got.detach().float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _caches_from_jax(tree, cfg):
    """JAX's cache layout (a group's superblocks stacked when there are
    several) -> the port's (one entry a superblock)."""
    out = {}
    for gi, g in enumerate(layer_groups(cfg)):
        block = tree[f"g{gi}"]
        pick = (lambda i: {ln: {k: _t(v[i]) for k, v in lv.items()}
                           for ln, lv in block.items()}) if g.count > 1 else \
            (lambda i: {ln: {k: _t(v) for k, v in lv.items()}
                        for ln, lv in block.items()})
        out[f"g{gi}"] = [pick(i) for i in range(g.count)]
    return out


def _check_caches(port, want_tree, cfg):
    """Every shard of every sequence leaf, and every whole leaf, within
    1e-4 of the leaf's largest entry (the logits' rule: a written key
    carries the RoPE of its position, where the port's unsharded fp32
    decode already parts from JAX's by up to 1.2e-4 in a leaf whose
    largest entries are about 40)."""
    want = _caches_from_jax(want_tree, cfg)
    for g, group in port.items():
        for i, block in enumerate(group):
            for ln, leaves in block.items():
                for k, leaf in leaves.items():
                    w = want[g][i][ln][k].numpy()
                    tol = LOGIT_TOL * float(np.abs(w).max())
                    if not isinstance(leaf, Sharded):
                        _close(leaf, w, tol)
                        continue
                    _check_shards(leaf, w, tol)


def _check_shards(sh: Sharded, want, tol=BODY_TOL):
    nb, ns = sh.counts()[:2]
    b_l, w_l = sh.shape[0] // nb, sh.shape[1] // ns
    for coord in sh.mesh.coords():
        bi, si = sh.block(coord)[:2]
        _close(sh.locals[coord],
               want[bi * b_l:(bi + 1) * b_l, si * w_l:(si + 1) * w_l], tol)


# --------------------------------------------------------------------------- #
# the shard bodies
# --------------------------------------------------------------------------- #
def test_vocab_parallel_embed_lookup_is_exact(jax_side):
    cfg = get_config("llama3-8b").reduced()
    ctx = make_ctx(cfg, _mesh((1, 4)), DECODE_32K)
    assert ctx.shards_vocab
    z = _tree(jax_side, "embed")
    table, tokens = _t(z["table"]), _t(z["tokens"])
    got = layers.embed_lookup(table, tokens, ctx)  # split here
    np.testing.assert_array_equal(got.numpy(), z["out"])
    placed = Sharded.split(table, ctx.mesh, ctx.spec("vocab", "embed"))
    assert len(placed.blocks()) == 4
    np.testing.assert_array_equal(
        layers.embed_lookup(placed, tokens).numpy(), z["out"])
    # the sharded lm_head: each block's logits, concatenated
    x = torch.randn(2, 3, 32, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(layers.lm_head(placed, x, 500).numpy(),
                               layers.lm_head(table, x, 500).numpy(),
                               rtol=0, atol=1e-5)


def test_seq_sharded_decode_attention_update_matches_jax(jax_side):
    cfg = get_config("llama3-8b").reduced()
    ctx = make_ctx(cfg, _mesh((1, 4)), DECODE_32K)
    z = _tree(jax_side, "dec")
    spec = ctx.spec("batch", "kv_seq", None, None)
    ks = Sharded.split(_t(z["k"]), ctx.mesh, spec)
    vs = Sharded.split(_t(z["v"]), ctx.mesh, spec)
    assert ks.counts() == (1, 4, 1, 1)
    out = attention.decode_attention_update(
        _t(z["q"]), _t(z["k_new"]), _t(z["v_new"]), ks, vs, _t(z["lengths"]),
        valid_len=_t(z["valid"]), shard_ctx=ctx)
    _close(out, z["out"], BODY_TOL)
    _check_shards(ks, z["k_out"])
    _check_shards(vs, z["v_out"])
    with pytest.raises(TypeError, match="place_for_ctx"):
        attention.decode_attention_update(
            _t(z["q"]), _t(z["k_new"]), _t(z["v_new"]), _t(z["k"]),
            _t(z["v"]), _t(z["lengths"]), valid_len=_t(z["valid"]),
            shard_ctx=ctx)


def test_seq_sharded_mla_decode_update_matches_jax(jax_side):
    cfg = get_config("deepseek-v2-236b").reduced()
    ctx = make_ctx(cfg, _mesh((1, 4)), DECODE_32K)
    params = params_from_numpy(_tree(jax_side, "deepseek-v2-236b/params"),
                               cfg, device="cpu")
    lp = params["decoder"]["g0"][0]["l0"]["attn"]
    z = _tree(jax_side, "mla")
    spec = ctx.spec("batch", "kv_seq", None)
    cache = {k: Sharded.split(_t(z[k]), ctx.mesh, spec)
             for k in ("ckv", "krope")}
    lens = _t(z["lengths"])
    out = mla.mla_decode_update(lp, cfg, _t(z["x"]), cache, lens,
                                lens[:, None], valid_len=_t(z["valid"]),
                                shard_ctx=ctx)
    _close(out, z["out"], BODY_TOL)
    for k in ("ckv", "krope"):
        _check_shards(cache[k], z[k + "_out"])


# --------------------------------------------------------------------------- #
# the models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_step_match_jax(jax_side, arch, mesh_name):
    shape, rules, B = MESHES[mesh_name]
    cfg = get_config(arch).reduced()
    model = Model(cfg, dtype=torch.float32, device="cpu")
    params = params_from_numpy(_tree(jax_side, f"{arch}/params"), cfg,
                               device="cpu")
    ctx = make_ctx(cfg, _mesh(shape), rules)
    key = f"{arch}/{mesh_name}"
    caches = _caches_from_jax(_tree(jax_side, f"{key}/caches_in"), cfg)
    pp, cc = place_for_ctx(model, ctx, params, caches)
    assert isinstance(pp["embed"], Sharded) and ctx.shards_vocab
    toks = _t(jax_side[f"{key}/tokens"])

    def close_logits(got, want):
        _close(got, want, LOGIT_TOL * float(np.abs(want).max()))

    logits, _, _ = model.prefill(pp, toks[:, :PROMPT], shard_ctx=ctx)
    close_logits(logits, jax_side[f"{key}/prefill_logits"])
    lens = _t(np.asarray(LENS[B], np.int32))
    for t in range(2):
        logits, cc, lens = model.decode_step(
            pp, cc, toks[:, PROMPT + t:PROMPT + t + 1], lens, shard_ctx=ctx)
        close_logits(logits, jax_side[f"{key}/decode_logits{t}"])
    _check_caches(cc, _tree(jax_side, f"{key}/caches_out"), cfg)


def test_place_for_ctx_splits_the_table_and_the_sequence_leaves():
    cfg = get_config("deepseek-v2-236b").reduced()
    model = Model(cfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    caches = model.init_cache(1, W)
    ctx = make_ctx(cfg, _mesh((2, 2)), LONG_500K)
    pp, cc = place_for_ctx(model, ctx, params, caches)
    assert pp["embed"].spec == ("model", None) and len(pp["embed"].blocks()) == 2
    assert pp["decoder"]["g0"][0]["l0"]["attn"]["wq_a"] is \
        params["decoder"]["g0"][0]["l0"]["attn"]["wq_a"]  # whole, no copy
    leaf = cc["g0"][0]["l0"]["ckv"]
    assert leaf.spec == (None, ("data", "model"), None)
    assert leaf.counts() == (1, 4, 1) and leaf.locals[(1, 1)].shape[1] == W // 4
    # the blocks on the leaf's own device are views of it
    assert leaf.locals[(0, 1)].data_ptr() == \
        caches["g0"][0]["l0"]["ckv"][:, W // 4:].data_ptr()
    assert ctx.constrain(torch.zeros(4, 3, 512), "batch", None, "vocab") is not None
    with pytest.raises(ValueError, match="does not divide"):
        ctx.constrain(torch.zeros(4, 3, 511), "batch", None, "vocab")


# --------------------------------------------------------------------------- #
# the plain versions' lse
# --------------------------------------------------------------------------- #
def test_plain_decode_lse_is_the_masked_logsumexp():
    g = torch.Generator().manual_seed(3)
    B, W_, H, Hkv, hd = 4, 24, 6, 2, 16
    q = torch.randn(B, 1, H, hd, generator=g)
    k = torch.randn(B, W_, Hkv, hd, generator=g)
    v = torch.randn(B, W_, Hkv, hd, generator=g)
    lens = torch.tensor([0, 1, 13, 24], dtype=torch.int32)
    out, lse = ref.decode_attention_ref(q, k, v, lens, return_lse=True)
    assert torch.equal(out, ref.decode_attention_ref(q, k, v, lens))
    kg = k.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0], kg) / math.sqrt(hd)
    mask = torch.arange(W_)[None, None, :] < lens[:, None, None]
    want = torch.logsumexp(s.masked_fill(~mask, -math.inf), dim=-1)
    assert torch.isneginf(lse[0]).all() and not out[0].any()
    torch.testing.assert_close(lse[1:], want[1:], atol=1e-5, rtol=1e-5)


def test_plain_mla_decode_lse_is_the_masked_logsumexp():
    g = torch.Generator().manual_seed(4)
    B, W_, H, r, dr = 3, 20, 4, 16, 8
    q_lat = torch.randn(B, 1, H, r, generator=g)
    q_rope = torch.randn(B, 1, H, dr, generator=g)
    ckv = torch.randn(B, W_, r, generator=g)
    krope = torch.randn(B, W_, dr, generator=g)
    valid = torch.tensor([0, 7, 20], dtype=torch.int32)
    out, lse = ref.mla_decode_attention_ref(q_lat, q_rope, ckv, krope, valid,
                                            scale=0.3, return_lse=True)
    assert torch.equal(out, ref.mla_decode_attention_ref(
        q_lat, q_rope, ckv, krope, valid, scale=0.3))
    s = 0.3 * (torch.einsum("bhr,bkr->bhk", q_lat[:, 0], ckv)
               + torch.einsum("bhd,bkd->bhk", q_rope[:, 0], krope))
    mask = torch.arange(W_)[None, None, :] < valid[:, None, None]
    want = torch.logsumexp(s.masked_fill(~mask, -math.inf), dim=-1)
    assert torch.isneginf(lse[0]).all() and not out[0].any()
    torch.testing.assert_close(lse[1:], want[1:], atol=1e-5, rtol=1e-5)
