"""Port prefill->decode transfer (``core/transfer.py``) and cache helpers
(``models/kvcache.py``) vs the JAX package, on the CPU.

DIRECT_HBM and DIRECT_DMA land the payload bit for bit. HOST_STAGED is held
to JAX's ``kv_transfer`` on its 1-pod mesh on a tree shaped like one stacked
JAX layer group (three layers of k/v): the port, which keeps a tensor per
layer, must take ONE scale over the group's layers, as JAX does over its
stacked leaf, so its int8 values, its scales and its dequantized values
equal JAX's exactly; integer leaves cross bit for bit. ``payload_wire_bytes``
and ``request_cache_nbytes`` equal JAX's on the reduced llama3-8b and
mamba2-130m cache trees, and ``slice_cache`` matches JAX's and round-trips
through ``pad_cache_rows``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import transfer as jxfer  # noqa: E402
from repro.launch.mesh import make_serving_pod_mesh  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import kvcache as jkvc  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import transfer as xfer  # noqa: E402
from repro_torch.core.transfer import TransferMode  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import kvcache as kvc  # noqa: E402

JMODE = {m: jxfer.TransferMode(m.value) for m in TransferMode}
LAYERS, B, W, H, D = 3, 2, 16, 2, 8


def _group(seed=0):
    """One stacked layer group as numpy (JAX layout: [layers, B, W, H, d]
    per key, the layers at very different magnitudes) and int32
    metadata."""
    rng = np.random.default_rng(seed)
    scale = np.array([0.01, 1.0, 30.0], np.float32)[:, None, None, None, None]
    k = (rng.normal(size=(LAYERS, B, W, H, D)) * scale).astype(np.float32)
    v = rng.normal(size=(LAYERS, B, W, H, D)).astype(np.float32)
    meta = rng.integers(-5, 2**20, (4, B)).astype(np.int32)
    return k, v, meta


def _port_tree(k, v, meta):
    return {"caches": {"g0": [{"l0": {"k": torch.from_numpy(k[i].copy()),
                                      "v": torch.from_numpy(v[i].copy())}}
                              for i in range(LAYERS)]},
            "meta": {f"m{j}": torch.from_numpy(meta[j].copy())
                     for j in range(4)}}


def _move(packed, mode):
    """``packed`` moved under ``mode`` on the CPU, and the buffers it took."""
    bufs = xfer.HopBuffers(mode, "cpu")
    bufs.fit(packed)
    return xfer.move(packed, bufs), bufs


def _jax_tree(k, v, meta):
    return {"caches": {"g0": {"l0": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}},
            "meta": {f"m{j}": jnp.asarray(meta[j]) for j in range(4)}}


def _stacked(tree):
    """The port tree's caches stacked back into JAX's layout, as numpy."""
    g = tree["caches"]["g0"]
    return {key: np.stack([blk["l0"][key].numpy() for blk in g])
            for key in ("k", "v")}


@pytest.mark.parametrize("mode", [TransferMode.DIRECT_HBM,
                                  TransferMode.DIRECT_DMA])
def test_direct_modes_land_bit_exact_in_fresh_buffers(mode):
    k, v, meta = _group()
    tree = _port_tree(k, v, meta)
    landed = _move(xfer.pack(tree), mode)[0].unpack()
    for (p, a), (q, b) in zip(xfer.leaf_paths(tree), xfer.leaf_paths(landed)):
        assert p == q and torch.equal(a, b)
        assert a.data_ptr() != b.data_ptr()  # disjoint from the source


def test_host_staged_equals_jax_kv_transfer():
    k, v, meta = _group()
    tree = _port_tree(k, v, meta)
    packed = xfer.pack(tree)
    moved, bufs = _move(packed, TransferMode.HOST_STAGED)
    landed = moved.unpack()
    jtree = _jax_tree(k, v, meta)
    mesh = make_serving_pod_mesh(1)
    jland = jxfer.pod_take(jxfer.kv_transfer(
        jxfer.pod_tile(jtree, 1, 0), mesh,
        mode=jxfer.TransferMode.HOST_STAGED, perm=[(0, 0)]), 0)
    got = _stacked(landed)
    for i, key in enumerate(("k", "v")):
        np.testing.assert_array_equal(
            got[key], np.asarray(jland["caches"]["g0"]["l0"][key]))
        # the int8 payload and scale: JAX's per-source-pod scale over the
        # whole stacked leaf, and its quantization formula
        x = jnp.asarray({"k": k, "v": v}[key])
        jscale = jxfer._pod_scales(x[None])[0]
        jq = jnp.clip(jnp.round(x / jscale), -127, 127).astype(jnp.int8)
        assert [p for p, _ in packed.leaves[i]] == [
            ("caches", "g0", j, "l0", key) for j in range(LAYERS)]
        # what crossed: the decode side's int8 flat and its scale
        (_, _, _, q), (_, _, _, scale) = bufs.stages[i]
        assert scale.dtype == torch.float32 and q.dtype == torch.int8
        assert float(scale) == float(jscale)
        np.testing.assert_array_equal(q.view(jq.shape).numpy(),
                                      np.asarray(jq))
    for j in range(4):  # integer leaves cross at full width, exactly
        assert torch.equal(landed["meta"][f"m{j}"], tree["meta"][f"m{j}"])
    # one scale per JAX leaf: 4 bytes for k, 4 for v
    assert xfer.payload_wire_bytes(tree, TransferMode.HOST_STAGED) == (
        jxfer.payload_wire_bytes(jtree, jxfer.TransferMode.HOST_STAGED))
    assert xfer.payload_wire_bytes(tree, TransferMode.HOST_STAGED) == (
        2 * LAYERS * B * W * H * D + 8 + 4 * 4 * B)


def test_host_staged_scale_floor_on_an_all_zero_leaf():
    z = np.zeros((LAYERS, B, W, H, D), np.float32)
    tree = _port_tree(z, z, np.zeros((4, B), np.int32))
    moved, bufs = _move(xfer.pack(tree), TransferMode.HOST_STAGED)
    assert all(float(t.abs().max()) == 0.0
               for _, t in xfer.leaf_paths(moved.unpack()["caches"]))
    (_, _, _, q), (_, _, _, scale) = bufs.stages[0]
    assert not q.any()
    assert float(scale) == float(jxfer._pod_scales(jnp.asarray(z)[None])[0])


@pytest.mark.parametrize("mode", list(TransferMode))
def test_buffers_grow_to_the_largest_extent_and_serve_smaller_ones(mode):
    """One set of buffers per JAX leaf: a smaller payload moves through the
    leading elements of the buffers a larger one grew, with no allocation;
    only a payload that outgrows them allocates again."""
    k, v, meta = _group()
    big = _port_tree(k, v, meta)
    small = _port_tree(k[:, :1, :4], v[:, :1, :4], meta[:, :1])
    bufs = xfer.HopBuffers(mode, "cpu")

    def ptrs():
        return [t.data_ptr() for t in bufs.land]

    bufs.fit(xfer.pack(small))
    first = ptrs()
    bufs.fit(xfer.pack(big))
    grown = ptrs()
    assert all(a != b for a, b in zip(first, grown))
    for tree in (small, big, small):
        packed = xfer.pack(tree)
        bufs.fit(packed)
        assert ptrs() == grown
        landed = xfer.move(packed, bufs).unpack()
        want = _move(packed, mode)[0].unpack()
        for (p, a), (_, b) in zip(xfer.leaf_paths(landed),
                                  xfer.leaf_paths(want)):
            assert torch.equal(a, b), p
    assert [t.numel() for t in bufs.land] == [
        f.numel() for f in xfer.pack(big).flats]


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-130m"])
def test_wire_bytes_and_request_bytes_equal_jax(arch):
    jm = JaxModel(jax_get_config(arch).reduced(), dtype=jnp.bfloat16)
    tm = Model(get_config(arch).reduced(), device="cpu")
    jc, tc = jm.init_cache(4, 64), tm.init_cache(4, 64)
    for mode in TransferMode:
        assert xfer.payload_wire_bytes(tc, mode) == jxfer.payload_wire_bytes(
            jc, JMODE[mode])
        for n, prefix in ((1, 16), (2, 32), (4, 64)):
            assert xfer.payload_wire_bytes(
                kvc.slice_cache(tc, n, prefix), mode) == (
                jxfer.payload_wire_bytes(jkvc.slice_cache(jc, n, prefix),
                                         JMODE[mode]))
        for true_len in (1, 17, 64, 100):
            assert kvc.request_cache_nbytes(
                tc, true_len,
                itemsize=lambda t: xfer.wire_itemsize(t.dtype, mode)) == (
                jkvc.request_cache_nbytes(
                    jc, true_len, itemsize=lambda a: jxfer.wire_itemsize(
                        a.dtype, JMODE[mode])))


def test_mamba2_request_moves_its_whole_state():
    """The full mamba2-130m's per-request conv + state: the bytes the card's
    exact path hands off for every request (plus 16 of metadata)."""
    tm = Model(get_config("mamba2-130m"), device="cpu")
    tc = {g: [{name: kvc.init_layer_cache(shapes, tm.dtype, "meta")
               for name, shapes in block.items()} for block in group]
          for g, group in tm.cache_specs(1, 2048).items()}
    assert kvc.request_cache_nbytes(tc, 601) == 19_132_416
    assert xfer.payload_wire_bytes(tc, TransferMode.HOST_STAGED) == (
        4_847_616 + 8)


def test_slice_cache_matches_jax_and_round_trips():
    rng = np.random.default_rng(1)
    tm = Model(get_config("mamba2-130m").reduced(), dtype=torch.float32,
               device="cpu")
    jm = JaxModel(jax_get_config("mamba2-130m").reduced(), dtype=jnp.float32)
    la = Model(get_config("llama3-8b").reduced(), dtype=torch.float32,
               device="cpu")
    for model in (tm, la):
        full = model.init_cache(4, 32)
        for _, t in xfer.leaf_paths(full):
            t.copy_(torch.from_numpy(rng.normal(size=t.shape)).to(t.dtype))
        cut = kvc.slice_cache(full, 2, 16)
        back = kvc.pad_cache_rows(cut, 4)
        for (p, f), (_, c), (_, b) in zip(xfer.leaf_paths(full),
                                          xfer.leaf_paths(cut),
                                          xfer.leaf_paths(back)):
            seq = p[-1] in kvc.SEQ_KEYS
            assert c.shape[0] == 2 and (not seq or c.shape[1] == 16)
            assert torch.equal(b[:2], f[:2, :16] if seq else f[:2])
            assert b.shape[0] == 4 and not b[2:].any()
    # the same values sliced by JAX: the SSM leaves keep whole rows
    jc = jm.init_cache(4, 32)
    tc = tm.init_cache(4, 32)
    for _, t in xfer.leaf_paths(tc):
        t.copy_(torch.from_numpy(rng.normal(size=t.shape)).to(t.dtype))
    stacked = {"conv": np.stack([b["l0"]["conv"].numpy() for b in tc["g0"]]),
               "state": np.stack([b["l0"]["state"].numpy() for b in tc["g0"]])}
    jc = {"g0": {"l0": {k: jnp.asarray(v) for k, v in stacked.items()}}}
    assert set(jc) == set(jm.init_cache(4, 32))
    jcut = jkvc.slice_cache(jc, 3, 16)
    cut = kvc.slice_cache(tc, 3, 16)
    for key in ("conv", "state"):
        np.testing.assert_array_equal(
            np.stack([b["l0"][key].numpy() for b in cut["g0"]]),
            np.asarray(jcut["g0"]["l0"][key]))
