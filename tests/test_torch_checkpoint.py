"""Checkpoints: the port writes and reads the JAX package's file format.

A port save restores through JAX's ``restore_checkpoint`` and a JAX save
through the port's, with the keys (``params/decoder/g0/l0/attn/wq``,
``opt/.step``, ``opt/.m/...``, ``opt/.v/...``, ``step``), each scanned
group's leading ``[count]`` layer axis (a one-superblock group unstacked,
the encoder of an encoder-decoder always stacked) and the values equal,
bf16 stored as fp32 and restored bit for bit; pruning keeps the last
``keep``; the trainer resumes from the latest checkpoint.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.training import checkpoint as jck  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.schema import tree_leaves, tree_map  # noqa: E402
from repro_torch.training import checkpoint as tck  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import DataConfig, TrainConfig, train  # noqa: E402

# reduced llama3 (one scanned group of 2), deepseek-v2 (a dense and an MoE
# layer: two one-superblock groups), seamless (an encoder group)
ARCHS = ["llama3-8b", "deepseek-v2-236b", "seamless-m4t-large-v2"]


def _port_state(arch, dtype=torch.bfloat16, seed=0):
    """The port's params and an AdamW state with non-zero moments."""
    cfg = get_config(arch).reduced()
    tm = Model(cfg, dtype=dtype, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(seed))
    st = topt.adamw_init(tp)
    g = torch.Generator().manual_seed(seed + 1)
    for m, v in zip(tree_leaves(st.m), tree_leaves(st.v)):
        m.copy_(torch.randn(m.shape, generator=g))
        v.copy_(torch.rand(v.shape, generator=g))
    return cfg, tm, tp, topt.AdamWState(step=7, m=st.m, v=st.v)


def _jax_like(arch):
    jm = JaxModel(jax_get_config(arch).reduced(), dtype=jnp.bfloat16)
    jp = jm.init(jax.random.key(3))
    return jp, jopt.adamw_init(jp)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_save_restores_in_jax(tmp_path, arch):
    cfg, _, tp, st = _port_state(arch)
    path = tck.save_checkpoint(str(tmp_path), 7, tp, st)
    jp_like, jo_like = _jax_like(arch)
    jp, jo, step = jck.restore_checkpoint(path, jp_like, jo_like)
    assert step == 7 and int(jo.step) == 7
    assert jax.tree.structure(jp) == jax.tree.structure(jp_like)
    for mine, theirs in ((tp, jp), (st.m, jo.m), (st.v, jo.v)):
        want = params_to_numpy(mine)
        got = _np(theirs)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_save_restores_in_port(tmp_path, arch):
    jp, _ = _jax_like(arch)
    jo = jopt.adamw_init(jp)
    jo = jopt.AdamWState(
        step=jnp.asarray(4, jnp.int32),
        m=jax.tree.map(lambda a: a + 0.25, jo.m),
        v=jax.tree.map(lambda a: a + 0.5, jo.v))
    path = jck.save_checkpoint(str(tmp_path), 4, jp, jo)
    cfg, _, tp_like, st_like = _port_state(arch)
    tp, st, step = tck.restore_checkpoint(path, tp_like, st_like)
    assert step == 4 and st.step == 4
    want = params_from_numpy(_np(jp), cfg, device="cpu",
                             dtype=torch.bfloat16)
    for a, b in zip(tree_leaves(tp), tree_leaves(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    for a in tree_leaves(st.m):
        assert a.dtype == torch.float32 and (a == 0.25).all()
    for a in tree_leaves(st.v):
        assert (a == 0.5).all()


def test_keys_stacked_axis_and_fp32_storage(tmp_path):
    cfg, _, tp, st = _port_state("llama3-8b")
    path = tck.save_checkpoint(str(tmp_path), 3, tp, st)
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    wq = data["params/decoder/g0/l0/attn/wq"]
    assert wq.shape == (2, 256, 256) and wq.dtype == np.float32
    np.testing.assert_array_equal(
        wq[1], tp["decoder"]["g0"][1]["l0"]["attn"]["wq"].float().numpy())
    assert data["opt/.step"] == 7 and data["step"] == 3
    assert data["opt/.m/decoder/g0/l0/attn/wq"].shape == (2, 256, 256)
    assert data["opt/.v/embed"].shape == tuple(tp["embed"].shape)
    # exactly JAX's key set for the same structures
    jp, jo = _jax_like("llama3-8b")
    jpath = jck.save_checkpoint(str(tmp_path / "jax"), 3, jp, jo)
    with np.load(jpath) as f:
        assert sorted(f.files) == sorted(data)
    three = dataclasses.replace(cfg, n_layers=3)  # structure-checked
    other = Model(three, device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="2,\\) layers stored, 3 held"):
        tck.restore_checkpoint(path, other, topt.adamw_init(other))


def test_pruning_keeps_the_last(tmp_path):
    _, _, tp, st = _port_state("llama3-8b", dtype=torch.float32)
    for step in (1, 2, 3, 4, 5):
        tck.save_checkpoint(str(tmp_path), step, tp, st, keep=2)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["ckpt_00000004.npz", "ckpt_00000005.npz"]
    assert tck.latest_checkpoint(str(tmp_path)).endswith("ckpt_00000005.npz")
    assert tck.latest_checkpoint(str(tmp_path / "none")) is None


def test_trainer_resumes_from_the_latest(tmp_path):
    cfg = get_config("llama3-8b").reduced()
    tm = Model(cfg, dtype=torch.float32, device="cpu")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2)
    logs = []
    _, st, _ = train(tm, dc, TrainConfig(steps=4, log_every=1, ckpt_every=2,
                                         ckpt_dir=str(tmp_path)),
                     log_fn=logs.append)
    assert st.step == 4
    assert tck.latest_checkpoint(str(tmp_path)).endswith("ckpt_00000004.npz")
    logs.clear()
    params, st, hist = train(tm, dc, TrainConfig(
        steps=6, log_every=1, ckpt_every=2, ckpt_dir=str(tmp_path)),
        log_fn=logs.append)
    assert logs[0].startswith("restored") and "step 4" in logs[0]
    assert st.step == 6 and [h["step"] for h in hist] == [5, 6]
    assert not any(p.requires_grad for p in tree_leaves(params))
    assert tree_map(lambda t: t.dtype, params)["embed"] == torch.float32
