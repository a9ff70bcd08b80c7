"""The dense family's training against the JAX package's, and the launch
count the card run is held to.

* ``Model.loss`` and the gradient of every leaf of reduced qwen3-32b
  (qk-norm kept: ``q_norm`` / ``k_norm`` held by name), starcoder2-3b (GQA
  at kv 2) and granite-34b (MQA, kv 1) equal
  ``jax.value_and_grad(model.loss)`` on the same weights and batch (fp32,
  CPU), the port under full remat as the card trains it, over a batch
  with a loss mask. JAX runs once for the module (one fixture).
* ``chip_smoke.py``'s ``train_structure`` -- the kernel launches a
  training step must make on the card -- equals what the kernel ops tally
  in one training pass on the meta device (forward, its recompute under
  full remat, backward) for every configuration: qwen3's qk-norm runs two
  rmsnorm launches a layer more.

Weights come from the port's seeded init, stacked into JAX's layout by
``params_to_numpy`` (as ``test_torch_training.py``). Tolerances: the loss
at 1e-5 relative, every gradient leaf within GRAD_TOL of its largest entry
(fp32, two frameworks' reassociation).
"""

import collections
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import FRONTEND_DIM, Model  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402
from repro_torch.models.schema import tree_leaves, tree_unflatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5  # of each leaf's largest |gradient|
ARCHS = ("qwen3-32b", "starcoder2-3b", "granite-34b")


def _batch(vocab, seed=3, B=2, S=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "loss_mask": (rng.random((B, S)) < 0.8).astype(np.int32)}


def _port(arch):
    cfg = get_config(arch).reduced()
    model = Model(cfg, dtype=torch.float32, device="cpu", remat=True,
                  remat_policy="full")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def jax_side():
    """JAX's loss and gradients of each variant on the port's weights."""
    out = {}
    for arch in ARCHS:
        cfg, _, tp = _port(arch)
        jm = JaxModel(jax_get_config(arch).reduced(), dtype=jnp.float32)
        batch = _batch(cfg.vocab_size)
        jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jm.loss(
            p, {k: jnp.asarray(v) for k, v in batch.items()})))(jp)
        out[arch] = (float(loss), jax.tree.map(np.asarray, grads))
    return out


def _port_grads(model, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [
        torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(jax_side, arch):
    cfg, model, params = _port(arch)
    loss, grads = _port_grads(model, params, _batch(cfg.vocab_size))
    want_loss, want = jax_side[arch]
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    got = jax.tree.leaves(params_to_numpy(
        tree_unflatten(params, [g.detach() for g in grads])))
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got) == len(paths)
    names = {p[-1].key for p, _ in paths}
    assert cfg.qk_norm == ({"q_norm", "k_norm"} <= names)  # qwen3's leaves
    for (path, w), g in zip(paths, got):
        assert g.shape == w.shape, (arch, path)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale, (arch, jax.tree_util.keystr(path),
                                         err, scale)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Tally:
    def __init__(self):
        self.calls = collections.Counter()

    def add_kernel(self, name, flops, nbytes, axes):
        self.calls[name] += 1


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_smoke_train_structure_equals_the_meta_pass(arch):
    """One training step's launches as the card run counts them
    (``chip_smoke.train_structure``) against the kernel ops a meta pass
    tallies: the loss under full remat and ``torch.autograd.grad`` of every
    leaf."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="meta", remat=True, remat_policy="full")
    params = model.param_specs()
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.zeros((2, 16), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    if cfg.frontend:
        batch["features"] = torch.zeros((2, 8, FRONTEND_DIM), device="meta")
    tally = _Tally()
    ops.META_TALLIES.append(tally)
    try:
        loss = model.loss(params, batch)
        torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        ops.META_TALLIES.remove(tally)
    want = {k: v for k, v in _chip_smoke().train_structure(cfg, 1).items()
            if v}
    assert dict(tally.calls) == want
