"""The port's loss and gradients against the JAX package's on the SSM, hybrid,
MLA and two more dense stacks (fp32, CPU, the same numpy batch and the same
weights), as ``test_torch_training.py`` holds llama3, grok-1, pixtral and
seamless: ``Model.loss`` and the gradient of every leaf equal
``jax.value_and_grad(model.loss)``.

* reduced mamba2-130m (two SSM layers: the plain SSD scan's gradient
  through the conv, the gate norm and the skip term);
* reduced jamba-v0.1-52b (an SSM layer with a dense FFN, then attention
  with an MoE FFN);
* reduced deepseek-v2-236b (MLA: the latent norms, attention at q/k head
  dim 48 and v 32);
* reduced starcoder2-3b and qwen3-32b (the dense family's other attention
  and norm variants).

The batch is 16 tokens, so the SSM layers run one ragged chunk of the
reduced configs' 32. Tolerances: the loss at 1e-5 relative, each leaf
within GRAD_TOL of its largest entry (fp32, two frameworks'
reassociation), but jamba's: JAMBA_GRAD_TOL, stated with its reason.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402
from repro_torch.models.schema import tree_leaves, tree_unflatten  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5  # of each leaf's largest |gradient|
# jamba's ``ssm.dt_bias``: its gradient is the sum, over every position and
# batch row, of dt's gradient through softplus, and the two frameworks'
# SSD scans (one chunked algorithm) sum dt's gradient in different orders;
# on this batch it reads 1.02e-5 of the leaf's largest entry, the only leaf
# of any variant past GRAD_TOL (jamba's next, ``ssm.conv_b``, 5.7e-6; the
# other variants' worst 2.4e-6)
JAMBA_GRAD_TOL = 3e-5

VARIANTS = ("mamba2-130m", "jamba-v0.1-52b", "deepseek-v2-236b",
            "starcoder2-3b", "qwen3-32b")


def _port_grads(model, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), tree_unflatten(params, grads)


@pytest.mark.parametrize("arch", VARIANTS)
def test_loss_and_grads_match_jax(arch):
    cfg = get_config(arch).reduced()
    tm = Model(cfg, dtype=torch.float32, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    jm = JaxModel(jax_get_config(arch).reduced(), dtype=jnp.float32)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    jl, jg = jax.value_and_grad(lambda p: jm.loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    tl, tg = _port_grads(tm, tp, batch)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    tol = JAMBA_GRAD_TOL if arch == "jamba-v0.1-52b" else GRAD_TOL
    got = jax.tree.leaves(params_to_numpy(tg))
    paths = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jg))[0]
    assert len(got) == len(paths)
    for (path, w), g in zip(paths, got):
        assert g.shape == w.shape, (arch, path)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (arch, jax.tree_util.keystr(path), err,
                                    scale)
