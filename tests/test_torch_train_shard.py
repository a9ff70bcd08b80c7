"""The port's sharded training step against the JAX package's jitted one on
4 forced host devices.

One module-scoped fixture runs the JAX side once, in two subprocesses
started together with ``--xla_force_host_platform_device_count=4`` (as
tests/test_torch_shard.py runs its ``shard_map`` side): one in fp32, one
with ``jax_enable_x64`` for the float64 cases. Each case is ``jax.jit`` of
``make_train_step(model, AdamWConfig(), ctx)`` -- one AdamW step, its
gradients read back from the first moment (``m = (1 - b1) * scale * g``
in fp32, which also holds ``value_and_grad(model.loss)``'s rounding
under the gates) -- under ``make_ctx(cfg, mesh, train_4k at seq 64,
batch 4)`` on a (data, model) mesh, the params placed by their
``param_pspecs``. The port runs the same step on a DeviceMesh that names
the CPU in every slot: each slot's block computed on its own, the moves
between slots differentiated by autograd.

Weights come from the port's seeded init, crossed into JAX through numpy
(tests/test_torch_training.py's reason: JAX's scanned init makes the
reduced models so sharp that fp32 reassociation alone parts two
frameworks' gradients by 3e-3 of a leaf's largest).

Gates. Float64 weights (JAX's own sharded-vs-unsharded spread there is at
most 4.9e-7 of a leaf's largest, so a wrong algebra shows, rounding does
not): the loss within 1e-6 relative, every gradient leaf, the updated
params and both moments within 1e-5 of each leaf's largest entry, the grad
norm within 1e-6 relative. The first AdamW step normalises each entry
(``m^ / sqrt(v^)`` is the gradient's sign where |g| >> eps), so entries
whose gradient is near eps amplify rounding into a step of up to the
learning rate: the step runs at ``AdamWConfig()``, JAX's default, whose
warm-up gives 3e-6 at step 1. fp32: the loss within 1e-5 relative, each
gradient leaf within 5e-4 of its largest, ``embed`` within 5e-3 (JAX's
measured fp32 spread of 1.37e-3 to 2.45e-3 in ``embed``, with room).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference runs in subprocesses)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import TRAIN_4K  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import DeviceMesh, LogicalMesh, make_train_mesh  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402
from repro_torch.models.schema import tree_leaves, tree_map  # noqa: E402
from repro_torch.sharding.partition import (  # noqa: E402
    Sharded,
    SlotPass,
    gather_tree,
    make_ctx,
    place_for_train,
    tree_parts,
    tree_with_parts,
)
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    DataConfig,
    TrainConfig,
    adamw_init,
    make_train_step,
    train,
)
from repro_torch.training.checkpoint import (  # noqa: E402
    restore_checkpoint,
    save_checkpoint,
)

B, S = 4, 64
GATES = {"float64": dict(loss=1e-6, grad=1e-5, embed=1e-5, state=1e-5,
                         norm=1e-6),
         "float32": dict(loss=1e-5, grad=5e-4, embed=5e-3, state=None,
                         norm=1e-5)}
# name -> (arch, mesh shape, dtype, capacity_factor or None)
CASES = {
    "llama3_2x2_f64": ("llama3-8b", (2, 2), "float64", None),
    "grok1_2x2_f64": ("grok-1-314b", (2, 2), "float64", None),
    "deepseek_2x2_f64": ("deepseek-v2-236b", (2, 2), "float64", None),
    "llama3_4x1_f64": ("llama3-8b", (4, 1), "float64", None),
    "llama3_1x4_f64": ("llama3-8b", (1, 4), "float64", None),
    "grok1_drops_2x2_f64": ("grok-1-314b", (2, 2), "float64", 0.5),
    "llama3_2x2_f32": ("llama3-8b", (2, 2), "float32", None),
    "grok1_2x2_f32": ("grok-1-314b", (2, 2), "float32", None),
    "deepseek_2x2_f32": ("deepseek-v2-236b", (2, 2), "float32", None),
}

_SCRIPT = r"""
import dataclasses, sys
import numpy as np
import jax
CASES = %(cases)r
if any(c[2] == "float64" for c in CASES.values()):
    jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro.configs import get_config
from repro.configs.shapes import InputShape
from repro.models import Model
from repro.sharding.partition import make_ctx
from repro.training.optimizer import AdamWConfig, adamw_init
from repro.training.steps import make_train_step

assert len(jax.devices()) == 4, jax.devices()
inp = dict(np.load(sys.argv[1]))
out = {}

def tree_of(prefix):
    t = {}
    for k, v in inp.items():
        if k.startswith(prefix + "/"):
            node, parts = t, k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return t

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[prefix + "/" + key] = np.asarray(leaf)

for name, (arch, shape, dtype, cap) in CASES.items():
    cfg = get_config(arch).reduced()
    if cap is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
    dt = getattr(jnp, dtype)
    model = Model(cfg, dtype=dt, remat=True)
    mesh = Mesh(np.asarray(jax.devices()).reshape(shape), ("data", "model"))
    B, S = inp[name + "/tokens"].shape
    ctx = make_ctx(cfg, mesh, InputShape("train_4k", seq_len=S,
                                         global_batch=B, kind="train"))
    where = jax.tree.map(lambda p: NamedSharding(mesh, p),
                         model.param_pspecs(ctx.rules),
                         is_leaf=lambda x: isinstance(x, PartitionSpec))
    params = jax.device_put(jax.tree.map(lambda a: jnp.asarray(a, dt),
                                         tree_of(name + "/params")), where)
    batch = {k: jnp.asarray(inp[name + "/" + k]) for k in ("tokens", "labels")}
    opt = AdamWConfig()
    step = jax.jit(make_train_step(model, opt, ctx))
    new_p, new_o, met = step(params, adamw_init(params), batch)
    # the first step's m is (1 - b1) * scale * g in fp32, scale the clip's
    # min(1, clip / |g|): each gradient read back from it (a second jit of
    # value_and_grad(model.loss) would double the compile time)
    gn = float(met["grad_norm"])
    scale = min(1.0, opt.grad_clip / max(gn, 1e-9))
    out[name + "/loss"] = np.asarray(met["loss"])
    out[name + "/grad_norm"] = np.asarray(gn)
    put(name + "/grads", jax.tree.map(
        lambda m: np.asarray(m, np.float64) / ((1 - opt.b1) * scale),
        new_o.m))
    put(name + "/params", new_p)
    put(name + "/m", new_o.m)
    put(name + "/v", new_o.v)
np.savez(sys.argv[2], **out)
print("JAX_TRAIN_SHARD_OK")
"""


def _config(arch, cap=None):
    cfg = get_config(arch).reduced()
    if cap is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
    return cfg


def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = v


def _inputs():
    """Each case's weights (the port's init, in the case's dtype) and
    batch, as numpy arrays keyed ``case/...``."""
    rng = np.random.default_rng(0)
    out = {}
    for name, (arch, _, dtype, cap) in CASES.items():
        cfg = _config(arch, cap)
        model = Model(cfg, dtype=getattr(torch, dtype), device="cpu")
        _flat(name + "/params", params_to_numpy(
            model.init(torch.Generator().manual_seed(0))), out)
        for k in ("tokens", "labels"):
            out[f"{name}/{k}"] = rng.integers(0, cfg.vocab_size,
                                              (B, S)).astype(np.int32)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side on one intra-op thread: the reduced models' products
    are small, and beside the other test workers more threads only
    contend (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(the inputs, JAX's outputs), both as flat ``case/...`` dicts."""
    tmp = tmp_path_factory.mktemp("train_shard")
    inputs = _inputs()
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["JAX_PLATFORMS"] = "cpu"
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for dtype in ("float64", "float32"):  # x64 is process-wide: one each
        cases = {k: v for k, v in CASES.items() if v[2] == dtype}
        path = tmp / f"out_{dtype}.npz"
        procs.append((path, subprocess.Popen(
            [sys.executable, "-c", _SCRIPT % {"cases": cases},
             str(tmp / "in.npz"), str(path)], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    outputs = {}
    for path, proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{stdout}\n{stderr[-4000:]}"
        assert "JAX_TRAIN_SHARD_OK" in stdout
        with np.load(path) as z:
            outputs.update(dict(z))
    return inputs, outputs


def _tree(npz, prefix):
    out = {}
    for key, arr in npz.items():
        if key.startswith(prefix + "/"):
            node, parts = out, key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return out


def _mesh(shape):
    return DeviceMesh(np.full(shape, "cpu", dtype=object), ("data", "model"))


def _ctx(cfg, shape):
    return make_ctx(cfg, _mesh(shape), dataclasses.replace(
        TRAIN_4K, seq_len=S, global_batch=B))


def _case_model(name, inputs):
    """(model, ctx, the weights as the port's tree, batch) of a case."""
    from repro_torch.models.convert import params_from_numpy

    arch, shape, dtype, cap = CASES[name]
    cfg = _config(arch, cap)
    model = Model(cfg, dtype=getattr(torch, dtype), device="cpu", remat=True)
    params = params_from_numpy(_tree(inputs, name + "/params"), cfg,
                               device="cpu")
    batch = {k: torch.as_tensor(inputs[f"{name}/{k}"])
             for k in ("tokens", "labels")}
    return model, _ctx(cfg, shape), params, batch


def _sharded_grads(model, ctx, placed, batch):
    parts = tree_parts(placed)
    for p in parts:
        p.requires_grad_(True)
    loss = model.loss(placed, batch, shard_ctx=ctx)
    grads = torch.autograd.grad(loss, parts, allow_unused=True)
    for p in parts:
        p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, parts)]
    return float(loss.detach()), tree_map(lambda g: g.sum_copies(),
                                 tree_with_parts(placed, grads))


_PORT = {}


def _port(name, inputs):
    """The port's sharded loss, gradients and one step of a case (once)."""
    if name not in _PORT:
        model, ctx, params, batch = _case_model(name, inputs)
        placed = place_for_train(model, ctx, params)
        loss, grads = _sharded_grads(model, ctx, placed, batch)
        state = adamw_init(placed)
        new, state, met = make_train_step(model, AdamWConfig(), ctx)(
            placed, state, batch)
        _PORT[name] = dict(loss=loss, grads=grads, params=new, m=state.m,
                           v=state.v, grad_norm=float(met["grad_norm"]),
                           step_loss=float(met["loss"]))
    return _PORT[name]


def _leaf_gaps(port_tree, want_tree):
    """{path: |port - want| / max |want|} over every leaf (the port's
    Sharded leaves gathered, stacked into JAX's layout)."""
    got = params_to_numpy(gather_tree(port_tree, "cpu"))
    flat_got, flat_want = {}, {}
    _flat("", got, flat_got)
    _flat("", want_tree, flat_want)
    assert sorted(flat_got) == sorted(flat_want)
    out = {}
    for k, w in flat_want.items():
        g = flat_got[k]
        assert g.shape == w.shape, k
        scale = float(np.abs(w).max())
        err = float(np.abs(g.astype(np.float64) - w).max())
        out[k] = err / scale if scale else (0.0 if err == 0 else np.inf)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_jax(jax_side, name):
    """Loss, every gradient leaf, the grad norm, and after one AdamW step
    the params and both moments, against JAX's jitted sharded step."""
    inputs, want = jax_side
    dtype = CASES[name][2]
    gate = GATES[dtype]
    got = _port(name, inputs)
    jl = float(want[name + "/loss"])
    gaps = {part: max(_leaf_gaps(got[part],
                                 _tree(want, f"{name}/{part}")).values())
            for part in ("grads", "params", "m", "v")}
    print(f"{name}: loss {abs(got['loss'] - jl) / abs(jl):.2e} relative, "
          "worst leaf of its largest: " + ", ".join(
              f"{k} {v:.2e}" for k, v in gaps.items()))
    assert abs(got["loss"] - jl) <= gate["loss"] * abs(jl), (got["loss"], jl)
    assert abs(got["step_loss"] - jl) <= gate["loss"] * abs(jl)
    gn = float(want[name + "/grad_norm"])
    assert abs(got["grad_norm"] - gn) <= gate["norm"] * gn, \
        (got["grad_norm"], gn)
    for key, err in _leaf_gaps(got["grads"],
                               _tree(want, name + "/grads")).items():
        tol = gate["embed"] if key == "/embed" else gate["grad"]
        assert err <= tol, (name, "grad", key, err)
    if gate["state"] is not None:
        for part in ("params", "m", "v"):
            for key, err in _leaf_gaps(got[part],
                                       _tree(want, f"{name}/{part}")).items():
                assert err <= gate["state"], (name, part, key, err)


@pytest.mark.parametrize("name", ["llama3_2x2_f64", "grok1_2x2_f64",
                                  "deepseek_2x2_f64", "llama3_4x1_f64",
                                  "llama3_1x4_f64"])
def test_sharded_step_equals_the_unsharded_port(jax_side, name):
    """The sharded step's loss and gradients against the port's own
    unsharded step on the same weights (float64: the same algebra, so
    within the float64 gates)."""
    inputs, _ = jax_side
    model, _, params, batch = _case_model(name, inputs)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss = loss.detach()
    got = _port(name, inputs)
    assert abs(got["loss"] - float(loss)) <= 1e-6 * abs(float(loss))
    for g, s in zip(grads, tree_leaves(got["grads"])):
        s = s.gather()
        g = torch.zeros_like(s) if g is None else g
        scale = float(g.abs().max())
        assert float((g - s).abs().max()) <= 1e-5 * max(scale, 1e-30)


def test_sharded_loss_mask_is_the_global_masked_mean():
    """With a ``loss_mask`` the sharded loss is the global masked sum over
    the global count (not a mean of per-slot means): equal to the
    unsharded masked loss in float64, here with a mask that leaves one
    data slot's rows almost empty."""
    cfg = _config("llama3-8b")
    model = Model(cfg, dtype=torch.float64, device="cpu", remat=True)
    params = model.init(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
             for k in ("tokens", "labels")}
    mask = torch.zeros((B, S), dtype=torch.int32)
    mask[:2] = 1
    mask[2, :5] = 1
    batch["loss_mask"] = mask
    with torch.no_grad():
        want = float(model.loss(params, batch))
        ctx = _ctx(cfg, (2, 2))
        got = float(model.loss(place_for_train(model, ctx, params), batch,
                               shard_ctx=ctx))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v2-236b"])
def test_a_batch_the_data_axis_does_not_split(arch):
    """A batch of 1 on 2 x 2: the rules leave the batch whole, only the
    slots of data index 0 compute (the others lend their FSDP blocks), and
    the loss and every gradient equal the unsharded pass's (float64)."""
    cfg = _config(arch)
    model = Model(cfg, dtype=torch.float64, device="cpu", remat=True)
    params = model.init(torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    batch = {k: torch.randint(0, cfg.vocab_size, (1, S), generator=g)
             for k in ("tokens", "labels")}
    ctx = make_ctx(cfg, _mesh((2, 2)), dataclasses.replace(
        TRAIN_4K, seq_len=S, global_batch=1))
    assert ctx.rules["batch"] is None
    assert SlotPass(ctx, 1, S).coords == [(0, 0), (0, 1)]
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    want = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss = loss.detach()
    for p in leaves:
        p.requires_grad_(False)
    got_loss, got = _sharded_grads(model, ctx,
                                   place_for_train(model, ctx, params), batch)
    assert abs(got_loss - float(loss)) <= 1e-6 * abs(float(loss))
    for w, s in zip(want, tree_leaves(got)):
        s = s.gather()
        w = torch.zeros_like(s) if w is None else w
        assert float((w - s).abs().max()) <= 1e-5 * max(
            float(w.abs().max()), 1e-30)


def test_replicated_kv_heads_take_the_columns_their_queries_read():
    """8 query heads over 2 kv heads on a 1 x 4 mesh: ``kv_heads`` does not
    divide ``model`` and stays whole (Megatron's GQA), each slot's 2 query
    heads read 1 kv head's columns of the replicated ``wk``/``wv``, and
    the loss and gradients equal the unsharded pass's (float64); a shard
    that would split a GQA group is refused."""
    from repro_torch.models.attention import kv_columns

    cfg = dataclasses.replace(_config("llama3-8b"), n_heads=8, n_kv_heads=2,
                              head_dim=32)
    model = Model(cfg, dtype=torch.float64, device="cpu", remat=True)
    params = model.init(torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
             for k in ("tokens", "labels")}
    ctx = _ctx(cfg, (1, 4))
    assert ctx.rules["heads"] == "model" and ctx.rules["kv_heads"] is None
    assert [kv_columns(cfg, 2 * i, 2) for i in range(4)] == [
        (0, 1), (0, 1), (1, 2), (1, 2)]
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    want = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    for p in leaves:
        p.requires_grad_(False)
    got_loss, got = _sharded_grads(model, ctx,
                                   place_for_train(model, ctx, params), batch)
    assert abs(got_loss - float(loss)) <= 1e-6 * abs(float(loss))
    for w, s in zip(want, tree_leaves(got)):
        assert float((w - s.gather()).abs().max()) <= 1e-5 * float(
            w.abs().max())
    odd = dataclasses.replace(cfg, n_heads=24, n_kv_heads=6)  # groups of 4
    with pytest.raises(ValueError, match="splits GQA groups"):
        kv_columns(odd, 3, 3)


def _check_layout(tree, specs, mesh):
    for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        assert isinstance(leaf, Sharded), type(leaf)
        assert leaf.spec == tuple(spec)
        counts = leaf.counts()
        for coord in mesh.coords():
            t = leaf.locals[coord]
            assert t.device == mesh.device_at(coord)
            assert tuple(t.shape) == tuple(
                n // k for n, k in zip(leaf.shape, counts)), (spec, t.shape)


@pytest.mark.parametrize("name", ["llama3_2x2_f64", "grok1_2x2_f64",
                                  "deepseek_2x2_f64", "llama3_4x1_f64",
                                  "llama3_1x4_f64"])
def test_params_grads_and_moments_sit_on_their_slots(jax_side, name):
    """Under a train_4k context every parameter leaf, its gradient and both
    moments are Sharded by ``param_pspecs(ctx.rules)``: each slot's block
    on the slot's device, of the spec's block shape, and no leaf whose
    spec splits it held whole."""
    inputs, _ = jax_side
    model, ctx, _, _ = _case_model(name, inputs)
    specs = model.param_pspecs(ctx.rules)
    got = _port(name, inputs)
    for part in ("params", "grads", "m", "v"):
        _check_layout(got[part], specs, ctx.mesh)
    split = [leaf for leaf in tree_leaves(got["params"])
             if any(n > 1 for n in leaf.counts())]
    assert split, "no leaf split"
    for leaf in split:
        assert all(t.shape != leaf.shape for t in leaf.parts())
    if ctx.mesh.shape["data"] > 1:  # FSDP: every leaf with an embed dim
        assert ctx.rules["embed"] == "data"
        assert got["params"]["embed"].counts() == (
            ctx.mesh.shape["model"], ctx.mesh.shape["data"])


def test_sharded_plan_drops_what_the_unsharded_one_drops(jax_side):
    """grok-1 at capacity_factor 0.5: the sharded layer builds its dispatch
    plan from the global tokens, so it keeps and drops exactly the
    (token, slot) pairs of the unsharded pass, and some are dropped."""
    inputs, _ = jax_side
    name = "grok1_drops_2x2_f64"
    model, ctx, params, batch = _case_model(name, inputs)
    plans = []
    real = moe.dispatch_plan

    def record(ids, n_experts, C):
        out = real(ids, n_experts, C)
        plans.append((ids.clone(),) + tuple(t.clone() for t in out))
        return out

    orig = moe.dispatch_plan
    moe.dispatch_plan = record
    try:
        with torch.no_grad():
            model.loss(params, batch)
            n = len(plans)
            model.loss(place_for_train(model, ctx, params), batch,
                       shard_ctx=ctx)
    finally:
        moe.dispatch_plan = orig
    assert n == model.cfg.n_layers and len(plans) == 2 * n
    for a, b in zip(plans[:n], plans[n:]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert not all(bool(p[2].all()) for p in plans[:n])  # drops happened


def test_vocab_parallel_nll_never_builds_the_whole_logits():
    """On a 1 x 4 mesh each matrix product of the loss is one vocab block
    wide (V/4), never V; the NLL equals the tied head's cross-entropy, and
    the table's gradient equals the plain one (the max shift carries
    none)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = get_config("llama3-8b").reduced()
    ctx = _ctx(cfg, (1, 4))
    g = torch.Generator().manual_seed(1)
    table = torch.randn(512, 32, generator=g, dtype=torch.float64)
    x = torch.randn(B, S, 32, generator=g, dtype=torch.float64)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    sp = SlotPass(ctx, B, S)
    tab = Sharded.split(table, ctx.mesh, ctx.spec("vocab", "embed"))
    xs = Sharded.split(x, ctx.mesh, sp.act_spec)
    widths = []

    products = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)

    class Widths(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in products:
                widths.append(out.shape[-1])
            return out

    parts = tab.parts()
    for p in parts:
        p.requires_grad_(True)
    with Widths():
        nll = layers.vocab_parallel_nll(xs, tab, labels, sp, cfg.vocab_size)
    assert widths and set(widths) == {512 // 4}
    (gs,) = torch.autograd.grad(nll.mean(), [parts[0]])
    t = table.clone().requires_grad_(True)
    want = layers.cross_entropy(layers.lm_head(t, x, cfg.vocab_size), labels)
    (gw,) = torch.autograd.grad(want, [t])
    assert abs(float(nll.detach().mean()) - float(want.detach())) <= \
        1e-6 * float(want.detach())
    assert torch.allclose(gs, gw[:128], rtol=0, atol=1e-6 * float(gw.abs().max()))


def test_sharded_checkpoint_restores_unsharded_bitwise(jax_side, tmp_path):
    """A sharded save gathers every leaf into the unsharded file format:
    an unsharded restore gives the gathered params and moments bit for
    bit, and a sharded restore re-places them on their slots."""
    inputs, _ = jax_side
    name = "grok1_2x2_f64"
    model, ctx, params, _ = _case_model(name, inputs)
    got = _port(name, inputs)
    state = adamw_init(got["params"])._replace(step=1, m=got["m"], v=got["v"])
    path = save_checkpoint(str(tmp_path), 1, got["params"], state)
    plain, plain_state, step = restore_checkpoint(path, params,
                                                  adamw_init(params))
    assert step == 1 and plain_state.step == 1
    for tree, want in ((plain, got["params"]), (plain_state.m, got["m"]),
                       (plain_state.v, got["v"])):
        for a, b in zip(tree_leaves(tree), tree_leaves(want)):
            assert not isinstance(a, Sharded)
            assert torch.equal(a, b.gather())
    back, back_state, _ = restore_checkpoint(path, got["params"], state)
    _check_layout(back, model.param_pspecs(ctx.rules), ctx.mesh)
    for a, b in zip(tree_leaves(back) + tree_leaves(back_state.v),
                    tree_leaves(got["params"]) + tree_leaves(got["v"])):
        assert torch.equal(a.gather(), b.gather())


def test_sharded_trainer_runs_the_sharded_step():
    """``train(..., shard_ctx=)`` places the weights it draws, splits each
    batch by ``batch`` and runs ``make_train_step(model, opt, ctx)``: its
    params and moments after 2 steps equal, bit for bit, 2 such steps on
    the same batches (whole here) from the same placed weights, and come
    back as Sharded leaves that need no grad. (The sharded step against
    the unsharded one: :func:`test_sharded_step_equals_the_unsharded_port`.)"""
    from repro_torch.training.data import make_dataset

    cfg = _config("llama3-8b")
    model = Model(cfg, dtype=torch.float64, device="cpu", remat=True)
    ctx = _ctx(cfg, (2, 2))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    p1, s1, h1 = train(model, data, TrainConfig(steps=2, log_every=1), opt,
                       shard_ctx=ctx, log_fn=lambda _: None)
    assert len(h1) == 2 and all(np.isfinite(h["loss"]) for h in h1)
    assert all(isinstance(t, Sharded) and not t.parts()[0].requires_grad
               for t in tree_leaves(p1))
    params = place_for_train(model, ctx,
                             model.init(torch.Generator().manual_seed(0)))
    state = adamw_init(params)
    step = make_train_step(model, opt, ctx)
    batches = make_dataset(data).batches()
    for h in h1:
        params, state, met = step(params, state, {
            k: torch.as_tensor(v) for k, v in next(batches).items()})
        assert float(met["loss"]) == h["loss"]
    assert s1.step == state.step == 2
    for a, b in zip(tree_leaves(p1) + tree_leaves(s1.m),
                    tree_leaves(params) + tree_leaves(state.m)):
        assert torch.equal(a.gather(), b.gather())


def test_check_fits_counts_the_largest_devices_share():
    """llama3-8b at 32 layers: 90.1 GB of state in all, 22.5 GB a device
    on a 4-way ``data`` mesh (every leaf split over its embed dim), all of
    it where the mesh names one device four times; one card refuses it
    with both numbers."""
    model = Model(get_config("llama3-8b"), device="cpu")
    total = launch_train.STATE_BYTES_PER_PARAM * launch_train.param_count(
        model)
    assert round(total / 1e9, 1) == 90.1
    ctx = make_ctx(model.cfg, LogicalMesh(("data", "model"), (4, 1)),
                   TRAIN_4K)
    share = launch_train.check_fits(model, ctx, capacity=80e9)
    assert share == total // 4 and round(share / 1e9, 1) == 22.5
    named = make_ctx(model.cfg, _mesh((4, 1)), TRAIN_4K)
    assert launch_train.state_share(model, named) == total
    one = make_ctx(model.cfg, LogicalMesh(("data", "model"), (1, 1)),
                   TRAIN_4K)
    with pytest.raises(ValueError, match=r"90\.1 GB.*80\.0 GB"):
        launch_train.check_fits(model, one, capacity=80e9)
    assert make_train_mesh(device="cpu").shape == {"data": 1, "model": 1}
