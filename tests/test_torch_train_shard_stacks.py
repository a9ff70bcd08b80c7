"""The port's sharded training step for the SSM, hybrid, encoder-decoder and
VLM stacks (mamba2-130m, jamba-v0.1-52b, seamless-m4t-large-v2,
pixtral-12b) against the JAX package's jitted one on 4 forced host devices.

As tests/test_torch_train_shard.py does for the attention stacks (whose
helpers it imports): one
module-scoped fixture runs JAX's side once, in subprocesses started
together with ``--xla_force_host_platform_device_count=4`` (the float64
cases, under ``jax_enable_x64``, split over two of them; the fp32 cases in
a third). Each case is ``jax.jit`` of ``make_train_step(model,
AdamWConfig(), ctx)`` under ``make_ctx(cfg, mesh, train_4k at seq 64,
batch 4)`` on a (data, model) mesh, its gradients read back from the first
moment; the VLM and the encoder-decoder take 16 feature rows (a VLM's
prepended, 80 positions in all; an encoder-decoder's its encoder's
frames). The port runs the same step on a DeviceMesh that names the CPU in
every slot. Weights come from the port's init, crossed into JAX through
numpy. JAX's ``ssd_chunked`` starts its scan's state carry in fp32, which
``lax.scan`` refuses beside float64 states: the float64 processes run it
with that carry in the states' dtype (a copy of its source with that one
change), the fp32 process as it is.

Gates, tests/test_torch_train_shard.py's: float64 -- the loss within 1e-6
relative, every gradient leaf, updated param and moment within 1e-5 of its
largest entry, the grad norm within 1e-6 relative; fp32 -- the loss within
1e-5, each gradient leaf within 5e-4 of its largest, ``embed`` within
5e-3. One exception: a
leaf the schema starts at zero (the SSM's ``conv_b``, ``A_log`` and
``dt_bias``) is, after one step, AdamW's first update alone, each entry
its gradient over its own magnitude plus eps. The float64 pass keeps the
NLL's logits in fp32 (as JAX's does), whose rounding moves a gradient
entry by about 3e-8 of its leaf's largest; where the entry itself is near
eps (2.1e-7 against 1e-8) the division makes that 1e-4 of the step.
JAX's own sharded and unsharded steps part by 8.8e-6 in mamba2's
``conv_b``; the port's reach 1.3e-4 (2 x 2, 4 x 1). Such a leaf's updated
params are held at the fp32 gate, 5e-4; its moments at 1e-5.
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

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.schema import tree_leaves, tree_map  # noqa: E402
from repro_torch.sharding.partition import (  # noqa: E402
    Sharded,
    place_for_train,
)
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    DataConfig,
    TrainConfig,
    adamw_init,
    make_train_step,
    train,
)
from test_torch_train_shard import (  # noqa: E402  (its helpers)
    _config,
    _ctx,
    _flat,
    _leaf_gaps,
    _sharded_grads,
    _tree,
)

B, S, F = 4, 64, 16
GATES = {"float64": dict(loss=1e-6, grad=1e-5, embed=1e-5, state=1e-5,
                         norm=1e-6),
         "float32": dict(loss=1e-5, grad=5e-4, embed=5e-3, state=None,
                         norm=1e-5)}
MAMBA, JAMBA = "mamba2-130m", "jamba-v0.1-52b"
SEAMLESS, PIXTRAL = "seamless-m4t-large-v2", "pixtral-12b"
# name -> (arch, mesh shape, dtype, capacity_factor or None, loss_mask)
CASES = {
    "mamba2_2x2_f64": (MAMBA, (2, 2), "float64", None, False),
    "jamba_2x2_f64": (JAMBA, (2, 2), "float64", None, False),
    "seamless_2x2_f64": (SEAMLESS, (2, 2), "float64", None, False),
    "pixtral_2x2_f64": (PIXTRAL, (2, 2), "float64", None, False),
    "mamba2_1x4_f64": (MAMBA, (1, 4), "float64", None, False),
    "mamba2_4x1_f64": (MAMBA, (4, 1), "float64", None, False),
    "jamba_drops_2x2_f64": (JAMBA, (2, 2), "float64", 0.5, False),
    "pixtral_mask_2x2_f64": (PIXTRAL, (2, 2), "float64", None, True),
    "mamba2_2x2_f32": (MAMBA, (2, 2), "float32", None, False),
    "jamba_2x2_f32": (JAMBA, (2, 2), "float32", None, False),
    "seamless_2x2_f32": (SEAMLESS, (2, 2), "float32", None, False),
    "pixtral_2x2_f32": (PIXTRAL, (2, 2), "float32", None, False),
}
F64 = sorted(k for k, v in CASES.items() if v[2] == "float64")
BATCH_KEYS = ("tokens", "labels", "features", "loss_mask")

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
if jax.config.jax_enable_x64:
    # ssd_chunked's scan starts its state carry in fp32 whatever the
    # inputs' dtype, and lax.scan refuses a float64 state beside it: the
    # float64 reference runs it with the carry in the states' dtype, its
    # one change
    import inspect
    from repro.models import mamba
    src = inspect.getsource(mamba.ssd_chunked)
    old = "jnp.zeros((b, nh, hd, ds), jnp.float32)"
    assert src.count(old) == 1
    exec(src.replace(old, "jnp.zeros((b, nh, hd, ds), states.dtype)"),
         mamba.__dict__)
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

for name, (arch, shape, dtype, cap, _) in CASES.items():
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
    batch = {k: jnp.asarray(inp[name + "/" + k])
             for k in %(keys)r if name + "/" + k in inp}
    opt = AdamWConfig()
    step = jax.jit(make_train_step(model, opt, ctx))
    new_p, new_o, met = step(params, adamw_init(params), batch)
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


def _mask():
    """Rows 0 and 1 whole, row 2's first 5 tokens, row 3 none: one data
    slot's rows almost empty."""
    m = np.zeros((B, S), dtype=np.int32)
    m[:2] = 1
    m[2, :5] = 1
    return m


def _inputs():
    """Each case's weights (the port's init, in the case's dtype) and
    batch, as numpy arrays keyed ``case/...``."""
    rng = np.random.default_rng(0)
    out = {}
    for name, (arch, _, dtype, cap, mask) in CASES.items():
        cfg = _config(arch, cap)
        model = Model(cfg, dtype=getattr(torch, dtype), device="cpu")
        _flat(name + "/params", params_to_numpy(
            model.init(torch.Generator().manual_seed(0))), out)
        for k in ("tokens", "labels"):
            out[f"{name}/{k}"] = rng.integers(0, cfg.vocab_size,
                                              (B, S)).astype(np.int32)
        if cfg.frontend:
            out[f"{name}/features"] = rng.standard_normal(
                (B, F, 1024)).astype(np.float32)
        if mask:
            out[f"{name}/loss_mask"] = _mask()
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side on one intra-op thread (restored after the
    module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(the inputs, JAX's outputs), both as flat ``case/...`` dicts."""
    tmp = tmp_path_factory.mktemp("train_shard_stacks")
    inputs = _inputs()
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["JAX_PLATFORMS"] = "cpu"
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    # x64 is process-wide: float64 in two processes, fp32 in a third
    groups = [F64[0::2], F64[1::2],
              sorted(k for k in CASES if k not in F64)]
    procs = []
    for i, names in enumerate(groups):
        path = tmp / f"out_{i}.npz"
        script = _SCRIPT % {"cases": {k: CASES[k] for k in names},
                            "keys": BATCH_KEYS}
        procs.append((path, subprocess.Popen(
            [sys.executable, "-c", script, str(tmp / "in.npz"), str(path)],
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)))
    outputs = {}
    for path, proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{stdout}\n{stderr[-4000:]}"
        assert "JAX_TRAIN_SHARD_OK" in stdout
        with np.load(path) as z:
            outputs.update(dict(z))
    return inputs, outputs


def _case_model(name, inputs, remat=True):
    """(model, ctx, the weights as the port's tree, batch) of a case."""
    arch, shape, dtype, cap, _ = CASES[name]
    cfg = _config(arch, cap)
    model = Model(cfg, dtype=getattr(torch, dtype), device="cpu",
                  remat=remat)
    params = params_from_numpy(_tree(inputs, name + "/params"), cfg,
                               device="cpu")
    batch = {k: torch.as_tensor(inputs[f"{name}/{k}"]) for k in BATCH_KEYS
             if f"{name}/{k}" in inputs}
    return model, _ctx(cfg, shape), params, batch


def _plain_grads(model, params, batch):
    """The port's unsharded loss and gradient leaves."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                                  for g, p in zip(grads, leaves)]


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


def _zero_leaves(name):
    """The stacked paths ("/decoder/g0/l0/ssm/conv_b", ...) of a case's
    leaves that the schema starts at zero."""
    model = Model(_config(CASES[name][0], CASES[name][3]), device="cpu")
    out = {}
    _flat("", params_to_numpy(tree_map(
        lambda s: torch.tensor(float(s.init == "zeros")), model.schema())),
        out)
    return {k for k, v in out.items() if v.all()}


def _rel(a, b):
    """max |a - b| over max |b| (0 where both are 0)."""
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    return err / scale if scale else (0.0 if err == 0 else np.inf)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_jax(jax_side, name):
    """Loss, every gradient leaf, the grad norm, and after one AdamW step
    the params and both moments, against JAX's jitted sharded step."""
    inputs, want = jax_side
    gate = GATES[CASES[name][2]]
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
        zero = _zero_leaves(name)
        for part in ("params", "m", "v"):
            for key, err in _leaf_gaps(got[part],
                                       _tree(want, f"{name}/{part}")).items():
                tol = (GATES["float32"]["grad"]
                       if part == "params" and key in zero
                       else gate["state"])
                assert err <= tol, (name, part, key, err)


@pytest.mark.parametrize("name", F64)
def test_sharded_step_equals_the_unsharded_port(jax_side, name):
    """The sharded step's loss and gradients against the port's own
    unsharded step on the same weights and batch (float64: the same
    algebra, so within the float64 gates)."""
    inputs, _ = jax_side
    model, _, params, batch = _case_model(name, inputs)
    loss, grads = _plain_grads(model, params, batch)
    got = _port(name, inputs)
    assert abs(got["loss"] - loss) <= 1e-6 * abs(loss)
    for g, s in zip(grads, tree_leaves(got["grads"])):
        assert _rel(s.gather(), g) <= 1e-5


@pytest.mark.parametrize("remat", [True, False])
def test_the_encoder_takes_the_cross_attention_gradient(jax_side, remat):
    """Every encoder leaf's gradient, which reaches it only through the
    decoder layers' cross-attention, is nonzero and equals the unsharded
    pass's (float64), with each layer fully rematerialised (the
    rematerialised layer is handed the encoder output's blocks, or it
    would send nothing back into the encoder) and without."""
    inputs, _ = jax_side
    model, ctx, params, batch = _case_model("seamless_2x2_f64", inputs,
                                            remat=remat)
    _, want = _plain_grads(model, params, batch)
    _, got = _sharded_grads(model, ctx, place_for_train(model, ctx, params),
                            batch)
    names = [k for k, _ in sorted(params.items())
             for _ in tree_leaves(params[k])]
    enc = [(w, s) for k, w, s in zip(names, want, tree_leaves(got))
           if k in ("encoder", "enc_norm", "frontend_proj")]
    assert len(enc) == len(tree_leaves(params["encoder"])) + 2
    for w, s in enc:
        assert float(w.abs().max()) > 0
        assert _rel(s.gather(), w) <= 1e-5


@pytest.mark.parametrize("shape,heads", [((2, 2), 8), ((1, 4), 4),
                                         ((4, 1), 16)])
def test_the_ssd_scan_runs_on_a_slots_heads(shape, heads, monkeypatch):
    """Under ``ssm_heads`` over ``model`` every slot runs the SSD scan once
    a layer on its own heads (reduced mamba2's 16 over the ``model``
    count) and the rmsnorm kernel on whole gated rows of ``d_in``; the
    sharded loss equals the unsharded one (float64)."""
    cfg = _config(MAMBA)
    model = Model(cfg, dtype=torch.float64, device="cpu")
    params = model.init(torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
             for k in ("tokens", "labels")}
    ctx = _ctx(cfg, shape)
    assert ctx.rules["ssm_heads"] == ctx.rules["ssm_in"] == "model"
    scans, norms = [], []
    real_scan, real_norm = ops.ssd_scan, ops.rmsnorm

    def scan(x, *a, **k):
        scans.append(tuple(x.shape))
        return real_scan(x, *a, **k)

    def norm(x, *a, **k):
        norms.append(x.shape[-1])
        return real_norm(x, *a, **k)

    monkeypatch.setattr(ops, "ssd_scan", scan)
    monkeypatch.setattr(ops, "rmsnorm", norm)
    with torch.no_grad():
        want = float(model.loss(params, batch))
        scans.clear()
        norms.clear()
        got = float(model.loss(place_for_train(model, ctx, params), batch,
                               shard_ctx=ctx))
    slots = 4  # every slot computes: the batch splits over data
    b = B // shape[0]
    assert scans == [(b, S, heads, cfg.ssm.head_dim)] * (slots
                                                         * cfg.n_layers)
    d_in = cfg.d_model * cfg.ssm.expand
    assert norms.count(d_in) == slots * cfg.n_layers
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


def test_feature_rows_that_do_not_split_are_refused():
    """A VLM's feature rows and tokens span one pass of F + S positions
    split over ``act_seq``: F + S = 79 does not split over model = 2, and
    the port raises ValueError (it pads no block, where GSPMD would)."""
    cfg = _config(PIXTRAL)
    model = Model(cfg, dtype=torch.float32, device="cpu")
    ctx = _ctx(cfg, (2, 2))
    placed = place_for_train(model, ctx,
                             model.init(torch.Generator().manual_seed(0)))
    toks = torch.zeros((B, S), dtype=torch.int64)
    batch = {"tokens": toks, "labels": toks,
             "features": torch.zeros((B, 15, 1024))}
    with torch.no_grad(), pytest.raises(ValueError, match="does not split"):
        model.loss(placed, batch, shard_ctx=ctx)


@pytest.mark.parametrize("name", ["seamless_2x2_f64", "mamba2_1x4_f64"])
def test_params_grads_and_moments_sit_on_their_slots(jax_side, name):
    """Every parameter leaf, its gradient and both moments are Sharded by
    ``param_pspecs(ctx.rules)``, each slot's block on its device and of
    the spec's block shape -- the encoder's, the frontend's and the SSM's
    leaves included."""
    inputs, _ = jax_side
    model, ctx, _, _ = _case_model(name, inputs)
    specs = model.param_pspecs(ctx.rules)
    got = _port(name, inputs)
    for part in ("params", "grads", "m", "v"):
        for leaf, spec in zip(tree_leaves(got[part]), tree_leaves(specs)):
            assert isinstance(leaf, Sharded) and leaf.spec == tuple(spec)
            for coord in ctx.mesh.coords():
                t = leaf.locals[coord]
                assert t.device == ctx.mesh.device_at(coord)
                assert tuple(t.shape) == tuple(
                    n // k for n, k in zip(leaf.shape, leaf.counts()))
    params = got["params"]
    if model.cfg.is_encdec:  # embed over data, heads over model
        assert params["encoder"]["g0"][0]["attn"]["wq"].counts() == (2, 2)
        assert params["frontend_proj"].counts() == (1, 2)
    else:  # ssm_in over model: in_proj's columns in four blocks
        assert params["decoder"]["g0"][0]["l0"]["ssm"]["in_proj"].counts() \
            == (1, 4)


def test_sharded_trainer_carries_features():
    """``train(..., shard_ctx=)`` on reduced pixtral-12b with
    ``DataConfig(feature_rows=16)``: each batch's features are split by
    ``batch`` beside its tokens, and 2 steps equal, bit for bit, 2 steps of
    ``make_train_step(model, opt, ctx)`` on the same batches; the
    features' stream leaves the tokens as they are without it."""
    from repro_torch.training.data import make_dataset

    cfg = _config(PIXTRAL)
    model = Model(cfg, dtype=torch.float64, device="cpu", remat=True)
    ctx = _ctx(cfg, (2, 2))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                      feature_rows=F)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    p1, s1, h1 = train(model, data, TrainConfig(steps=2, log_every=1), opt,
                       shard_ctx=ctx, log_fn=lambda _: None)
    assert len(h1) == 2 and all(np.isfinite(h["loss"]) for h in h1)
    plain = next(make_dataset(dataclasses.replace(
        data, feature_rows=0)).batches())
    batches = make_dataset(data).batches()
    first = next(make_dataset(data).batches())
    assert first["features"].shape == (B, F, 1024)
    for k in ("tokens", "labels"):
        assert np.array_equal(first[k], plain[k])
    params = place_for_train(model, ctx,
                             model.init(torch.Generator().manual_seed(0)))
    state = adamw_init(params)
    step = make_train_step(model, opt, ctx)
    for h in h1:
        params, state, met = step(params, state, {
            k: torch.as_tensor(v) for k, v in next(batches).items()})
        assert float(met["loss"]) == h["loss"]
    for a, b in zip(tree_leaves(p1) + tree_leaves(s1.m),
                    tree_leaves(params) + tree_leaves(state.m)):
        assert torch.equal(a.gather(), b.gather())


def test_launcher_refuses_an_encoder_decoder():
    """The launcher's batches carry no feature rows: an encoder-decoder,
    whose encoder needs them, is refused before any weight is drawn."""
    with pytest.raises(ValueError, match="feature rows"):
        launch_train.main(["--arch", SEAMLESS, "--reduced", "--device",
                           "cpu", "--steps", "1"])
