"""The port's training path against the JAX package's (fp32, CPU, the same
numpy inputs and the same weights).

* ``SyntheticLM`` / ``BinTokenFile`` batches equal JAX's bit for bit;
* ``lr_at`` equals JAX's at every step of a short schedule;
* ``adamw_update`` on the same gradients (JAX's, carried across) gives
  JAX's parameters, moments and gradient norm;
* ``Model.loss`` and the gradient of every leaf equal
  ``jax.value_and_grad(model.loss)`` on reduced llama3, a GQA variant,
  reduced grok-1 (the aux term, capacity drops), reduced pixtral-12b
  (features, the text-suffix loss, a loss mask) and reduced seamless-m4t
  (JAX's training batch: half frames, half target tokens);
* remat ``none``, ``full`` and ``dots`` give the same gradients;
* ``train`` over 5 steps gives JAX's loss and grad-norm history;
* the trained parameters are detached and serve: the engine's greedy
  tokens equal greedy decoding by ``Model.forward``;
* the launcher trains the reduced model on the CPU, and refuses a state
  that does not fit.

Weights come from the port's seeded init, stacked into JAX's layout by
``params_to_numpy``: JAX's init of a scanned group takes the layer count as
the fan-in, which makes the reduced models' attention so sharp that fp32
reassociation alone parts the two sides' gradients by 3e-3 of a leaf's
largest (on the port's init: 2e-6). Tolerances: the loss at 1e-5
relative, every gradient leaf within GRAD_TOL of its largest entry (fp32,
two frameworks' reassociation).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train as jax_train  # noqa: E402
from repro.training import TrainConfig as JTrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import FRONTEND_DIM, Model  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402
from repro_torch.models.schema import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5  # of each leaf's largest |gradient|
OPT_TOL = 1e-6  # AdamW on the same gradients
HIST_RTOL = 1e-4  # 5 steps of training: loss and grad norm


def _jax_tree(tp):
    return jax.tree.map(jnp.asarray, params_to_numpy(tp))


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


def _assert_grads_close(tgrads, jgrads, what):
    got = params_to_numpy(tgrads)
    want = jax.tree.map(np.asarray, jgrads)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = jax.tree.leaves(got)
    assert len(got_leaves) == len(paths), what
    for (path, w), g in zip(paths, got_leaves):
        assert g.shape == w.shape, (what, path)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale, (what, jax.tree_util.keystr(path),
                                         err, scale)


# --------------------------------------------------------------------------- #
# data and the schedule
# --------------------------------------------------------------------------- #
def test_synthetic_batches_equal_jax_bitwise():
    cfg = dict(vocab_size=1000, seq_len=64, batch_size=3, seed=7)
    a = tdata.make_dataset(tdata.DataConfig(**cfg)).batches()
    b = jdata.make_dataset(jdata.DataConfig(**cfg)).batches()
    for _ in range(4):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y) == ["labels", "tokens"]
        for k in x:
            assert x[k].dtype == y[k].dtype == np.int32
            np.testing.assert_array_equal(x[k], y[k])


def test_synthetic_stream_at_llama3_vocab_equals_jax_bitwise():
    """A 1,024-token stream over llama3's 128,256 ids, drawn from the kept
    cdf, equals the JAX package's ``choice`` stream bit for bit, and both
    generators are left in the same state (their next draws are equal)."""
    cfg = dict(vocab_size=128_256, seq_len=1023, batch_size=1, seed=11)
    a = tdata.SyntheticLM(tdata.DataConfig(**cfg))
    b = jdata.SyntheticLM(jdata.DataConfig(**cfg))
    x, y = a._sequence(cfg["seq_len"]), b._sequence(cfg["seq_len"])
    assert x.shape == y.shape == (1024,) and x.dtype == y.dtype
    np.testing.assert_array_equal(x, y)
    assert (x < 128_256).all() and (x >= 0).all()
    assert a.rng.random() == b.rng.random()


def test_bin_token_file_batches_equal_jax_bitwise(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 50_000, 4096, dtype=np.uint32) \
        .tofile(path)
    cfg = dict(vocab_size=50_000, seq_len=32, batch_size=4, seed=3,
               path=str(path))
    a = tdata.make_dataset(tdata.DataConfig(**cfg)).batches()
    b = jdata.make_dataset(jdata.DataConfig(**cfg)).batches()
    for _ in range(3):
        x, y = next(a), next(b)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(x[k], y[k])


def test_lr_at_equals_jax_at_every_step():
    for kw in (dict(lr=1e-3, warmup_steps=3, total_steps=10),
               dict(lr=3e-4, warmup_steps=1, total_steps=7, min_lr_ratio=0.2)):
        tc, jc = topt.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
        for step in range(0, kw["total_steps"] + 3):
            want = float(jopt.lr_at(jc, jnp.asarray(step, jnp.int32)))
            assert topt.lr_at(tc, step) == want, (kw, step)


# --------------------------------------------------------------------------- #
# AdamW on the same gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_adamw_update_matches_jax(dtype):
    """Three steps on JAX's gradients of three batches, carried across:
    params, m, v and the grad norm at OPT_TOL (fp32). In bf16, one step:
    the update is computed in fp32 and cast once, so a parameter may land
    one bf16 step from JAX's where the two fp32 values straddle a rounding
    boundary (later steps would carry that step into other binades)."""
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    cfg = get_config("llama3-8b").reduced()
    tm = Model(cfg, dtype=tdt, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    jm = JaxModel(jax_get_config("llama3-8b").reduced(), dtype=jdt)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params_to_numpy(tp))
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=0.5)
    tcfg, jcfg = topt.AdamWConfig(**oc), jopt.AdamWConfig(**oc)
    ts, js = topt.adamw_init(tp), jopt.adamw_init(jp)
    ds = jdata.make_dataset(jdata.DataConfig(vocab_size=cfg.vocab_size,
                                             seq_len=16, batch_size=2))
    batches = ds.batches()
    for _ in range(3 if dtype == "fp32" else 1):
        batch = {k: jnp.asarray(v) for k, v in next(batches).items()}
        jg = jax.grad(lambda p: jm.loss(p, batch))(jp)
        tg = _from_jax(jg, cfg, tdt)
        tp, ts, tn = topt.adamw_update(tcfg, tg, ts, tp)
        jp, js, jn = jopt.adamw_update(jcfg, jg, js, jp)
        assert abs(float(tn) - float(jn)) <= OPT_TOL * float(jn)
        assert ts.step == int(js.step)
    for mine, theirs in ((ts.m, js.m), (ts.v, js.v)):
        for g, w in zip(jax.tree.leaves(params_to_numpy(mine)),
                        jax.tree.leaves(jax.tree.map(np.asarray, theirs))):
            np.testing.assert_allclose(g, w, rtol=OPT_TOL,
                                       atol=OPT_TOL * np.abs(w).max())
    for g, w in zip(jax.tree.leaves(params_to_numpy(tp)),
                    jax.tree.leaves(jax.tree.map(
                        lambda a: np.asarray(a, np.float32), jp))):
        if dtype == "fp32":
            np.testing.assert_allclose(g, w, rtol=OPT_TOL,
                                       atol=OPT_TOL * np.abs(w).max())
        else:  # at most one bf16 step (2^-7 of the binade) apart
            ulp = np.ldexp(1.0, np.frexp(w)[1] - 8)
            bad = np.abs(g - w) > ulp
            assert not bad.any(), (g[bad], w[bad], ulp[bad])


def _from_jax(jtree, cfg, dtype):
    """A JAX-layout tree in the port's structure and ``dtype``, each
    stacked group split back into its layers (values exact: bf16 crosses
    as fp32)."""
    from repro_torch.models.convert import params_from_numpy

    return params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jtree), cfg,
        device="cpu", dtype=dtype)


# --------------------------------------------------------------------------- #
# the loss and every leaf's gradient
# --------------------------------------------------------------------------- #
def _gqa(c):
    return dataclasses.replace(c.reduced(), n_kv_heads=2)


VARIANTS = {
    "llama3": ("llama3-8b", lambda c: c.reduced()),
    "llama3_gqa": ("llama3-8b", _gqa),
    "grok1": ("grok-1-314b", lambda c: c.reduced()),
    "pixtral": ("pixtral-12b", lambda c: c.reduced()),
    "seamless": ("seamless-m4t-large-v2", lambda c: c.reduced()),
}


def _variant(name, remat_policy=None):
    arch, cut = VARIANTS[name]
    cfg, jcfg = cut(get_config(arch)), cut(jax_get_config(arch))
    tm = Model(cfg, dtype=torch.float32, device="cpu",
               remat=remat_policy is not None,
               remat_policy=remat_policy or "full")
    tp = tm.init(torch.Generator().manual_seed(0))
    jm = JaxModel(jcfg, dtype=jnp.float32)
    return cfg, tm, tp, jm


def _batch(name, cfg, seed=1):
    """The variant's training batch (numpy): tokens and labels; pixtral
    with 6 feature frames ahead of 10 text tokens and a loss mask;
    seamless with JAX's training split, half frames and half tokens."""
    rng = np.random.default_rng(seed)
    S = 16
    if name == "seamless":
        s_src = S // 2
        toks = rng.integers(0, cfg.vocab_size, (2, S - s_src + 1))
        return {"features": rng.standard_normal(
                    (2, s_src, FRONTEND_DIM)).astype(np.float32),
                "tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
    if name == "pixtral":
        toks = rng.integers(0, cfg.vocab_size, (2, 11))
        return {"features": rng.standard_normal((2, 6, FRONTEND_DIM))
                .astype(np.float32),
                "tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32),
                "loss_mask": (rng.random((2, 10)) < 0.7).astype(np.int32)}
    toks = rng.integers(0, cfg.vocab_size, (2, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_loss_and_grads_match_jax(name):
    cfg, tm, tp, jm = _variant(name)
    batch = _batch(name, cfg)
    jl, jg = jax.value_and_grad(lambda p: jm.loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}))(_jax_tree(tp))
    tl, tg = _port_grads(tm, tp, batch)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    _assert_grads_close(tg, jg, name)


def test_grok_loss_carries_the_aux_term_with_drops():
    """The MoE aux term is in the loss (weight router_aux_weight) and the
    batch drops expert choices at the default capacity factor, in both."""
    from repro_torch.models import moe

    cfg, tm, tp, jm = _variant("grok1")
    batch = _batch("grok1", cfg)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        x, aux, _ = tm.backbone(tp, tb["tokens"], want_cache=False)
    assert float(aux) > 0
    T = batch["tokens"].size
    assert moe.capacity(T, cfg.moe) < T * cfg.moe.top_k  # choices can drop
    no_aux = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_aux_weight=0.0))
    with torch.no_grad():
        full = float(tm.loss(tp, tb))
        bare = float(Model(no_aux, dtype=torch.float32, device="cpu")
                     .loss(tp, tb))
    np.testing.assert_allclose(full - bare, cfg.moe.router_aux_weight
                               * float(aux), rtol=1e-4)


def test_remat_policies_give_the_same_gradients():
    name = "llama3_gqa"
    grads = {}
    for policy in ("none", "full", "dots"):
        cfg, tm, tp, _ = _variant(name, policy)
        grads[policy] = _port_grads(tm, tp, _batch(name, cfg))
    for policy in ("full", "dots"):
        assert torch.equal(grads[policy][0], grads["none"][0])
        for a, b in zip(tree_leaves(grads[policy][1]),
                        tree_leaves(grads["none"][1])):
            assert torch.equal(a, b), policy


def test_train_history_matches_jax():
    """5 steps from the same init on the same batches: the loss and the
    grad norm at every step within HIST_RTOL (parameters are not compared
    elementwise: where a gradient is near 0 the two sides' roundoff can
    flip its sign, and Adam turns that into +-lr)."""
    cfg, tm, tp, jm = _variant("llama3")
    jp = _jax_tree(tp)
    dc = dict(vocab_size=cfg.vocab_size, seq_len=32, batch_size=2, seed=5)
    oc = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    _, _, th = train(tm, DataConfig(**dc), TrainConfig(steps=5, log_every=1),
                     AdamWConfig(**oc), params=tp, log_fn=lambda s: None)
    _, _, jh = jax_train(jm, jdata.DataConfig(**dc),
                         JTrainConfig(steps=5, log_every=1),
                         jopt.AdamWConfig(**oc), params=jp,
                         log_fn=lambda s: None)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [1, 2, 3, 4, 5]
    for a, b in zip(th, jh):
        assert abs(a["loss"] - b["loss"]) <= HIST_RTOL * abs(b["loss"]), (a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) \
            <= HIST_RTOL * b["grad_norm"], (a, b)
    assert th[-1]["loss"] < th[0]["loss"]


def test_trained_params_are_detached_and_serve():
    cfg = get_config("llama3-8b").reduced()
    tm = Model(cfg, dtype=torch.float32, device="cpu", remat=True)
    params, state, hist = train(
        tm, DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=2),
        TrainConfig(steps=2, log_every=1), AdamWConfig(lr=1e-2),
        log_fn=lambda s: None)
    assert state.step == 2 and len(hist) == 2
    assert not any(p.requires_grad for p in tree_leaves(params))
    prompts = [[5, 9, 2, 7, 1], [3, 3, 8]]
    new = 4
    eng = ServingEngine(tm, params, max_batch=2, max_seq=32, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(prompt_tokens=np.asarray(p, np.int32),
                           max_new_tokens=new, request_id=i))
    done = {r.request_id: r.tokens for r in eng.run_until_drained()}
    for i, p in enumerate(prompts):
        toks = list(p)
        with torch.no_grad():
            for _ in range(new):
                logits, _, _ = tm.forward(params, torch.tensor([toks]))
                toks.append(int(logits[0, -1, :cfg.vocab_size].argmax()))
        assert done[i] == toks[len(p):], i


def test_launcher_trains_reduced_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3-8b", "--reduced", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "32"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    steps = [ln for ln in proc.stdout.splitlines() if ln.startswith("step")]
    assert len(steps) == 3 and all("loss" in ln for ln in steps)


def test_launcher_refuses_a_state_that_does_not_fit():
    """The full llama3-8b, jamba-v0.1-52b and deepseek-v2-236b: 12 bytes a
    parameter is over an H100's 80 GB, while mamba2-130m's is under it;
    without a card the check refuses the CPU outright."""
    full = Model(get_config("llama3-8b"), device="cpu")
    n = launch_train.param_count(full)
    assert 7.4e9 < n < 7.6e9  # the tied table counted once
    assert launch_train.STATE_BYTES_PER_PARAM * n > 80e9
    with pytest.raises(ValueError, match="--reduced"):
        launch_train.check_fits(full)
    for arch, over in (("jamba-v0.1-52b", True), ("deepseek-v2-236b", True),
                       ("mamba2-130m", False)):
        model = Model(get_config(arch), device="cpu")
        state = launch_train.STATE_BYTES_PER_PARAM * launch_train.param_count(
            model)
        assert (state > 80e9) == over, (arch, state)
        with pytest.raises(ValueError, match="--reduced"):
            launch_train.check_fits(model)


def test_launcher_cuts_the_stack_to_its_first_layers():
    """``--layers`` trains the first N layers at full width (counted by
    check_fits as such), ``--batch``/``--seq`` set the batch."""
    params, _, hist = launch_train.main(
        ["--arch", "mamba2-130m", "--reduced", "--layers", "1", "--device",
         "cpu", "--steps", "2", "--batch", "1", "--seq", "16"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert len(params["decoder"]["g0"]) == 1
