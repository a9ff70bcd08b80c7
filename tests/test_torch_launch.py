"""The port's sharding rules, meshes and dry-run / roofline / report
launchers against the JAX package's (CPU; no JAX compile, no forced host
devices).

* ``make_rules`` equals JAX's for every arch x shape on 16 x 16,
  2 x 16 x 16, 1 x 1 and data 2 x model 4 (JAX's reads only
  ``mesh.shape``, so the port's ``LogicalMesh`` drives both), and so does
  every member of ``make_ctx``'s ShardCtx;
* every schema leaf's shape, logical axes and init equal JAX's, leaf by
  leaf, for every arch (the port's one-entry-a-layer groups stacked into
  JAX's layout with ``schema.stack``), and ``param_pspecs`` /
  ``cache_pspecs`` equal JAX's ``PartitionSpec``s as tuples;
* the dry-run's argument bytes a device equal a sum built from JAX's
  ``param_specs``, ``param_pspecs``, ``adamw_init_specs``,
  ``input_specs`` and ``cache_pspecs`` for every arch x shape on 16 x 16;
* ``model_flops`` and ``Roofline.to_dict``'s keys equal JAX's;
* a record the port's dry-run writes renders the same tables through
  JAX's ``report`` and the port's, and gives JAX's ``llm_workload``;
* ``kernel_work`` gives PERF.md's bound column to its last printed digit;
* the dry-run runs on meta for a reduced config of each family x each
  kind: on 1 x 1 its FLOPs outside the kernels equal
  ``FlopCounterMode``'s count of the same step on CPU tensors less the
  plain versions' share, and on data 2 x model 2 its FLOPs lie between a
  quarter of that and the whole.
"""

import dataclasses
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_shape as jax_get_shape  # noqa: E402
from repro.core.workloads import llm_workload as jax_llm_workload  # noqa: E402
from repro.launch import report as jax_report  # noqa: E402
from repro.launch import roofline as jax_rl  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import schema as jax_sch  # noqa: E402
from repro.sharding.partition import ShardCtx as JaxShardCtx  # noqa: E402
from repro.sharding.partition import make_rules as jax_make_rules  # noqa: E402
from repro.training.optimizer import adamw_init_specs as jax_adamw_specs  # noqa: E402
from repro_torch.configs import ARCHITECTURES, SHAPES, get_config, get_shape  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.core.workloads import llm_workload  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import report  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    LogicalMesh,
    make_local_mesh,
    make_production_mesh,
)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import schema as sch  # noqa: E402
from repro_torch.sharding.partition import (  # noqa: E402
    make_ctx,
    make_rules,
    spec_bytes_per_device,
)
from repro_torch.training.optimizer import adamw_init  # noqa: E402
from repro_torch.training.steps import (  # noqa: E402
    make_prefill_step,
    make_serve_step,
    make_train_step,
)


def _jax_dryrun():
    """JAX's dry-run module; its import sets XLA_FLAGS for 512 host
    devices, which is put back at once (no JAX backend starts here)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jd


JD = _jax_dryrun()
ARCHS = sorted(ARCHITECTURES)
MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "1x1": make_local_mesh(),
          "2x4": LogicalMesh(("data", "model"), (2, 4))}


def _both(arch, shape_name):
    """(port cfg, port shape, JAX cfg, JAX shape) after each side's
    ``arch_for_shape``; None configs where the policy skips."""
    cfg, skip = dryrun.arch_for_shape(get_config(arch), get_shape(shape_name))
    jcfg, jskip = JD.arch_for_shape(jax_get_config(arch),
                                    jax_get_shape(shape_name))
    assert skip == jskip
    return cfg, get_shape(shape_name), jcfg, jax_get_shape(shape_name)


# --------------------------------------------------------------------------- #
# rules, schema axes, partition specs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rules_equal_jax(mesh):
    m = MESHES[mesh]
    for arch in ARCHS:
        for s in SHAPES:
            cfg, jcfg = get_config(arch), jax_get_config(arch)
            for shape, jshape in ((get_shape(s), jax_get_shape(s)),
                                  (None, None)):
                assert make_rules(cfg, m, shape) == jax_make_rules(
                    jcfg, m, jshape), (arch, s, mesh)
            cfg, shape, jcfg, jshape = _both(arch, s)
            if cfg is not None:
                assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shard_ctx_equals_jax(mesh):
    """Every member of ``make_ctx``'s ShardCtx equals JAX's ShardCtx over
    JAX's rules (``PartitionSpec``s as tuples), for every arch x shape (and
    no shape): each logical axis's size and spec, the activation specs of
    2-4 dims with the batch on each dim, and a multi-axis spec."""
    m = MESHES[mesh]
    for arch in ARCHS:
        for s in SHAPES:
            for shape, jshape in ((get_shape(s), jax_get_shape(s)),
                                  (None, None)):
                ctx = make_ctx(get_config(arch), m, shape)
                jctx = JaxShardCtx(mesh=m, rules=jax_make_rules(
                    jax_get_config(arch), m, jshape))
                key = (arch, s if shape else None, mesh)
                assert ctx.shards_vocab == jctx.shards_vocab, key
                assert ctx.kv_seq_axes == jctx.kv_seq_axes, key
                assert ctx.batch_axes == jctx.batch_axes, key
                for a in ctx.rules:
                    assert ctx.axis_size(a) == jctx.axis_size(a), (key, a)
                    assert ctx.spec(a) == tuple(jctx.spec(a)), (key, a)
                assert ctx.spec("batch", "act_seq", None, "embed") == tuple(
                    jctx.spec("batch", "act_seq", None, "embed")), key
                for nd in (2, 3, 4):
                    for bd in range(nd):
                        assert ctx.activation_pspec(nd, bd) == tuple(
                            jctx.activation_pspec(nd, bd)), (key, nd, bd)


def _jax_layout(tree, leaf_stack):
    """The port's tree (schema, pspecs) in JAX's layout: a decoder group of
    several superblocks stacked (its superblocks equal), the encoder's
    always; ``leaf_stack(block, n)`` stacks one superblock n deep."""
    out = {}
    for k, v in tree.items():
        if k in ("decoder", "encoder"):
            out[k] = {}
            for g, blocks in v.items():
                assert all(b == blocks[0] for b in blocks)
                out[k][g] = (leaf_stack(blocks[0], len(blocks))
                             if k == "encoder" or len(blocks) > 1
                             else blocks[0])
        else:
            out[k] = v
    return out


def _stack_specs(block, n):
    return sch.tree_map(lambda p: (None,) + p, block)


def _jax_leaves(tree, is_leaf=None):
    return jax.tree.leaves(tree, is_leaf=is_leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_schema_axes_and_pspecs_equal_jax(arch):
    model = Model(get_config(arch), device="meta")
    jmodel = JaxModel(jax_get_config(arch))
    mine = sch.tree_leaves(_jax_layout(model.schema(), sch.stack))
    theirs = _jax_leaves(jmodel.schema(), jax_sch.is_spec)
    assert [(s.shape, s.axes, s.init, s.scale) for s in mine] == [
        (s.shape, s.axes, s.init, s.scale) for s in theirs]
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for s in SHAPES:
        rules = make_rules(model.cfg, MESHES["16x16"], get_shape(s))
        mine = sch.tree_leaves(_jax_layout(model.param_pspecs(rules),
                                           _stack_specs))
        theirs = _jax_leaves(jmodel.param_pspecs(rules), is_p)
        assert mine == [tuple(p) for p in theirs], (arch, s)
        caches = model.cache_pspecs(rules)
        mine = sch.tree_leaves(_jax_layout({"decoder": caches},
                                           _stack_specs)["decoder"])
        theirs = _jax_leaves(jmodel.cache_pspecs(rules), is_p)
        assert mine == [tuple(p) for p in theirs], (arch, s)


# --------------------------------------------------------------------------- #
# argument bytes a device, model FLOPs, the record
# --------------------------------------------------------------------------- #
def _jax_arg_bytes(jcfg, jshape, mesh):
    """The bytes a device holds of the step's arguments, from JAX's specs
    (what its ``memory_analysis`` calls the argument size)."""
    rules = jax_make_rules(jcfg, mesh, jshape)
    jm = JaxModel(jcfg)
    params, pspecs = jm.param_specs(), jm.param_pspecs(rules)
    inputs = jm.input_specs(jshape)
    data = lambda s: (rules["batch"],) + (None,) * (len(s.shape) - 1)  # noqa: E731
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    pairs = list(zip(_jax_leaves(params), _jax_leaves(pspecs, is_p)))
    if jshape.kind == "train":
        opt = jax_adamw_specs(params)
        pairs += [(opt.step, ())]
        pairs += list(zip(_jax_leaves(opt.m), _jax_leaves(pspecs, is_p)))
        pairs += list(zip(_jax_leaves(opt.v), _jax_leaves(pspecs, is_p)))
    if jshape.kind == "decode":
        pairs += list(zip(_jax_leaves(inputs["caches"]),
                          _jax_leaves(jm.cache_pspecs(rules), is_p)))
        pairs += [(inputs[k], data(inputs[k])) for k in ("tokens", "lengths")]
    else:
        pairs += [(s, data(s)) for s in _jax_leaves(inputs)]
    return sum(spec_bytes_per_device(s.shape, s.dtype.itemsize, tuple(p),
                                     mesh.shape) for s, p in pairs)


@pytest.mark.parametrize("arch", ARCHS)
def test_arg_bytes_and_model_flops_equal_jax(arch):
    mesh = MESHES["16x16"]
    for s in SHAPES:
        cfg, shape, jcfg, jshape = _both(arch, s)
        assert rl.model_flops(get_config(arch), shape) == jax_rl.model_flops(
            jax_get_config(arch), jshape)
        if cfg is None:
            continue
        case, skip = dryrun.build_case(arch, s)
        assert skip is None
        dryrun.check_coherence(case, mesh.shape)
        assert dryrun.arg_bytes_per_device(case, mesh.shape) == \
            _jax_arg_bytes(jcfg, jshape, mesh), (arch, s)


def test_roofline_record_keys_equal_jax():
    kw = dict(arch="a", shape="s", mesh="16x16", step="train", chips=256,
              hlo_flops=1e15, hlo_bytes=1e12, coll_bytes=1e9,
              coll_breakdown={"all-reduce": 1e9, "all-reduce_count": 3},
              model_flops=1e17, peak_bytes_per_device=2**34,
              arg_bytes_per_device=2**33)
    mine, theirs = rl.Roofline(**kw).to_dict(), jax_rl.Roofline(**kw).to_dict()
    assert list(mine) == list(theirs)
    assert mine["useful_flops_fraction"] == theirs["useful_flops_fraction"]
    # the H100 datasheet's constants, not v5e's
    assert mine["t_compute"] == 1e15 / 989e12
    assert mine["t_memory"] == 1e12 / 3.35e12
    assert mine["t_collective"] == 1e9 / 50e9


def test_record_renders_and_feeds_llm_workload(tmp_path, monkeypatch):
    cfg = get_config("llama3-8b").reduced()
    for s in ("prefill_32k", "decode_32k"):
        (rec,) = dryrun.run_case("llama3-8b", s, cfg_override=cfg,
                                 verbose=False, results_dir=str(tmp_path))
        assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "llama3-8b__decode_32k__16x16.json",
        "llama3-8b__prefill_32k__16x16.json"]
    monkeypatch.setattr(report, "DIR", str(tmp_path))
    monkeypatch.setattr(jax_report, "DIR", str(tmp_path))
    for table in ("roofline_table", "dryrun_table"):
        text = getattr(report, table)("16x16")
        assert text == getattr(jax_report, table)("16x16")
        assert text.count("llama3-8b-reduced") == 2
    w = llm_workload("llama3-8b", "decode_32k", results_dir=str(tmp_path))
    jw = jax_llm_workload("llama3-8b", "decode_32k",
                          results_dir=str(tmp_path))
    assert dataclasses.asdict(w) == dataclasses.asdict(jw)


def test_long_500k_skip_and_fast_record():
    recs = dryrun.run_case("seamless-m4t-large-v2", "long_500k", save=False,
                           verbose=False)
    assert recs == [{"arch": "seamless-m4t-large-v2", "shape": "long_500k",
                     "mesh": "16x16", "skip": JD.arch_for_shape(
                         jax_get_config("seamless-m4t-large-v2"),
                         jax_get_shape("long_500k"))[1]}]
    (rec,) = dryrun.run_case("grok-1-314b", "train_4k", fast=True,
                             save=False, verbose=False)
    assert rec["hlo_flops"] == 0 and rec["arg_bytes_per_device"] > 0
    assert rec["coll_breakdown"]["all-gather_count"] > 0


# --------------------------------------------------------------------------- #
# kernel_work: PERF.md's bound column
# --------------------------------------------------------------------------- #
MAIN_LENS8 = [881, 518, 868, 843, 762, 708, 491, 972]
RING_POS = sum([0, 1, 64, 300, 777, 1024, 1500, 2048])  # phase 2's lengths
PAGED_LENS = [1088, 1092, 1097, 1101, 1105, 1110, 1115, 1120]
BOUNDS = [  # (kernel, args, kwargs, dtype, PERF.md's bound, its "by")
    ("flash_attention", (8, 1024, 1024, 32, 8, 128), {}, "bf16", "0.0696",
     "operations"),
    ("flash_attention", (1, 8192, 8192, 32, 8, 128),
     dict(segments=True, pairs=sum(n * (n + 1) // 2 for n in MAIN_LENS8)),
     "bf16", "0.0501", "bytes"),
    ("flash_attention", (8, 64, 64, 32, 8, 128), dict(prior=1024), "bf16",
     "0.0131", "bytes"),
    ("flash_attention", (8, 1024, 1024, 128, 128, 192, 128), {}, "bf16",
     "0.4006", "bytes"),
    ("flash_attention", (4, 1024, 1024, 16, 16, 64), dict(causal=False),
     "bf16", "0.0174", "operations"),
    ("flash_attention", (4, 2, 1024, 16, 16, 64), dict(causal=False), "bf16",
     "0.0050", "bytes"),
    ("rmsnorm", (8192, 4096), {}, "bf16", "0.0401", "bytes"),
    ("rmsnorm", (524288, 128), {}, "bf16", "0.0801", "bytes"),
    ("rmsnorm", (1024, 8192), {}, "bf16", "0.0100", "bytes"),
    ("rmsnorm", (4096, 1024), {}, "bf16", "0.0050", "bytes"),
    ("rmsnorm_bwd", (8192, 4096), {}, "bf16", "0.0601", "bytes"),
    ("rmsnorm_bwd", (8192, 4096, 4), {}, "fp32", "0.1202", "bytes"),
    ("decode_attention", (8, 32, 8, 128, RING_POS), {}, "bf16", "0.0070",
     "bytes"),
    ("decode_attention", (4, 16, 16, 64, 4 * 1024), {}, "bf16", "0.0050",
     "bytes"),
    ("paged_decode_attention", (8, 32, 8, 128, sum(PAGED_LENS)),
     dict(unique=2 * 1024 + sum(n - 1024 for n in PAGED_LENS), table=8 * 128),
     "bf16", "0.0033", "bytes"),
    ("ssd_scan", (1, 1024, 24, 64, 128, 256), {}, "bf16", "0.0023", "bytes"),
    ("ssd_scan", (1, 2048, 24, 64, 128, 256), {}, "bf16", "0.0044", "bytes"),
    ("ssd_scan", (1, 1024, 128, 64, 16, 256), {}, "bf16", "0.0103", "bytes"),
    ("ssd_scan_bwd", (8, 4096, 24, 64, 128), {}, "bf16", "0.1020", "bytes"),
    ("ssd_scan_bwd", (2, 4096, 128, 64, 16), {}, "bf16", "0.1230", "bytes"),
    ("ssd_scan_bwd", (8, 4096, 24, 64, 128, 4), {}, "fp32", "1.2436",
     "operations"),
    ("ssd_scan_bwd", (2, 4096, 128, 64, 16, 4), {}, "fp32", "0.3206",
     "operations"),
    ("flash_attention_bwd", (2, 4096, 32, 8, 128), {}, "bf16", "0.6950",
     "operations"),
    ("flash_attention_bwd", (8, 1024, 32, 8, 128), {}, "bf16", "0.1739",
     "operations"),
    ("flash_attention_bwd", (2, 4096, 32, 8, 128, None, 4), {}, "fp32",
     "10.2591", "operations"),
    ("flash_attention_bwd", (2, 4096, 128, 128, 192, 128), {}, "bf16",
     "3.6140", "operations"),
    ("flash_attention_bwd", (8, 1024, 128, 128, 192, 128), {}, "bf16",
     "0.9042", "operations"),
    ("flash_attention_bwd", (2, 1024, 128, 128, 192, 128), dict(real=1000),
     "bf16", "0.2156", "operations"),
    ("flash_attention_bwd", (2, 4096, 128, 128, 192, 128, 4), {}, "fp32",
     "53.3475", "operations"),
    ("mla_decode_attention", (8, 128, 512, 64, RING_POS), {}, "bf16",
     "0.00263", "bytes"),
    ("mla_decode_attention", (8, 128, 512, 64, RING_POS, 4), {}, "fp32",
     "0.0238", "operations"),
    ("preprocess", (8 * 480 * 640 * 3, 3), {}, "fp32", "0.0066", "bytes"),
]


@pytest.mark.parametrize("name,args,kw,dtype,want,by", BOUNDS,
                         ids=[f"{b[0]}-{b[4]}" for b in BOUNDS])
def test_kernel_work_gives_perf_bounds(name, args, kw, dtype, want, by):
    flops, nbytes = rl.kernel_work(name, *args, **kw)
    ms, got_by = rl.bound(nbytes, flops, dtype)
    digits = len(want.split(".")[1])
    assert f"{ms:.{digits}f}" == want and got_by == by, (ms, got_by)


def test_every_kernel_has_a_count():
    from repro_torch.kernels import ops

    assert set(rl.KERNELS) == set(ops.LAUNCHES)


# --------------------------------------------------------------------------- #
# the meta dry-run against FlopCounterMode on the CPU
# --------------------------------------------------------------------------- #
FAMILIES = {  # family -> (arch, config changes on top of reduced())
    "dense": ("llama3-8b", {}),
    "windowed": ("llama3-8b", dict(sliding_window=16)),
    "moe": ("grok-1-314b", {}),
    "mla": ("deepseek-v2-236b", {}),
    "ssm": ("mamba2-130m", {}),
    "hybrid": ("jamba-v0.1-52b", {}),
    "vlm": ("pixtral-12b", {}),
    "encdec": ("seamless-m4t-large-v2", {}),
}
KINDS = ("train", "prefill", "decode")


def _plain_share(counter, box):
    """Wrap every plain version of ``kernels/ref.py`` so the FLOPs counted
    inside it -- its forward, and its backward through autograd -- add to
    ``box[0]``."""

    def wrap(fn):
        def run(*args, **kw):
            diff = [t for t in list(args) + list(kw.values())
                    if isinstance(t, torch.Tensor) and t.requires_grad]
            if not (torch.is_grad_enabled() and diff):
                f0 = counter.get_total_flops()
                out = fn(*args, **kw)
                box[0] += counter.get_total_flops() - f0
                return out
            return _Plain.apply(fn, args, kw, box, counter, *diff)
        return run

    return {n: wrap(getattr(ref, n)) for n in dir(ref) if n.endswith("_ref")}


class _Plain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, args, kw, box, counter, *diff):
        ids = {id(t): i for i, t in enumerate(diff)}
        # the inner graph keeps its own saved tensors: under a checkpointed
        # layer, the checkpoint's hooks would recompute the whole layer
        # inside this backward
        keep = torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                        lambda t: t)
        with torch.enable_grad(), keep:
            det = [t.detach().requires_grad_(True) for t in diff]
            sub = lambda t: det[ids[id(t)]] if id(t) in ids else t  # noqa: E731
            f0 = counter.get_total_flops()
            out = fn(*[sub(a) for a in args], **{k: sub(v) for k, v in kw.items()})
            box[0] += counter.get_total_flops() - f0
        outs = out if isinstance(out, tuple) else (out,)
        ctx.det, ctx.outs, ctx.box, ctx.counter = det, outs, box, counter
        res = tuple(o.detach() for o in outs)
        return res if isinstance(out, tuple) else res[0]

    @staticmethod
    def backward(ctx, *grads):
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if o.requires_grad and g is not None]
        f0 = ctx.counter.get_total_flops()
        got = torch.autograd.grad([o for o, _ in pairs], ctx.det,
                                  [g for _, g in pairs], allow_unused=True)
        ctx.box[0] += ctx.counter.get_total_flops() - f0
        return (None,) * 5 + tuple(got)


def _cpu_step(model, shape):
    """The dry-run's step on CPU tensors: seeded weights and inputs of
    ``Model.input_specs``'s shapes."""
    cfg, B, S = model.cfg, shape.global_batch, shape.seq_len
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    specs = model.input_specs(shape)
    toks = lambda s: torch.randint(0, cfg.vocab_size, s, generator=g,  # noqa: E731
                                   dtype=torch.int32)
    if shape.kind == "decode":
        caches = model.init_cache(B, S)
        lengths = torch.full((B,), S // 2, dtype=torch.int32)
        return lambda: make_serve_step(model)(params, caches,
                                              toks((B, 1)), lengths)
    batch = {k: toks(tuple(t.shape)) if k != "features" else
             torch.randn(tuple(t.shape), generator=g).to(model.dtype)
             for k, t in specs.items()}
    if shape.kind == "prefill":
        return lambda: make_prefill_step(model)(params, batch)
    return lambda: make_train_step(model)(params, adamw_init(params), batch)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_meta_dryrun_matches_flop_counter(family, kind, monkeypatch):
    arch, changes = FAMILIES[family]
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    shape = InputShape(f"test_{kind}", seq_len=64, global_batch=2, kind=kind)
    meshes = [MESHES["1x1"], LogicalMesh(("data", "model"), (2, 2))]
    rules = [make_rules(cfg, m, shape) for m in meshes]
    case, _ = dryrun.build_case(arch, cfg_override=cfg, shape=shape,
                                rules=rules[0])
    tally = dryrun.tally_case(case, [(r, m.shape) for r, m in
                                     zip(rules, meshes)])
    kernels = sum(tally.kernel_flops.values())
    assert kernels > 0
    one, _ = tally.per_device(0)
    assert one == tally.matmul_flops + kernels
    quad, _ = tally.per_device(1)
    assert one / 4 <= quad <= one
    assert 0 < tally.peak_live[1] <= tally.peak_live[0]

    cpu = Model(cfg, device="cpu", remat=kind == "train")
    step = _cpu_step(cpu, shape)
    box = [0]
    with FlopCounterMode(display=False) as counter:
        for n, fn in _plain_share(counter, box).items():
            monkeypatch.setattr(ref, n, fn)
        step()
    assert box[0] > 0 or family == "ssm"
    assert tally.matmul_flops == counter.get_total_flops() - box[0]
    assert math.isfinite(one)


# --------------------------------------------------------------------------- #
# kernels/ops.py's meta path
# --------------------------------------------------------------------------- #
def _op_cases():
    """(kernel, op call on a device): every kernel op at small shapes,
    integer inputs from a seed, the rest random."""
    from repro_torch.kernels import ops

    def call(name, dev, grad=False):
        g = torch.Generator().manual_seed(0)

        def r(*s):
            return torch.randn(s, generator=g).to(dev).requires_grad_(grad)

        def i32(*v):
            return torch.tensor(v, dtype=torch.int32).to(dev)

        if name == "rmsnorm":
            return ops.rmsnorm(r(6, 16), r(16))
        if name == "flash_attention":
            return ops.flash_attention(r(2, 8, 4, 16), r(2, 8, 2, 16),
                                       r(2, 8, 2, 16))
        if name == "decode_attention":
            return ops.decode_attention(r(2, 1, 4, 16), r(2, 8, 2, 16),
                                        r(2, 8, 2, 16), i32(3, 8))
        if name == "paged_decode_attention":
            return ops.paged_decode_attention(
                r(2, 1, 4, 16), r(5, 4, 2, 16), r(5, 4, 2, 16),
                i32(1, 2, 3, 4).reshape(2, 2), i32(5, 8))
        if name == "mla_decode_attention":
            return ops.mla_decode_attention(r(2, 1, 4, 32), r(2, 1, 4, 8),
                                            r(2, 8, 32), r(2, 8, 8),
                                            i32(3, 8), scale=0.2)
        if name == "paged_mla_decode_attention":
            return ops.paged_mla_decode_attention(
                r(2, 1, 4, 32), r(2, 1, 4, 8), r(5, 4, 32), r(5, 4, 8),
                i32(1, 2, 3, 4).reshape(2, 2), i32(5, 8), scale=0.2)
        if name == "ssd_scan":
            return ops.ssd_scan(r(1, 8, 2, 4), r(1, 8, 2).exp(), -r(2).exp(),
                                r(1, 8, 1, 4), r(1, 8, 1, 4), chunk=4)
        x = torch.randint(0, 256, (3, 5, 3), generator=torch.Generator()
                          .manual_seed(1), dtype=torch.uint8).to(dev)
        return ops.preprocess(x, r(3), r(3).exp())

    return call


class _Kernels:
    def __init__(self):
        self.calls = []

    def add_kernel(self, name, flops, nbytes, axes):
        self.calls.append((name, flops, nbytes, axes))


SERVING_OPS = ("decode_attention", "paged_decode_attention",
               "mla_decode_attention", "paged_mla_decode_attention",
               "preprocess")


@pytest.mark.parametrize("name", SERVING_OPS + ("rmsnorm", "flash_attention",
                                                "ssd_scan"))
def test_ops_meta_path(name):
    """On meta every op gives the plain version's output shapes and dtypes,
    adds one kernel_work to the innermost tally and counts no launch; a
    mix of meta and CPU raises; a serving kernel refuses inputs that
    require grad there as on the card."""
    from repro_torch.kernels import ops

    call = _op_cases()
    want = call(name, "cpu")
    tally = _Kernels()
    ops.reset_launches()
    ops.META_TALLIES.append(tally)
    try:
        got = call(name, "meta")
    finally:
        ops.META_TALLIES.remove(tally)
    pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
    for g, w in pairs:
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype
    assert [c[0] for c in tally.calls] == [name]
    assert tally.calls[0][1] > 0 and tally.calls[0][2] > 0
    assert not any(ops.LAUNCHES.values())
    with pytest.raises(ValueError):
        ops.rmsnorm(torch.ones(2, 4, device="meta"), torch.ones(4))
    if name in SERVING_OPS:
        with pytest.raises(NotImplementedError):
            call(name, "meta", grad=True)
    else:  # the kernels with a backward take the gradient on meta too
        out = call(name, "meta", grad=True)
        out = out[0] if isinstance(out, tuple) else out
        assert out.requires_grad and out.is_meta
