"""Dry-run: every (arch x input shape) step on the meta device, counted on
a logical mesh.

The JAX package lowers and compiles each case for a 256- or 512-chip mesh.
The port runs the step itself -- train (loss, autograd and AdamW under full
remat), prefill, or one decode token -- on meta tensors at the shape's
global size: parameters from the schema, inputs and caches from
``Model.input_specs``, no generator, no data, no kernel launch. A
``TorchDispatchMode`` (:class:`Tally`) counts every op once; each mesh's
rules then split the counts a device:

* FLOPs: the matmul-class ops by ``torch.utils.flop_counter``'s rules, each
  hand-written kernel by its ``kernel_work`` (``kernels/work.py``;
  ``kernels/ops.py``'s meta path adds it);
* bytes: each op's operands and result, unfused (an upper bound on the
  traffic): views move none, an in-place scatter or gather its values and
  indices, a kernel its ``kernel_work`` bytes;
* collective bytes: from the rules (``roofline.collective_bytes``);
* argument bytes a device: exact, the parameters, the optimizer state, the
  inputs and caches each divided by their specs;
* peak a device: the arguments plus the live tensors the step allocates
  (every new op output is counted at its allocation and uncounted when
  freed, a weakref finalizer on the meta tensor), each divided as its op is.

Per-device attribution (GSPMD decides it in JAX; the port states it): an op
is split over the distinct mesh axes of a set of logical axes --

* a matmul-class op against a parameter (an operand derived from one by
  views and casts, or, for a weight's gradient, a result of its shape):
  the token operand's ``batch`` and the parameter's own axes (``embed`` on
  data under FSDP is data again, counted once), so K/V projections whose 8
  heads do not divide model 16 count whole on every model rank;
* an op on parameters alone (casts, the optimizer's update): the
  parameter's axes;
* a kernel: attention ``batch`` x ``heads`` (decode also ``kv_seq``), the
  SSD scan ``batch`` x ``ssm_heads``, rmsnorm ``batch`` x ``act_seq``;
* any other op (elementwise, softmax, routing, the loss): ``batch`` x
  ``act_seq`` (the sequence is sharded between layers in train and prefill).

No scan correction: JAX's cost analysis counts a scanned layer once and
compiles unrolled 1- and 2-layer variants to extrapolate; the port runs
every layer.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 16 x 16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multipod # 2 x 16 x 16

Records go to ``experiments/dryrun_torch/`` (``repro_torch.launch.report``
renders them); ``--fast`` skips the meta pass (coherence and argument bytes
only).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.configs import ARCHITECTURES, SHAPES, get_config, get_shape
from repro_torch.kernels import ops
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.models.layers import pad_vocab
from repro_torch.models.schema import spec
from repro_torch.models.schema import tree_leaves as schema_leaves
from repro_torch.sharding.partition import (
    make_rules,
    shard_count,
    spec_bytes_per_device,
)
from repro_torch.training.optimizer import AdamWState, adamw_init_specs
from repro_torch.training.steps import (
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

# long_500k policy: SSM/hybrid run natively; dense/moe/vlm run the
# sliding-window decode variant; enc-dec audio skips.
LONG_WINDOW = 16_384

ACT = ("batch", "act_seq")
_aten = torch.ops.aten
_SCATTER = {_aten.index_put_, _aten.index_put, _aten._index_put_impl_}
_GATHER = {_aten.embedding, _aten.index_select, _aten.gather, _aten.index}
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided}
_VIEWS = {_aten._unsafe_view, _aten.detach, _aten.lift_fresh}


def arch_for_shape(cfg, shape):
    """Returns (config, skip_reason): the JAX package's policy."""
    if shape.name != "long_500k":
        return cfg, None
    if cfg.is_encdec:
        return None, "enc-dec: 500k-token decode target is meaningless (DESIGN.md §4)"
    if cfg.family in ("ssm", "hybrid"):
        return cfg, None  # sub-quadratic natively
    # dense/moe/vlm: sliding-window variant
    return dataclasses.replace(cfg, sliding_window=LONG_WINDOW), None


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(xs, out) -> list:
    """The tensors of ``xs`` (nested lists and tuples), appended to
    ``out``."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
    return out


class Tally(TorchDispatchMode):
    """Counts one meta step's ops, each under the logical axes that split
    it (see the module docstring), for each mesh of ``meshes`` (a list of
    (rules, mesh shape)). ``params`` (a list of (tensor, axes)) names the
    parameter leaves and the optimizer state shaped like them.

    After the step: ``flops`` and ``bytes`` map an axes tuple to the
    global count, ``kernel_flops`` the kernels' share by name; per mesh,
    :meth:`per_device` divides them and ``peak_live`` holds the largest
    live bytes a device."""

    def __init__(self, meshes, params=()):
        super().__init__()
        self.meshes = list(meshes)
        self.tags = WeakTensorKeyDictionary()
        self.by_shape = {}
        for t, axes in params:
            self.tags[t] = axes
            self.by_shape.setdefault(tuple(t.shape), axes)
            if t.ndim == 2:
                self.by_shape.setdefault(tuple(t.shape[::-1]), axes)
        self.flops: dict = {}
        self.bytes: dict = {}
        self.kernel_flops: dict = {}
        self.matmul_flops = 0
        self.live = [0.0] * len(self.meshes)
        self.peak_live = [0.0] * len(self.meshes)
        self._div = {}

    def divisors(self, axes) -> list:
        d = self._div.get(axes)
        if d is None:
            d = self._div[axes] = [shard_count(r, m, axes)
                                   for r, m in self.meshes]
        return d

    def _add(self, axes, flops, nbytes):
        if flops:
            self.flops[axes] = self.flops.get(axes, 0) + flops
        if nbytes:
            self.bytes[axes] = self.bytes.get(axes, 0) + nbytes

    def add_kernel(self, name, flops, nbytes, axes):
        """A kernel call on meta (``ops.META_TALLIES``)."""
        self._add(tuple(axes), flops, nbytes)
        self.kernel_flops[name] = self.kernel_flops.get(name, 0) + flops

    def per_device(self, i: int) -> tuple:
        """(FLOPs, bytes) a device on mesh ``i``."""
        f = sum(v / self.divisors(a)[i] for a, v in self.flops.items())
        b = sum(v / self.divisors(a)[i] for a, v in self.bytes.items())
        return f, b

    def _alloc(self, t, axes):
        nb = _nbytes(t)
        if not nb:
            return
        shares = [nb / d for d in self.divisors(axes)]
        for i, s in enumerate(shares):
            self.live[i] += s
            if self.live[i] > self.peak_live[i]:
                self.peak_live[i] = self.live[i]
        weakref.finalize(t, self._free, shares)

    def _free(self, shares):
        for i, s in enumerate(shares):
            self.live[i] -= s

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(kwargs.values(), _tensors(args, []))
        outs = _tensors((out,), [])
        tags = [self.tags.get(t) for t in ins]
        tagged = [a for a in tags if a is not None]
        packet = func._overloadpacket
        returns = func._schema.returns
        alias = returns[0].alias_info if returns else None
        view = alias is not None and not alias.is_write

        if view or packet in _VIEWS:
            if tagged:
                for t in outs:
                    self.tags[t] = tagged[0]
            return out

        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.matmul_flops += flops
            weight = tagged[0] if tagged else None
            if weight is None and outs:
                weight = self.by_shape.get(tuple(outs[0].shape))
                if weight is not None:  # a weight's gradient
                    self.tags[outs[0]] = weight
            axes = ("batch",) + weight if weight is not None else ACT
        elif tagged and (len(tagged) == len(ins) or (
                outs and any(tuple(t.shape) == tuple(outs[0].shape)
                             for t, a in zip(ins, tags) if a is not None))):
            axes = tagged[0]  # parameters (and their gradients) alone
            for t in outs:
                self.tags[t] = axes
        else:
            axes = ACT
            if packet is _aten.embedding_dense_backward and outs:
                weight = self.by_shape.get(tuple(outs[0].shape))
                if weight is not None:
                    self.tags[outs[0]] = weight

        if packet in _FREE:
            nbytes = 0
        elif packet in _SCATTER:
            # the values written and read, the indices read
            nbytes = 2 * _nbytes(ins[-1]) + sum(map(_nbytes, ins[1:-1]))
        elif packet in _GATHER:
            nbytes = 2 * sum(map(_nbytes, outs)) + sum(
                _nbytes(t) for t in ins[1:] if not t.is_floating_point())
        elif packet is _aten.copy_:
            nbytes = 2 * _nbytes(ins[1])
        else:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self._add(axes, flops, nbytes)
        if alias is None:
            for t in outs:
                self._alloc(t, axes)
        return out


# --------------------------------------------------------------------------- #
# Cases
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class Case:
    model: Model
    cfg: object
    shape: object
    step: str  # "train" | "prefill" | "serve"
    args: dict  # name -> tree of meta tensors (the step's arguments)
    specs: dict  # name -> the same tree of specs (None: replicated)


def build_case(arch: str, shape_name: str = None, *, cfg_override=None,
               shape=None, rules=None):
    """(Case, None), or (None, skip reason). ``shape`` overrides the named
    input shape (an ``InputShape``); ``rules`` the rules the specs follow
    (default: the 16 x 16 mesh's)."""
    cfg0 = cfg_override if cfg_override is not None else get_config(arch)
    shape = shape if shape is not None else get_shape(shape_name)
    cfg, skip = arch_for_shape(cfg0, shape)
    if cfg is None:
        return None, skip
    model = Model(cfg, device="meta", remat=shape.kind == "train",
                  remat_policy="full")
    rules = rules if rules is not None else make_rules(
        cfg, make_production_mesh(), shape)
    step = {"train": "train", "prefill": "prefill", "decode": "serve"}[
        shape.kind]
    params = model.param_specs()
    pspecs = model.param_pspecs(rules)
    args, specs = {"params": params}, {"params": pspecs}
    if step == "train":
        opt = adamw_init_specs(params)
        args.update(opt_m=opt.m, opt_v=opt.v, opt_step=opt.step)
        specs.update(opt_m=pspecs, opt_v=pspecs, opt_step=())
    inputs = model.input_specs(shape)
    if step == "serve":
        args["caches"] = inputs.pop("caches")
        specs["caches"] = model.cache_pspecs(rules)
    for k, t in inputs.items():  # batch-sharded data
        args[k] = t
        specs[k] = spec(rules, ("batch",) + (None,) * (t.ndim - 1))
    return Case(model, cfg, shape, step, args, specs), None


def _pairs(args, specs):
    """[(tensor, spec)] over every argument leaf."""
    out = []
    for k, tree in args.items():
        ss = specs[k]
        out += zip(schema_leaves(tree), schema_leaves(ss)
                   if isinstance(ss, (dict, list)) else [ss])
    return out


def check_coherence(case, mesh_shape: dict):
    """Every sharded dim of every argument divides by its mesh axes (what a
    compile would refuse)."""
    for t, spec in _pairs(case.args, case.specs):
        for dim, part in zip(t.shape, spec):
            k = 1
            for ax in (part if isinstance(part, (tuple, list)) else (part,)):
                if ax is not None:
                    k *= mesh_shape[ax]
            if dim % k:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"divide over {part} ({k})")


def arg_bytes_per_device(case, mesh_shape: dict) -> int:
    return sum(spec_bytes_per_device(t.shape, t.element_size(), spec,
                                     mesh_shape)
               for t, spec in _pairs(case.args, case.specs))


def run_step(case):
    """Run the case's step once on its (meta) arguments; returns its
    outputs (the trainer's, the prefill's, the decode step's)."""
    model, a = case.model, case.args
    if case.step == "train":
        state = AdamWState(step=0, m=a["opt_m"], v=a["opt_v"])
        batch = {k: a[k] for k in ("tokens", "labels", "features") if k in a}
        return make_train_step(model)(a["params"], state, batch)
    if case.step == "prefill":
        batch = {k: a[k] for k in ("tokens", "features") if k in a}
        return make_prefill_step(model)(a["params"], batch)
    return make_serve_step(model)(a["params"], a["caches"], a["tokens"],
                                  a["lengths"])


def _check_outputs(case, out):
    """The step's outputs on meta: the shapes a real run returns."""
    B = case.shape.global_batch
    V = pad_vocab(case.cfg.vocab_size)
    if case.step == "train":
        _, _, metrics = out
        if metrics["loss"].shape != () or metrics["grad_norm"].shape != ():
            raise AssertionError(f"train metrics {metrics}")
    elif tuple(out[0].shape) != (B, V) or tuple(out[-1].shape) != (B,):
        raise AssertionError(f"{case.step} logits {tuple(out[0].shape)}, "
                             f"lengths {tuple(out[-1].shape)}")


def tally_case(case, meshes) -> Tally:
    """One meta pass of the case's step, tallied for every (rules, mesh
    shape) of ``meshes``."""
    params = [(t, ax) for t, ax in zip(
        schema_leaves(case.args["params"]),
        (s.axes for s in schema_leaves(case.model._schema)))]
    if case.step == "train":
        params += [(t, ax) for k in ("opt_m", "opt_v")
                   for t, (_, ax) in zip(schema_leaves(case.args[k]), params)]
    tally = Tally(meshes, params)
    ops.META_TALLIES.append(tally)
    try:
        with tally:
            out = run_step(case)
        _check_outputs(case, out)
    finally:
        ops.META_TALLIES.remove(tally)
    return tally


def roofline_for(case, tally, i, rules, mesh) -> rl.Roofline:
    """The case's record on mesh ``i`` of the tally (``tally`` None: the
    ``--fast`` record, rules and arguments only)."""
    mshape = mesh.shape
    args = arg_bytes_per_device(case, mshape)
    leaves = [(tuple(t.shape), t.element_size(), spec) for t, spec in zip(
        schema_leaves(case.args["params"]),
        schema_leaves(case.specs["params"]))]
    coll = rl.collective_bytes(case.cfg, case.shape, rules, mshape, leaves)
    flops, nbytes = tally.per_device(i) if tally is not None else (0.0, 0.0)
    peak = args + (tally.peak_live[i] if tally is not None else 0)
    return rl.Roofline(
        arch=case.cfg.name, shape=case.shape.name, mesh=mesh.name,
        step=case.step, chips=mesh.size, hlo_flops=float(flops),
        hlo_bytes=float(nbytes),
        coll_bytes=float(sum(v for k, v in coll.items()
                             if not k.endswith("_count"))),
        coll_breakdown=coll, model_flops=rl.model_flops(case.cfg, case.shape),
        peak_bytes_per_device=int(peak), arg_bytes_per_device=int(args))


def run_case(arch, shape_name=None, *, multi_pod=False, meshes=None,
             save=True, verbose=True, cfg_override=None, shape=None,
             fast=False, results_dir=None):
    """One (arch, shape) on each mesh of ``meshes`` (default: the
    production mesh, multi-pod or not) from ONE meta pass. Returns the
    records' dicts, one a mesh (a skip record where JAX's policy skips)."""
    meshes = meshes or [make_production_mesh(multi_pod=multi_pod)]
    shape = shape if shape is not None else get_shape(shape_name)
    cfg0 = cfg_override if cfg_override is not None else get_config(arch)
    cfg, skip = arch_for_shape(cfg0, shape)
    if cfg is None:
        if verbose:
            for m in meshes:
                print(f"SKIP  {arch:24s} {shape.name:12s} {m.name:9s} — {skip}")
        return [{"arch": arch, "shape": shape.name, "mesh": m.name,
                 "skip": skip} for m in meshes]
    rules = [make_rules(cfg, m, shape) for m in meshes]
    cases = [build_case(arch, cfg_override=cfg0, shape=shape, rules=r)[0]
             for r in rules]
    for c, m in zip(cases, meshes):
        check_coherence(c, m.shape)
    t0 = time.time()
    tally = None if fast else tally_case(
        cases[0], [(r, m.shape) for r, m in zip(rules, meshes)])
    t_run = time.time() - t0
    out = []
    for i, (c, r, m) in enumerate(zip(cases, rules, meshes)):
        rec = roofline_for(c, tally, i, r, m)
        if verbose:
            print(f"OK    {rl.format_row(rec)}  (meta pass {t_run:.1f}s)",
                  flush=True)
        if save:
            d = results_dir or RESULTS_DIR
            os.makedirs(d, exist_ok=True)
            rl.save(rec, os.path.join(
                d, f"{arch}__{shape.name}__{m.name}.json"))
        out.append(rec.to_dict())
    return out


def _run_one(arch, shape_name, kw) -> list:
    """run_case, its failure printed and returned ([(arch, shape, repr)])."""
    try:
        run_case(arch, shape_name, **kw)
        return []
    except Exception as e:
        print(f"FAIL  {arch:24s} {shape_name:12s} — {type(e).__name__}: {e}")
        traceback.print_exc(limit=4)
        return [(arch, shape_name, repr(e))]


def _case_lines(arch, shape_name, kw) -> tuple:
    """A worker's case: (its printed lines, its failures)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        fails = _run_one(arch, shape_name, kw)
    return buf.getvalue(), fails


def _run_parallel(cases, kw, jobs) -> list:
    """The cases over ``jobs`` spawned worker processes, the heaviest
    (training, MoE and MLA) first; each case's lines printed as it ends."""
    import concurrent.futures as cf
    import multiprocessing as mp

    def weight(c):
        arch, shape_name = c
        return (get_shape(shape_name).kind != "train",
                arch not in ("deepseek-v2-236b", "grok-1-314b"))

    failures = []
    with cf.ProcessPoolExecutor(jobs, mp.get_context("spawn")) as pool:
        futs = [pool.submit(_case_lines, a, s, kw)
                for a, s in sorted(cases, key=weight)]
        for f in cf.as_completed(futs):
            text, fails = f.result()
            print(text, end="", flush=True)
            failures += fails
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="skip the meta pass (coherence and argument bytes "
                         "only)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes, one case each at a time")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCHITECTURES)
    if not args.arch:  # heaviest case last so partial runs cover more
        archs = [a for a in archs if a != "deepseek-v2-236b"] + ["deepseek-v2-236b"]
    shapes = [args.shape] if args.shape else list(SHAPES)
    if not args.all and not args.arch:
        ap.error("pass --arch/--shape or --all")

    cases = [(a, s) for a in archs for s in shapes]
    kw = dict(multi_pod=args.multipod, save=not args.no_save, fast=args.fast)
    t0 = time.time()
    if args.jobs > 1:
        failures = _run_parallel(cases, kw, args.jobs)
    else:
        failures = [f for a, s in cases for f in _run_one(a, s, kw)]
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print(f"\nall dry-runs passed ({time.time() - t0:.1f} s)")


if __name__ == "__main__":
    main()
