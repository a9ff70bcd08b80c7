"""Logical-axis -> mesh-axis rules, the ShardCtx passed through models and
the placing of tensors on a mesh's devices, after the JAX package's
``sharding/partition.py``.

The logical half: :func:`make_rules` (per arch, input shape and mesh,
divisibility-aware) and :class:`ShardCtx`'s specs, over a mesh that needs
nothing but ``shape`` (axis name -> size), such as
:class:`repro_torch.launch.mesh.LogicalMesh`. A spec is a plain tuple, one
entry a dim: None, a mesh-axis name or a tuple of names (what JAX's
``PartitionSpec`` holds).

The placing half, over a :class:`repro_torch.launch.mesh.DeviceMesh`:

* the pod slices (:func:`pod_slice_mesh`, :func:`slice_sharding`,
  :func:`place_on_slice`) that the disaggregated tier and the cluster pin
  their stages and replicas to;
* :class:`Sharded`, a tensor split by a spec over the mesh's slots, each
  local tensor on its slot's device, with the reductions (:func:`psum`,
  :func:`pmax`) the model's shard bodies need -- the vocab-parallel
  embedding, the sequence-sharded ring and latent decode -- where JAX runs
  a ``shard_map``;
* :func:`place_for_ctx`, which lays a model's params and caches out for a
  serving context: the embedding table by ``vocab``, the attention and
  latent caches by ``kv_seq``;
* :func:`place_for_train`, which splits every parameter leaf by its spec
  for a training context (FSDP: ``embed`` over ``data``; Megatron:
  ``heads``, ``kv_heads``, ``ffn``, ``vocab``, the experts and the SSM's
  ``ssm_heads`` / ``ssm_in`` over ``model``), and the differentiable moves
  a training pass runs between the slots: :func:`gathered` (an all-gather
  of some dims of a slot's block), :func:`fsdp_gather` (a weight gathered
  over every axis but the tensor axis) and :func:`psum_scatter` (the
  partials of a row-parallel product summed onto the slots holding each
  block of the result).

One controller places everything: there are no process groups. A move is
``.to(device)``, ``narrow`` and ``torch.cat``, which autograd
differentiates: the gradient of a gathered tensor flows back to each block,
summed over the slots that read it (FSDP's reduce-scatter), and a block
that is an autograd leaf collects it. Outside a training pass and the
serving shard bodies a tensor lives whole on the mesh's first device, and
:meth:`ShardCtx.constrain` checks that it divides as its spec says and
returns it unchanged (JAX's constraint changes no value either).
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch

from repro_torch.launch.mesh import DeviceMesh


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The rules a model's distributed ops read. ``rules`` maps logical axis
    names (see ``models/schema.py``) to a mesh axis name, a tuple of mesh
    axis names, or None (replicated)."""

    mesh: object
    rules: dict

    @property
    def shards_vocab(self) -> bool:
        return self.rules.get("vocab") is not None

    @property
    def kv_seq_axes(self):
        return self.rules.get("kv_seq")

    @property
    def batch_axes(self):
        return self.rules.get("batch")

    def axis_size(self, logical: str) -> int:
        ax = self.rules.get(logical)
        if ax is None:
            return 1
        if isinstance(ax, (tuple, list)):
            size = 1
            for a in ax:
                size *= self.mesh.shape[a]
            return size
        return self.mesh.shape[ax]

    def activation_pspec(self, ndim: int, batch_dim: int = 0) -> tuple:
        parts = [None] * ndim
        parts[batch_dim] = "batch"
        return self.spec(*parts)

    def spec(self, *logical) -> tuple:
        from repro_torch.models import schema

        return schema.spec(self.rules, logical)

    def sharding(self, *logical) -> "NamedSharding":
        """Where a tensor with these logical axes lives on the mesh."""
        return NamedSharding(self.mesh, self.spec(*logical))

    def constrain(self, x, *logical):
        """``x`` itself, once each of its dims divides the mesh axes its
        logical axis maps to (JAX's ``with_sharding_constraint`` changes no
        value). Serving keeps such tensors whole on the mesh's first
        device; a training pass moves its blocks with :func:`gathered` and
        :func:`psum_scatter` instead."""
        spec = self.spec(*logical)
        if len(spec) != x.ndim:
            raise ValueError(f"constrain: {len(spec)} logical axes for a "
                             f"{x.ndim}-d tensor")
        for dim, part in zip(x.shape, spec):
            n = math.prod(self.mesh.shape[a] for a in axes_of(part))
            if dim % n:
                raise ValueError(f"constrain: dim {dim} of {tuple(x.shape)} "
                                 f"does not divide {part!r} ({n} ways)")
        return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (JAX's ``NamedSharding``): where a tensor's dims
    go. A spec of all None (or empty) replicates over the mesh."""

    mesh: object
    spec: tuple = ()

    @property
    def is_fully_replicated(self) -> bool:
        return all(p is None for p in self.spec)


def axes_of(part) -> tuple:
    """A spec entry's mesh axes: () for None, one name, or the tuple."""
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def pod_slice_mesh(mesh: DeviceMesh, pods, axis: str = "pod") -> DeviceMesh:
    """Sub-mesh over the ``pods`` indices of ``mesh``'s ``axis``, every
    other axis and all axis names kept (the JAX package's
    ``pod_slice_mesh``). Two calls with the same mesh and indices give
    equal meshes."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis!r} axis: {mesh.axis_names}")
    pods = tuple(pods)
    if not pods:
        raise ValueError("empty pod slice")
    size = mesh.shape[axis]
    bad = [p for p in pods if not 0 <= p < size]
    if bad:
        raise ValueError(f"pod indices {bad} out of range for {axis}={size}")
    ax = mesh.axis_names.index(axis)
    devs = np.take(mesh.devices, np.asarray(pods), axis=ax)
    return DeviceMesh(devs, mesh.axis_names)


def slice_sharding(mesh: DeviceMesh, pods, spec: tuple = (),
                   axis: str = "pod") -> NamedSharding:
    """A sharding scoped to the ``pods`` slice of ``mesh``'s ``axis``;
    ``spec=()`` (the default) replicates over the slice."""
    return NamedSharding(pod_slice_mesh(mesh, pods, axis), spec)


def place_on_slice(tree, mesh: DeviceMesh, pods, spec: tuple = (),
                   axis: str = "pod"):
    """Every tensor of ``tree`` (nested dicts and lists) on the ``pods``
    slice. Replicated (the default): whole on the slice's first device,
    where the port runs a stage -- ``tree`` itself when every tensor is
    already there, else a tree of copies (a tensor already there kept).
    Any other spec splits each leaf over the slice (:class:`Sharded`)."""
    from repro_torch.models.schema import tree_leaves, tree_map

    sub = pod_slice_mesh(mesh, pods, axis)
    if all(p is None for p in spec):
        dev = sub.first_device
        if all(t.device == dev for t in tree_leaves(tree)):
            return tree
        return tree_map(lambda t: t.to(dev), tree)
    return tree_map(lambda t: Sharded.split(t, sub, spec), tree)


def shard_index(mesh, coord, axes) -> int:
    """The block a slot holds along a dim split over ``axes``: row-major
    over the axes in their order (JAX's ``_shard_index``)."""
    idx = 0
    for a in axes:
        i = mesh.axis_names.index(a)
        idx = idx * mesh.sizes[i] + coord[i]
    return idx


class Sharded:
    """A tensor split by ``spec`` (one entry a dim) over ``mesh``'s slots:
    ``locals[coord]`` is the block slot ``coord`` holds, on that slot's
    device. A dim split over axes of n slots in all is cut into n equal
    blocks, block :func:`shard_index` going to a slot; a dim whose entry is
    None stays whole. Slots that hold the same block on the same device
    share one tensor, and a block on the device the source tensor lives on
    is a view of it: no copy, and writes into the block (a ring write) land
    in the source -- hand it over, do not keep using it. ``shape`` and
    ``dtype`` are the whole tensor's."""

    def __init__(self, mesh, spec, shape, dtype, locals_):
        self.mesh, self.spec = mesh, tuple(spec)
        self.shape, self.dtype = torch.Size(shape), dtype
        self.locals = locals_

    @classmethod
    def split(cls, x, mesh, spec) -> "Sharded":
        spec = tuple(spec) + (None,) * (x.ndim - len(spec))
        counts = [math.prod(mesh.shape[a] for a in axes_of(p)) for p in spec]
        for dim, n, p in zip(x.shape, counts, spec):
            if dim % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split {n} ways over {p!r}")
        made, locals_ = {}, {}
        for coord in mesh.coords():
            block = tuple(shard_index(mesh, coord, axes_of(p)) for p in spec)
            dev = mesh.device_at(coord)
            if (block, dev) not in made:
                t = x
                for d, (b, n) in enumerate(zip(block, counts)):
                    if n > 1:
                        w = x.shape[d] // n
                        t = t.narrow(d, b * w, w)
                made[block, dev] = t.to(dev)
            locals_[coord] = made[block, dev]
        return cls(mesh, spec, x.shape, x.dtype, locals_)

    def block(self, coord) -> tuple:
        """The block index, one a dim, that slot ``coord`` holds."""
        return tuple(shard_index(self.mesh, coord, axes_of(p))
                     for p in self.spec)

    def counts(self) -> tuple:
        """Blocks along each dim."""
        return tuple(math.prod(self.mesh.shape[a] for a in axes_of(p))
                     for p in self.spec)

    def blocks(self) -> dict:
        """block -> (the first slot holding it, its tensor there)."""
        out = {}
        for coord in self.mesh.coords():
            out.setdefault(self.block(coord), (coord, self.locals[coord]))
        return out

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first), a
        copy outside any autograd graph."""
        device = self.mesh.first_device if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        with torch.no_grad():
            for block, (_, t) in self.blocks().items():
                dst = out
                for d, b in enumerate(block):
                    w = t.shape[d]
                    dst = dst.narrow(d, b * w, w)
                dst.copy_(t)
        return out

    def parts(self) -> list:
        """The distinct local tensors, one a (block, device), in slot
        order: what a training step differentiates and updates (a block
        held on two devices is two parts, kept equal)."""
        seen, out = set(), []
        for coord in self.mesh.coords():
            t = self.locals[coord]
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    def with_parts(self, parts) -> "Sharded":
        """This layout over ``parts`` (one a :meth:`parts` entry, in its
        order): the slots that share a tensor share its replacement."""
        it = iter(parts)
        made, locals_ = {}, {}
        for coord in self.mesh.coords():
            t = self.locals[coord]
            if id(t) not in made:
                made[id(t)] = next(it)
            locals_[coord] = made[id(t)]
        dtype = next(iter(made.values())).dtype
        return Sharded(self.mesh, self.spec, self.shape, dtype, locals_)

    def map_parts(self, fn) -> "Sharded":
        """This layout with each part ``t`` replaced by ``fn(t)``."""
        return self.with_parts([fn(t) for t in self.parts()])

    def sum_copies(self) -> "Sharded":
        """Each block's copies (the parts holding one block on several
        devices) replaced by their sum, on each copy's device: the
        all-reduce of a replicated parameter's gradient."""
        by_block = {}
        for coord in self.mesh.coords():
            t = self.locals[coord]
            group = by_block.setdefault(self.block(coord), [])
            if all(t is not u for u in group):
                group.append(t)
        if all(len(g) == 1 for g in by_block.values()):
            return self
        total = {id(t): psum(g, t.device) for g in by_block.values()
                 for t in g}
        return self.map_parts(lambda t: total[id(t)])

    def __repr__(self):
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, spec="
                f"{self.spec}, mesh={self.mesh.shape})")


def gathered(sh: Sharded, coord, dims, cache=None) -> torch.Tensor:
    """Slot ``coord``'s block of ``sh`` with ``dims`` made whole: every
    block along those dims (the slot's own index on the others), each
    taken from a slot on ``coord``'s device where one holds it, moved there
    and concatenated in block order -- an all-gather, differentiable.
    ``cache`` (a dict a pass keeps) reuses one gather for every slot on a
    device that needs the same one."""
    counts = sh.counts()
    dims = tuple(d for d in dims if counts[d] > 1)
    if not dims:
        return sh.locals[tuple(coord)]
    dev = sh.mesh.device_at(coord)
    want = list(sh.block(coord))
    key = (id(sh), tuple(None if d in dims else b for d, b in enumerate(want)),
           dev)
    if cache is not None and key in cache:
        return cache[key][1]
    holders = {}
    for c in sh.mesh.coords():
        b, t = sh.block(c), sh.locals[c]
        if b not in holders or (holders[b].device != dev and t.device == dev):
            holders[b] = t

    def build(i):
        if i == len(dims):
            return holders[tuple(want)].to(dev)
        pieces = []
        for j in range(counts[dims[i]]):
            want[dims[i]] = j
            pieces.append(build(i + 1))
        return torch.cat(pieces, dim=dims[i])

    out = build(0)
    if cache is not None:
        cache[key] = (sh, out)  # sh kept alive: its id stays its own
    return out


def fsdp_gather(w: Sharded, coord, cache=None, keep="model") -> torch.Tensor:
    """A weight as slot ``coord`` computes with it: every dim split over an
    axis other than ``keep`` (FSDP's ``data``) gathered, the dims split
    over ``keep`` (the tensor axis) left as the slot's block. ``keep=None``
    gathers the whole weight."""
    dims = [d for d, p in enumerate(w.spec)
            if axes_of(p) and (keep is None or keep not in axes_of(p))]
    return gathered(w, coord, dims, cache)


def psum_scatter(partials: dict, mesh, axis, dim, blocks_axes, summed,
                 coords) -> dict:
    """The row-parallel reduction: slot ``c``'s result is the sum over
    ``axis`` (every slot that differs from ``c`` on that axis alone, in
    axis order) of their ``partials`` -- or ``c``'s own partial where
    ``summed`` is False (the product was not split over ``axis``) --
    narrowed along ``dim`` to ``c``'s block of the mesh axes
    ``blocks_axes`` (a reduce-scatter; with no such axes an all-reduce),
    on ``c``'s device. ``partials`` maps each slot of ``coords`` to a
    tensor whole along ``dim``; the results, one a slot of ``coords``, are
    contiguous."""
    ai = mesh.axis_names.index(axis) if axis in mesh.axis_names else None
    n = math.prod(mesh.shape[a] for a in blocks_axes)
    out = {}
    for c in coords:
        dev = mesh.device_at(c)
        srcs = [c]
        if summed and ai is not None:
            srcs = [c[:ai] + (j,) + c[ai + 1:] for j in range(mesh.sizes[ai])]
        blk = shard_index(mesh, c, blocks_axes)
        parts = []
        for s in srcs:
            p = partials[s]
            w = p.shape[dim] // n
            parts.append(p.narrow(dim, blk * w, w))
        out[c] = psum(parts, dev).contiguous()
    return out


class _Recompute(torch.autograd.Function):
    """:func:`recompute`'s node: the forward without a graph, the backward
    a second forward with one and its ``torch.autograd.grad``."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        ctx.fn = fn
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            return tuple(fn(*tensors))

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.fn(*inputs)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        want = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                       [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and want else [None] * len(want))
        return (None, *(next(got) if t.requires_grad else None
                        for t in inputs))


def recompute(fn, *tensors) -> tuple:
    """``fn(*tensors)`` (a tuple of tensors) saved for the backward as its
    inputs alone and run again there: full rematerialisation, for a pass
    that spans several devices. ``torch.utils.checkpoint``'s non-reentrant
    form recomputes from whichever device's autograd thread first reads a
    saved tensor, and two devices' threads can start it at once; this node
    runs its backward once, on one thread. ``tensors`` must hold every
    tensor ``fn`` differentiates (the weights too, not captured)."""
    return _Recompute.apply(fn, *tensors)


class SlotPass:
    """One sharded training pass over ``ctx``'s mesh: each slot computes
    its own block on its own device. The residual stream [B, S, width] is
    split ("batch", "act_seq", None): a slot holds its batch rows' block of
    positions. A layer gathers the positions it needs (:meth:`full_seq`)
    and the weights (:meth:`weight`, FSDP's gather over ``data``), and
    reduce-scatters its row-parallel partials back (:meth:`reduce`).
    :meth:`scope` gives a copy with its own gather cache: a layer takes one
    for its pass, so no gathered weight outlives the layer (under remat the
    backward's recompute gathers again).

    :attr:`coords` are the slots that compute: one for each (block of the
    residual, ``model`` index). Where the rules leave the batch whole (a
    global batch that does not divide the batch axes) the slots that
    differ on those axes alone would compute the same rows; only the first
    does, and the rest hold its blocks (:meth:`act`) and lend their weight
    blocks to its gathers."""

    def __init__(self, ctx: ShardCtx, batch: int, seq: int):
        mesh = ctx.mesh
        self.ctx, self.mesh = ctx, mesh
        self.act_spec = ctx.spec("batch", "act_seq", None)
        self.batch_axes = axes_of(self.act_spec[0])
        self.seq_axes = axes_of(self.act_spec[1])
        self.nb = math.prod(mesh.shape[a] for a in self.batch_axes)
        self.ns = math.prod(mesh.shape[a] for a in self.seq_axes)
        if batch % self.nb or seq % self.ns:
            raise ValueError(f"a [{batch}, {seq}] batch does not split "
                             f"{self.nb} x {self.ns} ways over "
                             f"{self.act_spec[:2]}")
        self.B, self.S = batch, seq
        mi = (mesh.axis_names.index("model") if "model" in mesh.axis_names
              else None)
        first, self.rep = {}, {}
        for c in mesh.coords():
            key = (shard_index(mesh, c, self.batch_axes),
                   shard_index(mesh, c, self.seq_axes),
                   None if mi is None else c[mi])
            self.rep[c] = first.setdefault(key, c)
        self.coords = list(dict.fromkeys(self.rep.values()))
        self.cache = {}

    def scope(self) -> "SlotPass":
        out = copy.copy(self)
        out.cache = {}
        return out

    def dev(self, c) -> torch.device:
        return self.mesh.device_at(c)

    def count(self, logical: str) -> int:
        """Blocks the rules split a logical axis into."""
        return self.ctx.axis_size(logical)

    def index(self, logical: str, c) -> int:
        """Slot ``c``'s block of a logical axis (0 where it is whole)."""
        return shard_index(self.mesh, c, axes_of(self.ctx.rules.get(logical)))

    def rows(self, c) -> slice:
        b = self.B // self.nb
        i = shard_index(self.mesh, c, self.batch_axes)
        return slice(i * b, (i + 1) * b)

    def cols(self, c) -> slice:
        s = self.S // self.ns
        i = shard_index(self.mesh, c, self.seq_axes)
        return slice(i * s, (i + 1) * s)

    def model_row(self, c) -> list:
        """The slots that differ from ``c`` on the ``model`` axis alone."""
        if "model" not in self.mesh.axis_names:
            return [tuple(c)]
        ai = self.mesh.axis_names.index("model")
        return [c[:ai] + (j,) + c[ai + 1:] for j in range(self.mesh.sizes[ai])]

    def act(self, locals_: dict, width: int) -> Sharded:
        """A residual-stream tensor [B, S, width] from each computing
        slot's block (:attr:`coords`); a slot that does not compute holds
        its representative's."""
        return self._from_slots(self.act_spec, (self.B, self.S, width),
                                locals_)

    def like(self, sh: Sharded, locals_: dict) -> Sharded:
        """``sh``'s layout (a tensor split over this pass's batch blocks)
        over new blocks, one a computing slot."""
        return self._from_slots(sh.spec, sh.shape, locals_)

    def split_cols(self, locals_: dict, width: int, logical: str) -> Sharded:
        """A tensor [B, S, width] whose last dim the rules split by
        ``logical``, from each computing slot's block [b, S, width / n]
        (its batch rows at every position, its columns): a tensor-parallel
        activation that :meth:`full_cols` makes whole again."""
        spec = (self.act_spec[0], None, self.ctx.rules.get(logical))
        return self._from_slots(spec, (self.B, self.S, width), locals_)

    def _from_slots(self, spec, shape, locals_: dict) -> Sharded:
        dtype = next(iter(locals_.values())).dtype
        return Sharded(self.mesh, spec, shape, dtype,
                       {c: locals_[r] for c, r in self.rep.items()})

    def full_cols(self, x: Sharded, c) -> torch.Tensor:
        """Slot ``c``'s batch rows of a :meth:`split_cols` tensor with
        every column: its ``model`` row's blocks gathered."""
        return gathered(x, c, (2,), self.cache)

    def weight(self, w: Sharded, c, keep="model") -> torch.Tensor:
        return fsdp_gather(w, c, self.cache, keep)

    def full_seq(self, x: Sharded, c) -> torch.Tensor:
        """Slot ``c``'s batch rows of ``x`` (a tensor split over this
        pass's batch blocks, at any length) at every position."""
        return gathered(x, c, (1,), self.cache)

    def whole(self, x: Sharded, c) -> torch.Tensor:
        """All of ``x`` on ``c``'s device."""
        return gathered(x, c, (0, 1), self.cache)

    def reduce(self, partials: dict, summed: bool) -> dict:
        """Row-parallel partials [b, S, width] (one a computing slot)
        summed over ``model`` where ``summed`` (else each slot's own), each
        slot's block of positions kept."""
        return psum_scatter(partials, self.mesh, "model", 1, self.seq_axes,
                            summed, self.coords)

    def batch_rows(self, t, c) -> torch.Tensor:
        """Slot ``c``'s rows of a batch tensor [B, ...] on its device: the
        local block of a :class:`Sharded` one split by ``batch``, else
        the rows of a whole one (one copy a device)."""
        if isinstance(t, Sharded):
            return t.locals[tuple(c)]
        key = ("rows", id(t), self.rows(c).start, self.dev(c))
        if key not in self.cache:
            self.cache[key] = (t, t[self.rows(c)].to(self.dev(c)))
        return self.cache[key][1]

    def positions(self, c) -> torch.Tensor:
        key = ("positions", self.dev(c))
        if key not in self.cache:
            self.cache[key] = torch.arange(self.S, device=self.dev(c))[None]
        return self.cache[key]


def shard(x, ctx: ShardCtx, *logical) -> Sharded:
    """``x`` split over ``ctx``'s mesh by its logical axes' spec."""
    return Sharded.split(x, ctx.mesh, ctx.spec(*logical))


def psum(parts, device) -> torch.Tensor:
    """The sum of ``parts`` (one a slot, in slot order), on ``device``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def pmax(parts, device) -> torch.Tensor:
    """The elementwise max of ``parts`` (one a slot), on ``device``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(device))
    return out


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def make_rules(cfg, mesh, shape=None) -> dict:
    """Per-(arch, mesh, input-shape) logical->mesh rules.

    Divisibility-aware: any logical axis whose size does not divide the mesh
    axis is replicated (e.g. GQA kv_heads=8 on model=16 is replicated, which
    is exactly what Megatron-style TP does).
    """
    from repro_torch.models.layers import pad_vocab

    axes = dict(mesh.shape)
    model = "model" if "model" in axes else None
    msize = axes.get("model", 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    bsize = 1
    for a in batch_axes:
        bsize *= axes[a]

    rules: dict = {
        "embed": None,
        "seq": None,
        "head_dim": None,
        "state": None,
        "conv": None,
        "layers": None,
        "lora": None,
        "rope": None,
        "kv_seq": None,
        "frontend": None,
    }

    gb = shape.global_batch if shape is not None else None
    if gb is None or _div(gb, bsize):
        rules["batch"] = batch_axes if batch_axes else None
        if shape is not None and shape.is_decode and model is not None:
            # decode: GQA/MLA caches cannot head-shard across model=16, so
            # the cache's SEQUENCE dim goes over "model" (flash-decoding
            # within each model group)
            rules["kv_seq"] = (model,)
    else:
        # long_500k (batch=1): batch replicated; the KV cache sequence-
        # sharded over the ENTIRE mesh instead (524288 slots / 256 = 2048 a
        # device)
        rules["batch"] = None
        if shape is not None and shape.is_decode:
            seq_axes = batch_axes + ((model,) if model else ())
            rules["kv_seq"] = seq_axes if seq_axes else None

    # training: FSDP (weights and optimizer state over "data") + sequence
    # parallelism (activations seq-sharded over "model" between layers)
    dsize = axes.get("data", 1)
    if shape is not None and shape.kind == "train" and _div(cfg.d_model, dsize):
        rules["embed"] = "data"
    if (
        shape is not None
        and shape.kind in ("train", "prefill")
        and model is not None
        and _div(shape.seq_len, msize)
    ):
        rules["act_seq"] = model
    else:
        rules["act_seq"] = None

    rules["vocab"] = model if _div(pad_vocab(cfg.vocab_size), msize) else None
    rules["heads"] = model if cfg.n_heads and _div(cfg.n_heads, msize) else None
    rules["kv_heads"] = (
        model if cfg.n_kv_heads and _div(cfg.n_kv_heads, msize) else None
    )
    rules["ffn"] = model if cfg.d_ff and _div(cfg.d_ff, msize) else None

    if cfg.moe is not None:
        if _div(cfg.moe.n_experts, msize):
            rules["experts"] = model
            rules["expert_ffn"] = None
        else:  # e.g. grok-1: 8 experts on model=16 -> TP inside each expert
            rules["experts"] = None
            rules["expert_ffn"] = model if _div(cfg.moe.d_ff, msize) else None
        # second shard dim for expert weights + dispatch capacity over "data"
        rules["expert_embed"] = (
            "data" if "data" in axes and _div(cfg.d_model, axes["data"]) else None
        )
        rules["moe_cap"] = "data" if "data" in axes else None
        # the flattened [B*S] token dim of the dispatch tensors, sharded as
        # the residual stream is (batch x seq axes)
        tok_axes = tuple(
            a for a in (batch_axes + ((model,) if rules.get("act_seq") else ()))
            if a
        )
        rules["moe_tokens"] = tok_axes if tok_axes else None
    else:
        rules["experts"] = None
        rules["expert_ffn"] = None
        rules["expert_embed"] = None
        rules["moe_cap"] = None

    if cfg.ssm is not None:
        nh = cfg.ssm.n_heads(cfg.d_model)
        ok = _div(nh, msize)
        rules["ssm_heads"] = model if ok else None
        rules["ssm_in"] = model if ok else None
    else:
        rules["ssm_heads"] = None
        rules["ssm_in"] = None
    return rules


def make_ctx(cfg, mesh, shape=None) -> ShardCtx:
    return ShardCtx(mesh=mesh, rules=make_rules(cfg, mesh, shape))


def spec_axes(spec) -> tuple:
    """The distinct mesh axes a spec names (entries None, a name or a tuple
    of names), in first-seen order."""
    out = []
    for part in spec:
        for ax in (part if isinstance(part, (tuple, list)) else (part,)):
            if ax is not None and ax not in out:
                out.append(ax)
    return tuple(out)


def mesh_axes(rules: dict, logical) -> tuple:
    """The distinct mesh axes that ``rules`` map the logical axes of
    ``logical`` (None entries skipped) to, in first-seen order."""
    return spec_axes(rules.get(a) if a is not None else None for a in logical)


def shard_count(rules: dict, mesh_shape: dict, logical) -> int:
    """How many ways work over the logical axes of ``logical`` splits on the
    mesh: the product of the sizes of their distinct mesh axes (an axis
    named twice counts once)."""
    n = 1
    for ax in mesh_axes(rules, logical):
        n *= mesh_shape[ax]
    return n


def spec_bytes_per_device(shape, itemsize: int, spec, mesh_shape: dict) -> int:
    """Bytes a device holds of a tensor of ``shape`` under ``spec`` (one
    entry a dim): each dim divided by the product of its mesh axes' sizes,
    rounded up."""
    n = itemsize
    for dim, part in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        k = 1
        for ax in (part if isinstance(part, (tuple, list)) else (part,)):
            if ax is not None:
                k *= mesh_shape[ax]
        n *= -(-dim // k)
    return n


def _split_or_whole(t, mesh, spec):
    """``t`` split by ``spec`` when the spec names a mesh axis, else whole
    on the mesh's first device."""
    if any(axes_of(p) for p in spec):
        return Sharded.split(t, mesh, spec)
    return t.to(mesh.first_device)


def place_for_ctx(model, ctx: ShardCtx, params=None, caches=None):
    """``(params, caches)`` laid out for ``ctx`` from the model's
    ``param_pspecs`` and ``cache_pspecs`` under its rules: the embedding
    table split by its ``vocab`` spec, each attention or latent cache leaf
    (k, v, ckv, krope) by its ``kv_seq`` spec (batch by ``batch``), every
    other leaf whole on the mesh's first device -- the dense, MoE, SSM and
    cross leaves, whose tensor-parallel specs are the training slice's.
    Either tree may be None (returned as None). A split cache leaf's blocks
    on the first device are views of the leaf given."""
    from repro_torch.models.kvcache import SEQ_KEYS
    from repro_torch.models.schema import tree_map

    mesh, first = ctx.mesh, ctx.mesh.first_device
    out_p = out_c = None
    if params is not None:
        out_p = {k: (tree_map(lambda t: t.to(first), v) if k != "embed"
                     else _split_or_whole(v, mesh,
                                          model.param_pspecs(ctx.rules)[k]))
                 for k, v in params.items()}
    if caches is not None:
        specs = model.cache_pspecs(ctx.rules)
        out_c = {g: [{ln: {key: (_split_or_whole(t, mesh, specs[g][i][ln][key])
                                 if key in SEQ_KEYS else t.to(first))
                           for key, t in leaves.items()}
                      for ln, leaves in block.items()}
                     for i, block in enumerate(group)]
                 for g, group in caches.items()}
    return out_p, out_c


def place_for_train(model, ctx: ShardCtx, params):
    """``params`` laid out for a training context: every leaf split by its
    ``param_pspecs(ctx.rules)`` spec over ``ctx``'s mesh -- the ``embed``
    dim over ``data`` (FSDP), ``heads``, ``kv_heads``, ``ffn``, ``vocab``,
    ``experts`` or ``expert_ffn`` over ``model`` where the rules split them
    -- a leaf whose spec names no axis as one block. Each part (a block on
    a device) is a fresh contiguous tensor, so a step updates it without
    touching ``params``; :func:`repro_torch.training.adamw_init` of the
    result gives moments split the same way."""
    from repro_torch.models.schema import tree_leaves, tree_unflatten

    mesh = ctx.mesh
    specs = tree_leaves(model.param_pspecs(ctx.rules))
    leaves = tree_leaves(params)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(leaves)} parameter leaves for {len(specs)} "
                         "specs")

    def place(t, spec):
        src = t.detach()
        return Sharded.split(src, mesh, spec).map_parts(
            lambda b: (b.clone(memory_format=torch.contiguous_format)
                       if b.device == src.device else b.contiguous()))

    return tree_unflatten(params, [place(t, s) for t, s in zip(leaves, specs)])


def tree_parts(tree) -> list:
    """Every part of a tree of :class:`Sharded` leaves, in leaf order: what
    a sharded step differentiates."""
    from repro_torch.models.schema import tree_leaves

    return [p for leaf in tree_leaves(tree) for p in leaf.parts()]


def tree_with_parts(like, parts):
    """``like``'s structure and layouts over ``parts`` (in
    :func:`tree_parts` order)."""
    from repro_torch.models.schema import tree_leaves, tree_unflatten

    it = iter(parts)
    return tree_unflatten(like, [
        leaf.with_parts([next(it) for _ in leaf.parts()])
        for leaf in tree_leaves(like)])


def gather_tree(tree, device=None):
    """A tree with every :class:`Sharded` leaf gathered whole on ``device``
    (default: the mesh's first), other leaves as they are."""
    from repro_torch.models.schema import tree_map

    return tree_map(lambda t: t.gather(device) if isinstance(t, Sharded)
                    else t, tree)
