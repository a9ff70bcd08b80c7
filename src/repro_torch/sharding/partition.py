"""Logical-axis -> mesh-axis rules and the ShardCtx, after the JAX package's
``sharding/partition.py``.

The logical half only: :func:`make_rules` (per arch, input shape and mesh,
divisibility-aware) and :class:`ShardCtx`'s specs, over a mesh that needs
nothing but ``shape`` (axis name -> size), such as
:class:`repro_torch.launch.mesh.LogicalMesh`. A spec is a plain tuple, one
entry a dim: None, a mesh-axis name or a tuple of names (what JAX's
``PartitionSpec`` holds). Placing tensors on a mesh of cards
(``constrain``, ``sharding``, the pod slices) is not part of the port yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models import schema
from repro_torch.models.layers import pad_vocab


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
        return schema.spec(self.rules, parts)

    def spec(self, *logical) -> tuple:
        return schema.spec(self.rules, logical)


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def make_rules(cfg, mesh, shape=None) -> dict:
    """Per-(arch, mesh, input-shape) logical->mesh rules.

    Divisibility-aware: any logical axis whose size does not divide the mesh
    axis is replicated (e.g. GQA kv_heads=8 on model=16 is replicated, which
    is exactly what Megatron-style TP does).
    """
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
