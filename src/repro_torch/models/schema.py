"""Parameter schema: declare each weight once (shape + logical axes + init
rule).

A schema is a nested structure of dicts and lists whose leaves are
:class:`ParamSpec`; :func:`init_params` turns it into the same structure of
tensors, :func:`meta_params` into shape-only tensors on the meta device
(the dry-run's), :func:`partition_specs` into one partition spec a leaf.

Logical axis names (the JAX package's): batch, seq, embed, heads,
kv_heads, head_dim, ffn, vocab, experts, expert_embed, expert_ffn,
ssm_heads, ssm_in, state, conv, lora, rope, frontend, layers (stacking).
``repro_torch.sharding.partition.make_rules`` maps them to mesh axes.

Init rules follow the JAX package's ``models/schema.py``: ``normal`` draws N(0, 1) * 1/sqrt(fan_in) (fan_in = the first dim), ``small_normal``
N(0, 1) * 0.02, ``ones`` and ``zeros`` constants. The random numbers come
from the caller's ``torch.Generator``, so they differ from JAX's; tests
carry the JAX weights across with :mod:`repro_torch.models.convert`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis name (or None) per dim
    init: str = "normal"  # normal | zeros | ones | small_normal
    scale: Optional[float] = None  # fan-in scale override

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _init_leaf(gen, spec: ParamSpec, dtype, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[0], 1)
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    if spec.init == "small_normal":
        scale = 0.02
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict/list structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def init_params(gen: torch.Generator, schema, dtype, device):
    """Draw every leaf of ``schema`` from ``gen`` on ``device`` (the
    generator must live on that device)."""
    return tree_map(lambda s: _init_leaf(gen, s, dtype, device), schema)


def meta_params(schema, dtype):
    """Shape-only tensors on the meta device, one a leaf: what the dry-run
    runs a step on (no generator, no storage)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"),
                    schema)


def spec(rules: dict, axes) -> tuple:
    """A partition spec: one entry a logical axis of ``axes``, ``rules[axis]``
    (a mesh-axis name, a tuple of names, or None: replicated), None for an
    unnamed one; a one-name tuple written as the name -- what JAX's
    ``PartitionSpec`` holds."""
    out = []
    for a in axes:
        m = rules.get(a) if a is not None else None
        out.append(m[0] if isinstance(m, (tuple, list)) and len(m) == 1
                   else m)
    return tuple(out)


def partition_specs(schema, rules: dict):
    """One :func:`spec` a leaf."""
    return tree_map(lambda s: spec(rules, s.axes), schema)


def stack(schema, n: int):
    """Prepend a ``"layers"`` stacking dim of size ``n`` to every leaf: the
    JAX package's layout of a scanned group (the port keeps one entry a
    layer instead)."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        s.init, s.scale), schema)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list structure in JAX's order: a dict's
    entries by sorted key, a list's in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves, in :func:`tree_leaves` order,
    replaced by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out
