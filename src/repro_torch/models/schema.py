"""Parameter schema: declare each weight once (shape + init rule).

A schema is a nested structure of dicts and lists whose leaves are
:class:`ParamSpec`; :func:`init_params` turns it into the same structure of
tensors. Init rules follow the JAX package's ``models/schema.py``: ``normal``
draws N(0, 1) * 1/sqrt(fan_in) (fan_in = the first dim), ``small_normal``
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
    init: str = "normal"  # normal | zeros | ones | small_normal
    scale: Optional[float] = None  # fan-in scale override


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
