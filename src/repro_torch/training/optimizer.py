"""AdamW (bf16 params, fp32 moments) and its LR schedule, after the JAX
package's ``training/optimizer.py``.

The arithmetic is JAX's, transcribed: the global-norm clip
``min(1, clip / max(gnorm, 1e-9))``, the moments in fp32, the bias
corrections at ``step + 1``, ``m^ / (sqrt(v^) + eps) + wd * p`` with the
decay inside the step and eps after the square root of the corrected v, and
each parameter's update computed in fp32 and cast to its dtype once. It is
not ``torch.optim.AdamW``, which decays by a separate multiply, puts eps
after ``sqrt(v) / sqrt(1 - b2^t)`` and updates bf16 parameters in bf16.
Weight decay applies to every leaf, as in JAX.

The port updates in place: the moments and the parameters are written
under ``torch.no_grad()``, leaf by leaf (one leaf's fp32 temporaries at a
time, not the whole tree's).

A tree laid out for a training context (``sharding.partition.
place_for_train``) has :class:`~repro_torch.sharding.partition.Sharded`
leaves: its moments are split the same way, each part (a block on a
device) is updated on its device with JAX's arithmetic unchanged, and the
global norm counts each distinct block once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models.schema import tree_leaves, tree_map
from repro_torch.sharding.partition import Sharded


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: int
    m: dict
    v: dict


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_at(cfg: AdamWConfig, step) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine down to
    ``min_lr_ratio * lr`` at ``total_steps``; evaluated in fp32 as JAX
    does, returned as the Python float of that fp32 value."""
    step = _f32(int(step))
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(_f32(torch.pi) * frac))
    return float(warm if step < cfg.warmup_steps else cfg.lr * cos)


def _zeros(p):
    """fp32 zeros shaped like ``p``: a Sharded leaf's moment split as it
    is, part by part."""
    if isinstance(p, Sharded):
        return p.map_parts(_zeros)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params) -> AdamWState:
    """Step 0 and fp32 zero moments shaped like every leaf of ``params``
    (split like a Sharded leaf)."""
    return AdamWState(step=0, m=tree_map(_zeros, params),
                      v=tree_map(_zeros, params))


def adamw_init_specs(param_specs) -> AdamWState:
    """The AdamW state as shape-only meta tensors (JAX's
    ``adamw_init_specs``): the step a 0-d int32 (the port keeps it on the
    host; JAX's lives on the device, and the dry-run counts it as JAX
    does), fp32 moments shaped like every leaf of ``param_specs``."""
    meta = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                                 device="meta")
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      m=tree_map(meta, param_specs),
                      v=tree_map(meta, param_specs))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (JAX's order) of each leaf's fp32 sum of
    squares: a 0-d fp32 tensor on the leaves' device. A Sharded leaf's sum
    is over its distinct blocks, each counted once (a block replicated over
    ``model`` is not counted twice), on the mesh's first device."""
    total = None
    with torch.no_grad():
        for g in tree_leaves(tree):
            if isinstance(g, Sharded):
                dev = g.mesh.first_device
                s = sum(t.float().square().sum().to(dev)
                        for _, t in g.blocks().values())
            else:
                s = g.float().square().sum()
            total = s if total is None else total + s
    return torch.sqrt(total)


def _pairs(g, m, v, p):
    """(gradient, m, v, parameter) a part: one tuple for a plain leaf, one
    a part of a Sharded leaf."""
    if isinstance(p, Sharded):
        return zip(g.parts(), m.parts(), v.parts(), p.parts())
    return [(g, m, v, p)]


def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW step on ``params`` with ``grads`` (trees of one
    structure). Updates the parameters and the moments in place and returns
    (params, the new state, the pre-clip global gradient norm)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = float(1 - _f32(cfg.b1) ** _f32(step))
    b2c = float(1 - _f32(cfg.b2) ** _f32(step))
    parts = [q for leaves in zip(tree_leaves(grads), tree_leaves(state.m),
                                 tree_leaves(state.v), tree_leaves(params))
             for q in _pairs(*leaves)]
    with torch.no_grad():
        for g, m, v, p in parts:
            g = g.float() * scale.to(g.device)
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
            p32 = p.float()
            delta.add_(p32, alpha=cfg.weight_decay)
            p.copy_(p32.sub_(delta, alpha=lr))
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
