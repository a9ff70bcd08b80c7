"""Step functions shared by the trainer and the server, after the JAX
package's ``training/steps.py``: PyTorch runs them eagerly, so they are
plain closures where JAX's are jit-able."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.schema import tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding.partition import tree_parts, tree_with_parts
from repro_torch.training.optimizer import AdamWConfig, adamw_update


def make_train_step(model, opt_cfg: Optional[AdamWConfig] = None,
                    shard_ctx=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: the loss and every leaf's gradient
    (``torch.autograd.grad``; a leaf the loss does not reach gets zeros,
    as JAX's), then AdamW in place. ``batch`` holds tensors on the model's
    device; the metrics are 0-d tensors there (read them only to log).

    With ``shard_ctx`` (JAX's signature) the step is JAX's sharded one: the
    params and moments laid out by ``sharding.partition.place_for_train``
    and ``adamw_init``, the loss ``model.loss(..., shard_ctx=)`` (the
    batch's tensors, ``features`` included, whole or split by ``batch``),
    the leaves handed to autograd the distinct parts (blocks on devices), a
    block held on several devices given the sum of its copies' gradients;
    the metrics land on the mesh's first device."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        leaves = (tree_parts(params) if shard_ctx is not None
                  else tree_leaves(params))
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = model.loss(params, batch, shard_ctx=shard_ctx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        if shard_ctx is not None:
            grads = tree_map(lambda g: g.sum_copies(),
                             tree_with_parts(params, grads))
        else:
            grads = tree_unflatten(params, grads)
        params, opt_state, gnorm = adamw_update(opt_cfg, grads, opt_state,
                                                params)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_prefill_step(model, shard_ctx=None):
    """``prefill_step(params, batch)``: ``Model.prefill`` on the batch's
    ``tokens`` (and ``features``), under ``shard_ctx`` if given."""

    def prefill_step(params, batch):
        return model.prefill(params, batch["tokens"], batch.get("features"),
                             shard_ctx=shard_ctx)

    return prefill_step


def make_serve_step(model, shard_ctx=None):
    """Decode: ONE token against the KV cache (``Model.decode_step``, under
    ``shard_ctx`` if given: its params and caches laid out by
    ``sharding.partition.place_for_ctx``)."""

    def serve_step(params, caches, tokens, lengths):
        return model.decode_step(params, caches, tokens, lengths,
                                 shard_ctx=shard_ctx)

    return serve_step
