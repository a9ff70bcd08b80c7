"""Step functions shared by the trainer and the server, after the JAX
package's ``training/steps.py``: PyTorch runs them eagerly, so they are
plain closures where JAX's are jit-able."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.schema import tree_leaves, tree_unflatten
from repro_torch.training.optimizer import AdamWConfig, adamw_update


def make_train_step(model, opt_cfg: Optional[AdamWConfig] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: the loss and every leaf's gradient
    (``torch.autograd.grad``; a leaf the loss does not reach gets zeros,
    as JAX's), then AdamW in place. ``batch`` holds tensors on the model's
    device; the metrics are 0-d tensors there (read them only to log)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        params, opt_state, gnorm = adamw_update(
            opt_cfg, tree_unflatten(params, grads), opt_state, params)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_prefill_step(model):
    """``prefill_step(params, batch)``: ``Model.prefill`` on the batch's
    ``tokens`` (and ``features``)."""

    def prefill_step(params, batch):
        return model.prefill(params, batch["tokens"], batch.get("features"))

    return prefill_step


def make_serve_step(model):
    """Decode: ONE token against the KV cache (``Model.decode_step``)."""

    def serve_step(params, caches, tokens, lengths):
        return model.decode_step(params, caches, tokens, lengths)

    return serve_step
