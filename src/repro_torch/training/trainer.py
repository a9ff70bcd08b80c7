"""Training loop: data pipeline -> train_step -> metrics/checkpoints, after
the JAX package's ``training/trainer.py``.

The parameters train in place (where JAX donates them to its jitted step):
the trainer makes each leaf of the ones it is given a leaf that requires
grad, sharing its storage, and returns them detached, so the result serves
as any parameter tree does (``ServingEngine(model, params)``).

With ``shard_ctx`` (JAX's ``train(..., shard_ctx=)``) it trains on the
context's mesh: the params (given, or drawn whole on the mesh's first
device) are split by ``sharding.partition.place_for_train``, the moments
likewise, each batch (its ``features`` too, with ``DataConfig(
feature_rows=)``) split over the ``batch`` axes, and the step is
``make_train_step(model, opt_cfg, shard_ctx)``. It returns the params as
Sharded leaves (``sharding.partition.gather_tree`` makes them whole);
checkpoints gather on save and re-place on restore.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.models.schema import tree_map
from repro_torch.sharding.partition import place_for_train, shard
from repro_torch.training.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.training.data import DataConfig, make_dataset
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.steps import make_train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    log_every: int = 10
    ckpt_every: int = 0  # 0 = no checkpointing
    ckpt_dir: str = "checkpoints"
    seed: int = 0


def train(model, data_cfg: DataConfig, train_cfg: TrainConfig,
          opt_cfg: Optional[AdamWConfig] = None, shard_ctx=None, params=None,
          log_fn=print):
    """Train ``model`` for ``train_cfg.steps`` steps on ``data_cfg``'s
    batches, from ``params`` (trained in place) or weights drawn from
    ``train_cfg.seed`` on the model's device; resume from the latest
    checkpoint when checkpointing. With ``shard_ctx`` the run is sharded
    over its mesh (see the module's docstring). Returns (params, detached;
    the AdamW state; the history, one record {"step", "loss", "grad_norm",
    "t"} at the first step and every ``log_every``-th)."""
    opt_cfg = opt_cfg or AdamWConfig(total_steps=train_cfg.steps)
    device = model.device if shard_ctx is None else shard_ctx.mesh.first_device
    if params is None:
        params = model.on(device).init(
            torch.Generator(device=device).manual_seed(train_cfg.seed))
    if shard_ctx is None:
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    else:
        params = place_for_train(model, shard_ctx, params)
    opt_state = adamw_init(params)
    start_step = 0
    if train_cfg.ckpt_every:
        ck = latest_checkpoint(train_cfg.ckpt_dir)
        if ck:
            params, opt_state, start_step = restore_checkpoint(ck, params,
                                                               opt_state)
            log_fn(f"restored {ck} at step {start_step}")

    step_fn = make_train_step(model, opt_cfg, shard_ctx)
    ds = make_dataset(data_cfg).batches()
    history = []
    t0 = time.perf_counter()
    for step in range(start_step, train_cfg.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(ds).items()}
        if shard_ctx is not None:
            batch = {k: shard(v, shard_ctx, "batch", None)
                     for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % train_cfg.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            dt = time.perf_counter() - t0
            history.append({"step": step + 1, "loss": loss, "grad_norm": gn,
                            "t": dt})
            log_fn(f"step {step+1:5d} loss {loss:.4f} |g| {gn:.3f} ({dt:.1f}s)")
        if train_cfg.ckpt_every and (step + 1) % train_cfg.ckpt_every == 0:
            save_checkpoint(train_cfg.ckpt_dir, step + 1, params, opt_state)
    detach = (lambda p: p.detach()) if shard_ctx is None else \
        (lambda p: p.map_parts(torch.Tensor.detach))
    return tree_map(detach, params), opt_state, history
