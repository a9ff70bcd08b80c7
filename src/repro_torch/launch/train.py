"""Training launcher of the port, after the JAX package's ``launch/train.py``.

Runs on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --reduced --device cpu --steps 3

``--reduced`` takes the config's CPU-test variant at ``--batch`` x
``--seq`` (8 x 128 by default). Without it the launcher follows the JAX
one's full-config branch: a ``('data', 'model')`` mesh over the visible
cards, ``data`` the card count and ``model`` 1 (``launch.mesh.
make_train_mesh``), a context from ``make_ctx(cfg, mesh, shape)`` -- FSDP
over ``data``, every leaf split over its ``embed`` dim -- and training
under it (``training.train(..., shard_ctx=)``). It works out the
training state first, 12 bytes a parameter (the bf16 weight and gradient,
the fp32 m and v), and ``check_fits`` raises ValueError with both numbers
when the largest device's share exceeds a card's memory. It never shrinks
the model on its own: ``--layers N`` trains the stack's first N layers at
full width, and ``--batch`` / ``--seq`` replace the shape's global batch
(256 x 4096 for train_4k, far past a card's activations). On one card the
run is the unsharded step, as the mesh is 1 x 1; on several, the sharded
step, which takes every decoder-only stack: attention (GQA or MLA, dense or
MoE), Mamba-2 (mamba2-130m) and the hybrid (jamba-v0.1-52b). The batches
are ``SyntheticLM``'s tokens, which carry no feature rows (nor do the JAX
trainer's): pixtral-12b trains on its text alone, as JAX's launcher trains
it, and an encoder-decoder (seamless-m4t-large-v2), whose encoder needs
features, is refused with ValueError -- train it through
``training.train`` with ``DataConfig(feature_rows=F)``.

On one 80 GB card, at full depth: mamba2-130m (1.5 GB of state),
seamless-m4t-large-v2 (21 GB; through ``training.train``, as above) and
starcoder2-3b (50 GB). Every other
configuration is refused there at full depth -- llama3-8b 90 GB,
pixtral-12b 139 GB, qwen3-32b 384 GB, granite-34b 563 GB, jamba-v0.1-52b
614 GB, deepseek-v2-236b 2.8 TB, grok-1-314b 3.8 TB -- and trains only cut
with ``--layers`` (jamba's first 2 layers: 42 GB; deepseek-v2's first:
10 GB; llama3-8b's first 8: 27 GB), or on several cards: llama3-8b's
90.1 GB is 22.5 GB a card on four. E.g.:

  python -m repro_torch.launch.train --arch mamba2-130m --batch 8 \
      --seq 4096 --steps 10
  python -m repro_torch.launch.train --arch deepseek-v2-236b --layers 1 \
      --batch 2 --seq 4096 --steps 10
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.launch.mesh import DeviceMesh, make_train_mesh
from repro_torch.models import Model
from repro_torch.models.schema import tree_leaves
from repro_torch.sharding.partition import (
    axes_of,
    make_ctx,
    shard_index,
    spec_bytes_per_device,
)
from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, train

STATE_BYTES_PER_PARAM = 12  # bf16 weight + bf16 gradient + fp32 m + fp32 v


def param_count(model) -> int:
    """The parameters the port allocates (the padded vocabulary included)."""
    return sum(math.prod(s.shape) for s in tree_leaves(model.schema()))


def state_share(model, ctx=None) -> int:
    """Bytes of training state (:data:`STATE_BYTES_PER_PARAM` a parameter)
    the largest device holds: all of it without ``ctx``; under ``ctx``,
    each leaf's blocks by its ``param_pspecs`` spec (a device counts each
    distinct block it holds once, and a mesh naming a device in several
    slots gives it every one of their blocks; a ``LogicalMesh`` has a
    device a slot)."""
    if ctx is None:
        return STATE_BYTES_PER_PARAM * param_count(model)
    mesh = ctx.mesh
    schema = tree_leaves(model.schema())
    specs = tree_leaves(model.param_pspecs(ctx.rules))
    if not isinstance(mesh, DeviceMesh):
        return sum(spec_bytes_per_device(s.shape, STATE_BYTES_PER_PARAM, p,
                                         mesh.shape)
                   for s, p in zip(schema, specs))
    shares = {}
    for s, p in zip(schema, specs):
        per_block = spec_bytes_per_device(s.shape, STATE_BYTES_PER_PARAM, p,
                                          mesh.shape)
        held = {}
        for c in mesh.coords():
            block = tuple(shard_index(mesh, c, axes_of(q)) for q in p)
            held.setdefault(mesh.device_at(c), set()).add(block)
        for dev, blocks in held.items():
            shares[dev] = shares.get(dev, 0) + per_block * len(blocks)
    return max(shares.values())


def check_fits(model, ctx=None, capacity=None) -> int:
    """Raise ValueError when the largest device's share of the training
    state (:func:`state_share`) exceeds ``capacity`` bytes (default: the
    smallest card's memory, which needs the model, or ``ctx``'s mesh, on
    the card); returns the share."""
    need = state_share(model, ctx)
    if capacity is None:
        devs = ([model.device] if ctx is None
                else sorted(set(ctx.mesh.device_list), key=str))
        if any(d.type != "cuda" for d in devs):
            raise ValueError("the full configuration trains on the card; "
                             "pass --reduced to train on the CPU")
        capacity = min(torch.cuda.get_device_properties(d).total_memory
                       for d in devs)
    if need > capacity:
        where = ("" if ctx is None else
                 f" on a {' x '.join(map(str, ctx.mesh.sizes))} "
                 f"{'/'.join(ctx.mesh.axis_names)} mesh")
        raise ValueError(
            f"{model.cfg.name}: the largest device's share of the training "
            f"state{where} is {need / 1e9:.1f} GB ({STATE_BYTES_PER_PARAM} "
            f"bytes a parameter, {STATE_BYTES_PER_PARAM * param_count(model) / 1e9:.1f} "
            f"GB in all) and a card holds {capacity / 1e9:.1f} GB; training "
            "it needs the sharding of more cards")
    return need


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's CPU-test variant at --batch x --seq")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--layers", type=int, default=0,
                    help="train the stack's first N layers (0: all of them)")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch rows (default 8 with --reduced, else the "
                    "shape's global batch)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default 128 with --reduced, else "
                    "the shape's)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots", "none"])
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.is_encdec:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: its encoder needs feature "
            "rows, which the launcher's synthetic token batches do not carry "
            "(nor do the JAX trainer's); train it through training.train "
            "with DataConfig(feature_rows=F)")
    model = Model(cfg, device=args.device, remat=True,
                  remat_policy=args.remat_policy)
    shard_ctx = None
    if args.reduced:
        batch, seq = args.batch or 8, args.seq or 128
        where = str(model.device)
    else:
        shape = get_shape(args.shape)
        batch = args.batch or shape.global_batch
        seq = args.seq or shape.seq_len
        mesh = make_train_mesh(device=args.device)
        ctx = make_ctx(cfg, mesh, dataclasses.replace(
            shape, global_batch=batch, seq_len=seq))
        share = check_fits(model, ctx)
        if mesh.size > 1:
            shard_ctx = ctx
        where = (f"a {' x '.join(map(str, mesh.sizes))} (data, model) mesh, "
                 f"{share / 1e9:.1f} GB of state on the largest device")
    print(f"training {cfg.name}: {param_count(model) / 1e6:.1f}M params, "
          f"batch={batch} seq={seq} on {where}")
    return train(
        model,
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch),
        TrainConfig(steps=args.steps, log_every=max(args.steps // 10, 1),
                    ckpt_every=args.steps // 2 if args.ckpt_dir else 0,
                    ckpt_dir=args.ckpt_dir or "checkpoints"),
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                    total_steps=args.steps),
        shard_ctx=shard_ctx,
    )

if __name__ == "__main__":
    main()
