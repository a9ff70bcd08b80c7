"""Training launcher of the port, after the JAX package's ``launch/train.py``.

Runs on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --reduced --device cpu --steps 3

``--reduced`` takes the config's CPU-test variant at ``--batch`` x
``--seq`` (8 x 128 by default). Without it the JAX launcher builds its
production mesh and trains ``--shape``'s global batch; the port has one
card and no sharding, so it works out the training state first -- 12
bytes a parameter: the bf16 weight and gradient, the fp32 m and v -- and
``check_fits`` raises ValueError with both numbers when that exceeds the
card's memory. It never shrinks the model on its own: ``--layers N``
trains the stack's first N layers at full width, and ``--batch`` /
``--seq`` replace the shape's global batch (256 x 4096 for train_4k, far
past one card's activations).

On one 80 GB card, at full depth: mamba2-130m (1.5 GB of state),
seamless-m4t-large-v2 (21 GB) and starcoder2-3b (50 GB). Every other
configuration is refused at full depth -- llama3-8b 90 GB, pixtral-12b
139 GB, qwen3-32b 384 GB, granite-34b 563 GB, jamba-v0.1-52b 614 GB,
deepseek-v2-236b 2.8 TB, grok-1-314b 3.8 TB -- and trains only cut with
``--layers`` (jamba's first 2 layers: 42 GB; deepseek-v2's first: 10 GB;
llama3-8b's first 8: 27 GB), e.g.:

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
from repro_torch.models import Model
from repro_torch.models.schema import tree_leaves
from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, train

STATE_BYTES_PER_PARAM = 12  # bf16 weight + bf16 gradient + fp32 m + fp32 v


def param_count(model) -> int:
    """The parameters the port allocates (the padded vocabulary included)."""
    return sum(math.prod(s.shape) for s in tree_leaves(model.schema()))


def check_fits(model) -> int:
    """Raise ValueError when the training state does not fit the card's
    memory; returns the state's bytes."""
    need = STATE_BYTES_PER_PARAM * param_count(model)
    if model.device.type != "cuda":
        raise ValueError("the full configuration trains on the card; pass "
                         "--reduced to train on the CPU")
    have = torch.cuda.get_device_properties(model.device).total_memory
    if need > have:
        raise ValueError(
            f"{model.cfg.name}: the training state takes {need / 1e9:.1f} GB "
            f"({STATE_BYTES_PER_PARAM} bytes a parameter) and the card holds "
            f"{have / 1e9:.1f} GB; training it needs the sharding of several "
            "cards")
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
    model = Model(cfg, device=args.device, remat=True,
                  remat_policy=args.remat_policy)
    if args.reduced:
        batch, seq = args.batch or 8, args.seq or 128
    else:
        check_fits(model)
        shape = get_shape(args.shape)
        batch = args.batch or shape.global_batch
        seq = args.seq or shape.seq_len
    print(f"training {cfg.name}: {param_count(model) / 1e6:.1f}M params, "
          f"batch={batch} seq={seq} on {model.device}")
    return train(
        model,
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch),
        TrainConfig(steps=args.steps, log_every=max(args.steps // 10, 1),
                    ckpt_every=args.steps // 2 if args.ckpt_dir else 0,
                    ckpt_dir=args.ckpt_dir or "checkpoints"),
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                    total_steps=args.steps),
    )


if __name__ == "__main__":
    main()
