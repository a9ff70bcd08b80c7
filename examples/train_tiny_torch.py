"""Train a ~small LM for a few hundred steps on the PyTorch port (full
substrate demo: data pipeline -> AdamW -> checkpointing -> restore).

On the card (the default) the gradients flow through the hand-written
backward kernels; ``--device cpu`` runs their plain PyTorch versions. The
card's bf16 SSD kernels take a head dim of 64, so there an SSM stack's
reduced config (head dim 32, a CPU-test size) trains at 64.

Run: PYTHONPATH=src python examples/train_tiny_torch.py [--steps 200] [--arch mamba2-130m] [--device cuda]
"""

import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import BF16_HEAD_DIMS
from repro_torch.models import Model
from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    if (args.device == "cuda" and cfg.ssm is not None
            and cfg.ssm.head_dim not in BF16_HEAD_DIMS):
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, head_dim=BF16_HEAD_DIMS[0]))
        print(f"{cfg.name}: SSM head dim {cfg.ssm.head_dim}, the card's bf16 "
              f"SSD kernels' ({cfg.ssm.n_heads(cfg.d_model)} heads)")
    model = Model(cfg, device=args.device, remat=True)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        params, opt, hist = train(
            model,
            DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       batch_size=args.batch, seed=0),
            TrainConfig(steps=args.steps, log_every=20,
                        ckpt_every=max(args.steps // 2, 1), ckpt_dir=ckpt_dir),
            AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
        )
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'LEARNING' if last < first - 0.1 else 'check hyperparameters'})")


if __name__ == "__main__":
    main()
