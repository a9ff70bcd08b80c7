"""Training of the port, after the JAX package's ``training``: the data
pipeline, AdamW, the step functions, checkpoints in JAX's file format and
the training loop. On the card gradients flow through the hand-written
backward kernels of flash attention and rmsnorm."""

from repro_torch.training.data import DataConfig, make_dataset
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update
from repro_torch.training.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.training.trainer import TrainConfig, train

__all__ = ["DataConfig", "make_dataset", "AdamWConfig", "AdamWState",
           "adamw_init", "adamw_update", "make_train_step", "make_prefill_step",
           "make_serve_step", "TrainConfig", "train"]
