"""Models of the port: attention stacks (dense or MoE, with or without a
feature frontend) and Mamba-2 (SSM) stacks."""

from repro_torch.models.model import FRONTEND_DIM, Model

__all__ = ["FRONTEND_DIM", "Model"]
