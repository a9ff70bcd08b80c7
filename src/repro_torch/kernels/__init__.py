"""Kernels of the port: hand-written Hopper kernels, their plain PyTorch
versions, and the dispatching wrappers in :mod:`repro_torch.kernels.ops`."""
