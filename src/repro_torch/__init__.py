"""PyTorch/CUDA port of the JAX serving system in ``repro``.

The port runs on an NVIDIA H100 by default and on the CPU only when the
caller asks for it (``device="cpu"``), where every kernel takes its plain
PyTorch version. It imports nothing of JAX or of the ``repro`` package.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device to run on; raises if CUDA is asked for and absent
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
