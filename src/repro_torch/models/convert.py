"""Carry the JAX package's weights across to the port, bit for bit.

The JAX param tree, given as nested dicts of numpy arrays, uses the dotted
names the port keeps (``embed``, ``final_norm``, ``decoder.g0.l0.ln1``,
``decoder.g0.l0.attn.wq``, ..., ``decoder.g0.l0.ffn.w_down``); a scanned
group's leaves carry a leading ``[count]`` layer axis, which is split into
the port's per-superblock list. bf16 arrays reach numpy as the
``ml_dtypes`` ``bfloat16`` dtype, which ``torch.from_numpy`` rejects: they
cross as their 16-bit patterns and are viewed back as ``torch.bfloat16``.
This module imports neither JAX nor ``ml_dtypes``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import layer_groups


def tensor_from_numpy(a) -> torch.Tensor:
    """numpy array -> CPU tensor with the same bits (bfloat16 included),
    on a writable copy (arrays handed over by JAX are read-only)."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    t = tensor_from_numpy(tree)
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_numpy(tree, cfg, *, device, dtype=None) -> dict:
    """The port's parameter tree from a JAX-layout tree of numpy arrays.

    ``dtype`` None keeps each array's own dtype.
    """
    out = {k: _convert(v, device, dtype) for k, v in tree.items()
           if k != "decoder"}
    decoder = {}
    for gi, g in enumerate(layer_groups(cfg)):
        block = _convert(tree["decoder"][f"g{gi}"], device, dtype)
        if g.count == 1:
            decoder[f"g{gi}"] = [block]
        else:
            decoder[f"g{gi}"] = [_index(block, i) for i in range(g.count)]
    out["decoder"] = decoder
    return out


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i].contiguous()
