"""Checkpointing in the JAX package's file format: a flat-keyed npz of
(params, opt_state, step).

Keys are JAX's tree paths: ``params/decoder/g0/l0/attn/wq``, ...,
``opt/.step``, ``opt/.m/<the same path>``, ``opt/.v/<the same path>`` and
``step``. A scanned group's leaves carry its leading ``[count]`` layer axis
(:func:`repro_torch.models.convert.params_to_numpy` stacks the port's
per-layer lists back into it); bf16 is stored as fp32 (lossless). A file is
written to a temp file and renamed; the last ``keep`` are kept. A file
saved by either package restores in the other.

A sharded run's trees (``sharding.partition.Sharded`` leaves) are gathered
whole on the host to save, so the file is the same and an unsharded run
restores it; restoring into a sharded tree re-places each leaf by its
layout.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from repro_torch.models.convert import params_to_numpy
from repro_torch.sharding.partition import Sharded, gather_tree
from repro_torch.training.optimizer import AdamWState

_CKPT = re.compile(r"ckpt_\d+\.npz$")


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state: AdamWState,
                    keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    host = lambda t: params_to_numpy(gather_tree(t, "cpu"))  # noqa: E731
    flat = _flat(host(params), "params/")
    flat["opt/.step"] = np.asarray(opt_state.step, dtype=np.int32)
    flat.update(_flat(host(opt_state.m), "opt/.m/"))
    flat.update(_flat(host(opt_state.v), "opt/.v/"))
    flat["step"] = np.asarray(step)
    tmp = os.path.join(ckpt_dir, f".tmp_ckpt_{step}.npz")
    final = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, final)
    for old in sorted(f for f in os.listdir(ckpt_dir) if _CKPT.match(f))[:-keep]:
        os.remove(os.path.join(ckpt_dir, old))
    return final


def latest_checkpoint(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = sorted(f for f in os.listdir(ckpt_dir) if _CKPT.match(f))
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def _fill(tree, prefix, data, path="", index=None):
    """``tree``'s structure filled from ``data``'s ``prefix + path`` keys
    (shape- and structure-checked), each leaf in its own dtype and on its
    device."""
    if isinstance(tree, dict):
        return {k: _fill(v, prefix, data, f"{path}/{k}" if path else k, index)
                for k, v in tree.items()}
    if isinstance(tree, list):  # a group's superblocks
        if path.split("/")[0] != "encoder" and len(tree) == 1:
            return [_fill(tree[0], prefix, data, path)]
        return [_fill(b, prefix, data, path, (i, len(tree)))
                for i, b in enumerate(tree)]
    key = prefix + path
    arr = data[key]
    if index is not None:
        i, n = index
        if arr.shape[:1] != (n,):
            raise ValueError(f"{key}: {arr.shape[:1]} layers stored, {n} held")
        arr = arr[i]
    if arr.shape != tuple(tree.shape):
        raise ValueError(f"{key}: stored {arr.shape}, held {tuple(tree.shape)}")
    if isinstance(tree, Sharded):
        whole = torch.as_tensor(arr).to(dtype=tree.dtype)
        return Sharded.split(whole, tree.mesh, tree.spec).map_parts(
            lambda t: t.contiguous())
    return torch.as_tensor(arr).to(dtype=tree.dtype, device=tree.device)


def restore_checkpoint(path: str, params_like, opt_like: AdamWState):
    """Restore into the given structures (shape checked). Returns (params,
    opt_state, step)."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}  # each array read once
    params = _fill(params_like, "params/", data)
    opt = AdamWState(step=int(data["opt/.step"]),
                     m=_fill(opt_like.m, "opt/.m/", data),
                     v=_fill(opt_like.v, "opt/.v/", data))
    return params, opt, int(data["step"])
