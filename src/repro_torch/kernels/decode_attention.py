"""Launcher of the hand-written ring decode-attention kernel
(``csrc/decode_attention.cu``, CUDA C++ for sm_90a, bound through ctypes).

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py::
decode_attention_bhgd``. The kernel is ``csrc/decode_split.cuh``'s split-KV
template, shared with the paged kernel, which states the design and what
bounds it on the card; :func:`repro_torch.kernels.ops.decode_attention` is
the public entry point that checks arguments, counts launches and picks this
launcher for CUDA tensors.

The launcher owns the split count: :func:`num_splits` picks how many CTAs
(one thread-block cluster) share a row's keys, from the row length and the
card's SM count, and :func:`splits_for` caches that plan per shape and
device, so a call does no planning. The paged launcher takes the same plan
for the same row length, so on the same K/V values the two kernels give the
same bits. No caller sees a split; ``launch(..., _splits=n)`` forces n CTAs
a row (1: one CTA a row) for the kernel-level tests and comparisons.

Grid: (splits * Hkv, B, ceil(G / 16)), clusters of (splits, 1, 1): a KV
head with more than 16 query heads runs its heads 16 at a time over grid z.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_FWD = build.CFunction("decode_attention", "decode_attention_fwd",
                       [_P] * 5 + [_I] * 5 + [_P] + [_L] * 8
                       + [_I, ctypes.c_float, _I, _I])

HEAD_DIMS = (32, 64, 128)
GROUP_HEADS = 16  # query heads one CTA holds; more run over grid z
TILE_K = 32  # keys a warp scores at a time
WARPS = 4  # warps a CTA
MAX_SPLITS = 8  # CTAs a row: Hopper's portable cluster size


def num_splits(W: int, rows: int, n_sm: int) -> int:
    """CTAs per row (of B * Hkv rows): a power of two, doubled from 1 while
    the grid is short of two CTAs per SM, up to MAX_SPLITS and to one tile
    a warp per CTA at the longest row W."""
    cap = min(MAX_SPLITS, max(1, -(-W // (WARPS * TILE_K))))
    s = 1
    while 2 * s <= cap and rows * s < 2 * n_sm:
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def splits_for(W: int, rows: int, device_index: int) -> int:
    """num_splits for the card ``device_index``, asked once per shape."""
    n_sm = torch.cuda.get_device_properties(device_index).multi_processor_count
    return num_splits(W, rows, n_sm)


def launch(q, k, v, lengths, *, scale: float, w_real: int, lse=None,
           _splits=None):
    """q: [B,1,H,hd], k/v: [B,W,Hkv,hd], lengths: int32 [B] contiguous, all
    on one CUDA device (checked by the caller). Returns a new [B,1,H,hd];
    with ``lse`` (contiguous fp32 [B,H] there) the kernel also writes each
    row's log-sum-exp of its scaled scores into it (-inf where no slot is
    valid). ``_splits`` forces the CTAs a row; by default
    :func:`splits_for` picks it."""
    B, _, H, hd = q.shape
    _, W, Hkv, _ = k.shape
    dev = q.get_device()
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    sq, sk, sv = q.stride(), k.stride(), v.stride()
    _FWD(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
         lengths.data_ptr(), B, W, H, Hkv, hd,
         None if lse is None else lse.data_ptr(), sq[0], sq[2],
         sk[0], sk[1], sk[2], sv[0], sv[1], sv[2], w_real, scale,
         q.dtype is torch.bfloat16, _splits or splits_for(W, B * Hkv, dev))
    return o
