"""Launchers of the hand-written absorbed-MLA decode kernel
(``csrc/mla_decode_attention.cu``, CUDA C++ for sm_90a, bound through
ctypes), ring and paged.

No Pallas kernel stands behind it: the JAX package computes MLA's decode
(``src/repro/models/mla.py::mla_decode_update``'s ``attend``) in jnp. The
source file states the design and what bounds it on the card;
:func:`repro_torch.kernels.ops.mla_decode_attention` and
:func:`~repro_torch.kernels.ops.paged_mla_decode_attention` are the public
entry points that check arguments, count launches and pick these launchers
for CUDA tensors.

The launcher owns the split count, as the GQA decode launchers do:
:func:`num_splits` picks how many CTAs (one thread-block cluster) share a
(row, head block)'s latent rows, from the row width and the SM count, and
:func:`splits_for` caches it per shape and device. Ring and paged take the
same plan for the same width. ``_splits=n`` forces n CTAs for kernel-level
comparisons.

Grid: (splits, H / 16, B), clusters of (splits, 1, 1).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_RING = build.CFunction("mla_decode_attention", "mla_decode_attention_fwd",
                        [_P] * 6 + [_I] * 5 + [_L] * 8 + [_F, _I, _I])
_PAGED = build.CFunction("mla_decode_attention",
                         "paged_mla_decode_attention_fwd",
                         [_P] * 7 + [_I] * 6 + [_L] * 8 + [_F, _I, _I])

LATENT_DIMS = ((512, 64),)  # (kv_lora_rank, qk_rope_dim) the kernel takes
HEAD_BLOCK = 16  # query heads a CTA; H must be a multiple
TILE = 32  # latent rows a tile
MAX_SPLITS = 8  # CTAs a (row, head block): the portable cluster size


def num_splits(W: int, rows: int, n_sm: int) -> int:
    """CTAs per (row, head block) (``rows`` of them): a power of two,
    doubled from 1 while the grid is short of two CTAs per SM, up to
    MAX_SPLITS and to one tile a CTA at the widest row W."""
    cap = min(MAX_SPLITS, max(1, -(-W // TILE)))
    s = 1
    while 2 * s <= cap and rows * s < 2 * n_sm:
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def splits_for(W: int, rows: int, device_index: int) -> int:
    """num_splits for the card ``device_index``, asked once per shape."""
    n_sm = torch.cuda.get_device_properties(device_index).multi_processor_count
    return num_splits(W, rows, n_sm)


def launch(q_lat, q_rope, ckv, krope, valid_len, *, scale: float,
           _splits=None):
    """q_lat [B,1,H,r], q_rope [B,1,H,dr], ckv [B,W,r], krope [B,W,dr],
    valid_len int32 [B] contiguous, on one CUDA device (checked by the
    caller). Returns a new [B,1,H,r]."""
    B, _, H, r = q_lat.shape
    W, dr = ckv.shape[1], krope.shape[2]
    dev = q_lat.get_device()
    o = torch.empty(q_lat.shape, dtype=q_lat.dtype, device=q_lat.device)
    sl, sr = q_lat.stride(), q_rope.stride()
    _RING(dev, q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
          krope.data_ptr(), o.data_ptr(), valid_len.data_ptr(), B, W, H, r,
          dr, sl[0], sl[2], sr[0], sr[2], ckv.stride(0), ckv.stride(1),
          krope.stride(0), krope.stride(1), scale,
          q_lat.dtype is torch.bfloat16,
          _splits or splits_for(W, B * H // HEAD_BLOCK, dev))
    return o


def launch_paged(q_lat, q_rope, ckv_blocks, krope_blocks, page_table,
                 valid_len, *, scale: float, _splits=None):
    """As :func:`launch`, the latent pool ckv_blocks [N,page,r] and
    krope_blocks [N,page,dr] read through page_table int32 [B,n_pages]."""
    B, _, H, r = q_lat.shape
    n_pages = page_table.shape[1]
    page, dr = ckv_blocks.shape[1], krope_blocks.shape[2]
    dev = q_lat.get_device()
    o = torch.empty(q_lat.shape, dtype=q_lat.dtype, device=q_lat.device)
    sl, sr = q_lat.stride(), q_rope.stride()
    W = n_pages * page
    _PAGED(dev, q_lat.data_ptr(), q_rope.data_ptr(), ckv_blocks.data_ptr(),
           krope_blocks.data_ptr(), o.data_ptr(), page_table.data_ptr(),
           valid_len.data_ptr(), B, n_pages, page, H, r, dr, sl[0], sl[2],
           sr[0], sr[2], ckv_blocks.stride(0), ckv_blocks.stride(1),
           krope_blocks.stride(0), krope_blocks.stride(1), scale,
           q_lat.dtype is torch.bfloat16,
           _splits or splits_for(W, B * H // HEAD_BLOCK, dev))
    return o
