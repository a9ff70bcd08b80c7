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

Two bodies. bf16 runs both products on the tensor cores (``wgmma``): a CTA
is 64 query heads of one batch row against 64-row latent tiles brought in
by TMA (``cp.async`` for a pool page no TMA box fits), one warpgroup
scoring and both summing the values, 225.8 KiB of shared memory, one CTA
an SM; at about 240 FLOP a byte the work sits near the bf16 ridge, so the
latency of a CTA's few tiles and of the cluster merge bound it, not the
card's bytes. fp32 runs on the CUDA cores, a CTA 16 heads against 32-row
tiles. H must be a multiple of 16 for both; a bf16 head block past H is
zero-filled and never written.

The launcher owns the split count, as the GQA decode launchers do:
:func:`num_splits` picks how many CTAs (one thread-block cluster) share a
(row, head block)'s latent rows, from the row width, the number of
(row, head block)s and the SM count, and :func:`splits_for` caches it per
shape and device. Each CTA then takes its share of the row's whole tiles on
the card, from the row's valid length (:func:`tile_shares` states the rule
the kernel applies), so no length is read on the host. Ring and paged take
the same plan for the same width. ``_splits=n`` forces n CTAs, for
kernel-level comparisons.

Grid: (splits, head_blocks(H, dtype), B), clusters of (splits, 1, 1).
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
                        [_P] * 7 + [_I] * 5 + [_L] * 8 + [_F, _I, _I])
_PAGED = build.CFunction("mla_decode_attention",
                         "paged_mla_decode_attention_fwd",
                         [_P] * 7 + [_I] * 7 + [_L] * 8 + [_F, _I, _I])
_CLUSTERS = build.CFunction("mla_decode_attention",
                            "mla_decode_attention_clusters",
                            [_I, ctypes.POINTER(_I)])

LATENT_DIMS = ((512, 64),)  # (kv_lora_rank, qk_rope_dim) the kernel takes
HEAD_BLOCK = 16  # H must be a multiple; the fp32 body's heads a CTA
WG_HEADS = 64  # the bf16 body's heads a CTA: wgmma's M
TILE = 32  # latent rows a tile, fp32
WG_TILE = 64  # latent rows a tile, bf16
MAX_SPLITS = 8  # CTAs a (row, head block): the portable cluster size


def head_blocks(H: int, bf16: bool) -> int:
    """(row, head block)s a batch row: grid y."""
    block = WG_HEADS if bf16 else HEAD_BLOCK
    return -(-H // block)


def num_splits(W: int, rows: int, n_sm: int, bf16: bool = False) -> int:
    """CTAs per (row, head block) (``rows`` of them): a power of two up to
    MAX_SPLITS and to one tile a CTA at the widest row W. bf16 (one CTA an
    SM): doubled from 1 while the grid stays within one CTA an SM. fp32:
    doubled while the grid is short of two CTAs an SM."""
    cap = min(MAX_SPLITS, max(1, -(-W // (WG_TILE if bf16 else TILE))))
    s = 1
    while 2 * s <= cap and (rows * 2 * s <= n_sm if bf16
                            else rows * s < 2 * n_sm):
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def splits_for(W: int, rows: int, device_index: int, bf16: bool = False) -> int:
    """num_splits for the card ``device_index``, asked once per shape."""
    n_sm = torch.cuda.get_device_properties(device_index).multi_processor_count
    return num_splits(W, rows, n_sm, bf16)


def plan(W: int, B: int, H: int, bf16: bool, device_index: int) -> int:
    """The split count a launch at this shape takes."""
    return splits_for(W, B * head_blocks(H, bf16), device_index, bf16)


def tile_shares(valid_len: int, limit: int, splits: int,
                tile: int) -> list[tuple[int, int]]:
    """The tiles [begin, end) that CTA r of a (row, head block)'s ``splits``
    sweeps, as the kernel derives them on the card from the row's valid
    length: ceil(tiles / splits) whole tiles a CTA, in order, so an empty
    share only trails."""
    n_tiles = -(-max(0, min(valid_len, limit)) // tile)
    per = -(-n_tiles // splits)
    return [(min(r * per, n_tiles), min(r * per + per, n_tiles))
            for r in range(splits)]


def max_active_clusters(splits: int, *, device_index: int = 0) -> int:
    """cudaOccupancyMaxActiveClusters of the bf16 body at ``splits`` CTAs a
    cluster."""
    n = _I(0)
    _CLUSTERS(device_index, splits, ctypes.byref(n))
    return n.value


def launch(q_lat, q_rope, ckv, krope, valid_len, *, scale: float, lse=None,
           _splits=None):
    """q_lat [B,1,H,r], q_rope [B,1,H,dr], ckv [B,W,r], krope [B,W,dr],
    valid_len int32 [B] contiguous, on one CUDA device (checked by the
    caller). Returns a new [B,1,H,r]; with ``lse`` (contiguous fp32 [B,H]
    there) the kernel also writes each (row, head)'s log-sum-exp of its
    scaled scores into it (-inf where no slot is valid)."""
    B, _, H, r = q_lat.shape
    W, dr = ckv.shape[1], krope.shape[2]
    dev = q_lat.get_device()
    bf16 = q_lat.dtype is torch.bfloat16
    o = torch.empty(q_lat.shape, dtype=q_lat.dtype, device=q_lat.device)
    sl, sr = q_lat.stride(), q_rope.stride()
    _RING(dev, q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
          krope.data_ptr(), o.data_ptr(),
          None if lse is None else lse.data_ptr(), valid_len.data_ptr(), B, W,
          H, r, dr, sl[0], sl[2], sr[0], sr[2], ckv.stride(0), ckv.stride(1),
          krope.stride(0), krope.stride(1), scale, bf16,
          _splits or plan(W, B, H, bf16, dev))
    return o


def launch_paged(q_lat, q_rope, ckv_blocks, krope_blocks, page_table,
                 valid_len, *, scale: float, _splits=None):
    """As :func:`launch`, the latent pool ckv_blocks [N,page,r] and
    krope_blocks [N,page,dr] read through page_table int32 [B,n_pages]."""
    B, _, H, r = q_lat.shape
    n_pages = page_table.shape[1]
    page, dr = ckv_blocks.shape[1], krope_blocks.shape[2]
    dev = q_lat.get_device()
    bf16 = q_lat.dtype is torch.bfloat16
    o = torch.empty(q_lat.shape, dtype=q_lat.dtype, device=q_lat.device)
    sl, sr = q_lat.stride(), q_rope.stride()
    W = n_pages * page
    _PAGED(dev, q_lat.data_ptr(), q_rope.data_ptr(), ckv_blocks.data_ptr(),
           krope_blocks.data_ptr(), o.data_ptr(), page_table.data_ptr(),
           valid_len.data_ptr(), B, ckv_blocks.shape[0], n_pages, page, H, r,
           dr, sl[0], sl[2], sr[0], sr[2], ckv_blocks.stride(0),
           ckv_blocks.stride(1), krope_blocks.stride(0),
           krope_blocks.stride(1), scale, bf16,
           _splits or plan(W, B, H, bf16, dev))
    return o
