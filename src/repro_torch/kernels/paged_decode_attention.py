"""Launcher of the hand-written paged decode-attention kernel
(``csrc/paged_decode_attention.cu``, CUDA C++ for sm_90a, bound through
ctypes).

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py::
paged_decode_attention_bhgd``. The kernel is the ring kernel's split-KV
template (``csrc/decode_split.cuh``) with a page-table row resolver, which
states the design and what bounds it on the card;
:func:`repro_torch.kernels.ops.paged_decode_attention` is the public entry
point that checks arguments, counts launches and picks this launcher for
CUDA tensors.

Its split count is the ring launcher's for a row of ``n_pages * page``
positions: ``num_splits(n_pages * page, B * Hkv, n_sm)``
(:func:`repro_torch.kernels.decode_attention.splits_for`), so with the same
K/V values, in a ring of W = n_pages * page slots, the two kernels sum in
the same order and give the same bits. Grid: (splits * Hkv, B, ceil(G /
16)), clusters of (splits, 1, 1).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import splits_for

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_FWD = build.CFunction("paged_decode_attention", "paged_decode_attention_fwd",
                       [_P] * 6 + [_I] * 6 + [_L] * 8
                       + [ctypes.c_float, _I, _I])

HEAD_DIMS = (32, 64, 128)


def launch(q, k_blocks, v_blocks, page_table, lengths, *, scale: float,
           _splits=None):
    """q: [B,1,H,hd], k/v blocks: [N,page,Hkv,hd], page_table: int32
    [B,n_pages] and lengths: int32 [B], both contiguous, all on one CUDA
    device (checked by the caller). Returns a new [B,1,H,hd]. ``_splits``
    forces the CTAs a row, as the ring launcher's."""
    B, _, H, hd = q.shape
    _, page, Hkv, _ = k_blocks.shape
    n_pages = page_table.shape[1]
    dev = q.get_device()
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    sq, sk, sv = q.stride(), k_blocks.stride(), v_blocks.stride()
    _FWD(dev, q.data_ptr(), k_blocks.data_ptr(), v_blocks.data_ptr(),
         o.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
         B, n_pages, page, H, Hkv, hd, sq[0], sq[2],
         sk[0], sk[1], sk[2], sv[0], sv[1], sv[2], scale,
         q.dtype is torch.bfloat16,
         _splits or splits_for(n_pages * page, B * Hkv, dev))
    return o
