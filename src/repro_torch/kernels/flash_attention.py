"""Launcher of the hand-written prefill flash-attention kernel
(``csrc/flash_attention.cu``, CUDA C++ for sm_90a, bound through ctypes).

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention_bhsd``, and also takes the prior KV of suffix prefill. The
source file states the design and what bounds it on the card;
:func:`repro_torch.kernels.ops.flash_attention` is the public entry point
that checks arguments, counts launches and picks this launcher for CUDA
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_FWD = build.CFunction("flash_attention", "flash_attention_fwd",
                       [_P] * 10 + [_I] * 7 + [_L] * 15 + [_I] * 4
                       + [ctypes.c_float, _I])

HEAD_DIMS = (32, 64, 128)


def launch(q, k, v, *, causal: bool, window: int, scale: float,
           segment_ids, sq_real: int, skv_real: int, segment_starts=None,
           prior_k=None, prior_v=None, prior_valid=None):
    """q: [B,Sq,H,hd], k/v: [B,Skv,Hkv,hd] (and prior_k/prior_v
    [B,Pp,Hkv,hd], prior_valid int32 [B]; segment_starts int32 [B,Sq]
    beside segment_ids) on one CUDA device, last dim contiguous (checked by
    the caller). Returns a new [B,Sq,H,hd] tensor."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    seg_ptr = None if seg is None else seg.data_ptr()
    start_ptr = None if segment_starts is None else segment_starts.data_ptr()
    if prior_k is None:  # no prior: the kernel reads none of it
        prior_k, prior_v, pv_ptr, Pp = k, v, None, 0
    else:
        pv_ptr, Pp = prior_valid.data_ptr(), prior_k.shape[1]
    _FWD(
        q.get_device(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), seg_ptr, seg_ptr,
        start_ptr, prior_k.data_ptr(), prior_v.data_ptr(), pv_ptr,
        B, Sq, Skv, Pp, H, Hkv, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        prior_k.stride(0), prior_k.stride(1), prior_k.stride(2),
        prior_v.stride(0), prior_v.stride(1), prior_v.stride(2),
        int(causal), int(window), int(sq_real), int(skv_real), float(scale),
        int(q.dtype == torch.bfloat16),
    )
    return o
