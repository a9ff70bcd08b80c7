"""Launcher of the hand-written prefill flash-attention kernel
(``csrc/flash_attention.cu``, CUDA C++ for sm_90a, bound through ctypes).

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention_bhsd``. The source file states the design and what bounds it
on the card; :func:`repro_torch.kernels.ops.flash_attention` is the public
entry point that checks arguments, counts launches and picks this launcher
for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _P] + [_I] * 6 + [_L] * 9 + [_I] * 4 + [
    ctypes.c_float, _I, _P]

HEAD_DIMS = (32, 64, 128)


def _fn():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def launch(q, k, v, *, causal: bool, window: int, scale: float,
           segment_ids, sq_real: int, skv_real: int):
    """q: [B,Sq,H,hd], k/v: [B,Skv,Hkv,hd] on one CUDA device, last dim
    contiguous (checked by the caller). Returns a new [B,Sq,H,hd] tensor."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    seg_ptr = None if seg is None else seg.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), seg_ptr, seg_ptr,
        B, Sq, Skv, H, Hkv, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), int(window), int(sq_real), int(skv_real), float(scale),
        int(q.dtype == torch.bfloat16), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    return o
