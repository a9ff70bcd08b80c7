"""Launcher of the hand-written ring decode-attention kernel
(``csrc/decode_attention.cu``, CUDA C++ for sm_90a, bound through ctypes).

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py::
decode_attention_bhgd``. The source file states the design and what bounds
it on the card; :func:`repro_torch.kernels.ops.decode_attention` is the
public entry point that checks arguments, counts launches and picks this
launcher for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P] + [_I] * 5 + [_L] * 8 + [_I, ctypes.c_float,
                                                         _I, _P]

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16  # query heads per KV head one CTA holds


def _fn():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def launch(q, k, v, lengths, *, scale: float, w_real: int):
    """q: [B,1,H,hd], k/v: [B,W,Hkv,hd], lengths: int32 [B] contiguous, all
    on one CUDA device (checked by the caller). Returns a new [B,1,H,hd]."""
    B, _, H, hd = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lengths.data_ptr(),
        B, W, H, Hkv, hd,
        q.stride(0), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(w_real), float(scale), int(q.dtype == torch.bfloat16), stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    return o
