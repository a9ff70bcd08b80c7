"""Launcher of the hand-written paged decode-attention kernel
(``csrc/paged_decode_attention.cu``, CUDA C++ for sm_90a, bound through
ctypes).

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py::
paged_decode_attention_bhgd``. The source file states the design and what
bounds it on the card; :func:`repro_torch.kernels.ops.paged_decode_attention`
is the public entry point that checks arguments, counts launches and picks
this launcher for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P] * 6 + [_I] * 6 + [_L] * 8 + [ctypes.c_float, _I, _P]

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16  # query heads per KV head one CTA holds


def _fn():
    lib = build.load("paged_decode_attention")
    fn = lib.paged_decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def launch(q, k_blocks, v_blocks, page_table, lengths, *, scale: float):
    """q: [B,1,H,hd], k/v blocks: [N,page,Hkv,hd], page_table: int32
    [B,n_pages] and lengths: int32 [B], both contiguous, all on one CUDA
    device (checked by the caller). Returns a new [B,1,H,hd]."""
    B, _, H, hd = q.shape
    page, Hkv = k_blocks.shape[1], k_blocks.shape[2]
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(
        q.data_ptr(), k_blocks.data_ptr(), v_blocks.data_ptr(), o.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(),
        B, page_table.shape[1], page, H, Hkv, hd,
        q.stride(0), q.stride(2),
        k_blocks.stride(0), k_blocks.stride(1), k_blocks.stride(2),
        v_blocks.stride(0), v_blocks.stride(1), v_blocks.stride(2),
        float(scale), int(q.dtype == torch.bfloat16), stream,
    )
    if err != 0:
        raise RuntimeError(
            f"paged_decode_attention kernel launch failed: cudaError {err}")
    return o
