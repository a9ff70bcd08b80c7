"""Launcher of the hand-written ring decode-attention kernel
(``csrc/decode_attention.cu``, CUDA C++ for sm_90a, bound through ctypes).

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py::
decode_attention_bhgd``. The source file states the design and what bounds
it on the card; :func:`repro_torch.kernels.ops.decode_attention` is the
public entry point that checks arguments, counts launches and picks this
launcher for CUDA tensors.

The launcher owns the split count: :func:`num_splits` picks how many CTAs
(one thread-block cluster) share a row's keys, from W and the card's SM
count; the kernel cuts each row's valid keys into that many shares of
whole tiles. No caller sees a split; ``launch(..., _splits=1)`` runs one
CTA a row, the paged kernel's key order and arithmetic, for a bitwise
comparison with it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P] + [_I] * 5 + [_L] * 8 + [_I, ctypes.c_float,
                                                         _I, _I, _P]

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16  # query heads per KV head one CTA holds
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


_n_sm: dict[int, int] = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _n_sm:
        _n_sm[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _n_sm[idx]


def _fn():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def launch(q, k, v, lengths, *, scale: float, w_real: int, _splits=None):
    """q: [B,1,H,hd], k/v: [B,W,Hkv,hd], lengths: int32 [B] contiguous, all
    on one CUDA device (checked by the caller). Returns a new [B,1,H,hd].
    ``_splits`` forces the CTAs a row (1: the unsplit key order, which the
    paged kernel shares); by default :func:`num_splits` picks it."""
    B, _, H, hd = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    splits = _splits or num_splits(W, B * Hkv, _sm_count(q.device))
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lengths.data_ptr(),
        B, W, H, Hkv, hd,
        q.stride(0), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(w_real), float(scale), int(q.dtype == torch.bfloat16), splits,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    return o
