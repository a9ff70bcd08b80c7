"""Launcher of the hand-written chunked SSD-scan kernel
(``csrc/ssd_scan.cu``, CUDA C++ for sm_90a, bound through ctypes).

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py::
ssd_scan_bhsd``. The source file states the design and what bounds it on
the card; :func:`repro_torch.kernels.ops.ssd_scan` is the public entry point
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
_FWD = build.CFunction("ssd_scan", "ssd_scan_fwd",
                       [_P] * 7 + [_I] * 6 + [_L] * 10 + [_I])

STATE_DIMS = (128,)  # d_state the kernel is built for
TILE = 64  # the chunk length must be a multiple of it ...
MAX_CHUNK = 256  # ... and at most this
COLS = 16  # head-dim columns of the state per CTA (P in the source)


def launch(x, dt, A, B, C, *, chunk: int):
    """x: [b,S,nh,hd], dt: [b,S,nh] fp32, A: [nh] fp32, B/C: [b,S,1,ds] on
    one CUDA device, last dims contiguous (checked by the caller). Returns
    new tensors y [b,S,nh,hd] (x's dtype) and state [b,nh,hd,ds] fp32."""
    b, S, nh, hd = x.shape
    ds = B.shape[-1]
    y = torch.empty((b, S, nh, hd), dtype=x.dtype, device=x.device)
    state = torch.empty((b, nh, hd, ds), dtype=torch.float32, device=x.device)
    _FWD(
        x.get_device(), x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, S, nh, hd, ds, int(chunk),
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
        dt.stride(2), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        int(x.dtype == torch.bfloat16),
    )
    return y, state
