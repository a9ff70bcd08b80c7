"""Launcher of the hand-written RMSNorm kernel (``csrc/rmsnorm.cu``, CUDA
C++ for sm_90a, bound through ctypes).

Replaces the Pallas TPU kernel ``src/repro/kernels/rmsnorm.py::rmsnorm_2d``.
The source file states the design and what bounds it on the card;
:func:`repro_torch.kernels.ops.rmsnorm` is the public entry point that
checks arguments, counts launches and picks this launcher for CUDA tensors.

At decode (8 rows) the kernel's device time is a few microseconds, so the
call's cost is the host's: this launcher allocates the output, reads three
pointers and hands eight arguments to a ctypes function resolved once
(:class:`repro_torch.kernels.build.CFunction`), with no reshape and no
per-call lookup.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD = build.CFunction("rmsnorm", "rmsnorm_fwd",
                       [_P, _P, _P, _I, _I, ctypes.c_float, _I])


def launch(x, w, eps: float):
    """x: [..., D] contiguous and not empty, w: [D] contiguous, each fp32 or
    bf16, on one CUDA device (checked by the caller). Returns a new tensor
    of x's shape and dtype."""
    o = torch.empty_like(x)
    D = w.shape[0]
    _FWD(x.get_device(), x.data_ptr(), w.data_ptr(), o.data_ptr(),
         x.numel() // D, D, eps,
         (x.dtype is torch.bfloat16) | (w.dtype is torch.bfloat16) << 1)
    return o
