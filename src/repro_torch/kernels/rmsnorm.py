"""Launcher of the hand-written RMSNorm kernel (``csrc/rmsnorm.cu``, CUDA
C++ for sm_90a, bound through ctypes).

Replaces the Pallas TPU kernel ``src/repro/kernels/rmsnorm.py::rmsnorm_2d``.
The source file states the design and what bounds it on the card;
:func:`repro_torch.kernels.ops.rmsnorm` is the public entry point that
checks arguments, counts launches and picks this launcher for CUDA tensors.
Its gradient, :func:`launch_bwd`, is the same file's ``rmsnorm_bwd`` (no
Pallas counterpart: JAX differentiates its jnp rmsnorm).

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
_BWD = build.CFunction("rmsnorm", "rmsnorm_bwd",
                       [_P] * 6 + [_I, _I, _I, ctypes.c_float, _I])
# the widest row the backward kernel takes (a thread holds 32 elements of
# it, a CTA at most 256 threads)
BWD_MAX_D = 8192
_ctas: dict[int, int] = {}  # device -> the backward's persistent CTAs


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


def launch_bwd(x, w, dy, eps: float):
    """The gradients (dx, dw) of :func:`launch`'s output given ``dy``, its
    shape and dtype: x and dy contiguous, not empty, of one dtype, w
    contiguous, D at most :data:`BWD_MAX_D` (checked by the caller). Two
    launches: the rows on a persistent grid of at most 2 CTAs an SM, each
    writing its fp32 partial sum of dw, then their sum in order."""
    D = w.shape[0]
    N = x.numel() // D
    dev = x.get_device()
    per = _ctas.get(dev)
    if per is None:
        per = _ctas[dev] = 2 * torch.cuda.get_device_properties(
            dev).multi_processor_count
    ctas = min(N, per)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    partial = torch.empty((ctas, D), dtype=torch.float32, device=x.device)
    _BWD(dev, x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
         dw.data_ptr(), partial.data_ptr(), N, D, ctas, eps,
         (x.dtype is torch.bfloat16) | (w.dtype is torch.bfloat16) << 1)
    return dx, dw
