"""Fused RMSNorm, hand-written in Triton for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/rmsnorm.py::rmsnorm_2d``
(body ``_rmsnorm_kernel``) and computes the same function per row of
``[N, D]``: the fp32 mean of squares, ``x * rsqrt(var + eps)`` cast to x's
dtype, then ``* w`` (that cast order is the JAX model's bf16 rounding), the
result in x's dtype.

Why Triton: the kernel is one row-wise fp32 reduction and one elementwise
pass over a row (D = 4096 on llama3-8b) that fits one program's block, the
normalisation case Triton's block model handles without hand-written
shared-memory reductions, and it adds nothing to the ``nvcc`` build.

What bounds it on this card: it reads x and w once and writes y once, with
about 4 operations per element, so it is bound by memory bandwidth. Its
design: one program per row, the whole row in registers (one read, one
write, no second pass over device memory). At decode (N = max_batch rows)
only 8 programs run, so a call is dominated by launch latency; fusing the
norm into the neighbouring matmul's prologue is the later fix.

``triton`` is imported inside :func:`launch`, so this module imports on a
machine without it.
"""

from __future__ import annotations

import torch

_kernel = None


def _build():
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, w_ptr, o_ptr, D, stride_x, stride_o, eps,
                       BLOCK: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < D
        x = tl.load(x_ptr + row * stride_x + cols, mask=mask, other=0.0)
        x32 = x.to(tl.float32)
        var = tl.sum(x32 * x32, axis=0) / D
        y = (x32 * tl.rsqrt(var + eps)).to(x.dtype)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0)
        out = y.to(tl.float32) * w.to(tl.float32)
        tl.store(o_ptr + row * stride_o + cols, out.to(x.dtype), mask=mask)

    return rmsnorm_kernel


def launch(x2, w, eps: float):
    """x2: [N, D] with contiguous rows, w: [D] contiguous, on one CUDA
    device (checked by the caller). Returns a new [N, D] tensor."""
    import triton

    global _kernel
    if _kernel is None:
        _kernel = _build()
    N, D = x2.shape
    o = torch.empty_like(x2)
    block = triton.next_power_of_2(D)
    num_warps = min(16, max(1, block // 256))
    _kernel[(N,)](x2, w, o, D, x2.stride(0), o.stride(0), float(eps),
                  BLOCK=block, num_warps=num_warps)
    return o
