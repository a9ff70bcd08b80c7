"""Fused serving-stage preprocessing, hand-written in Triton for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/preprocess.py::
preprocess_2d`` (body ``_preprocess_kernel``) and computes the same
function on ``[N, D]`` uint8 features: ``x.float() * fp32(1/255)``, then
``(x - mean[col]) / std[col]`` with a true (correctly rounded) division,
then a cast to the output dtype (bf16 or fp32).

Why Triton: the work is one fused elementwise pass with no reduction and
no data reuse, the case Triton's block model serves as well as CUDA C++
would, and it adds nothing to the ``nvcc`` build.

What bounds it on this card: memory. It reads ``N * D`` bytes and writes
``N * D`` outputs (2 bytes each in bf16) with about 4 operations per
element. Its design does not carry over the Pallas ``[512, D]`` row tiles:
the input is one flat run of ``N * D`` bytes, each program takes a
contiguous block of ``BLOCK`` elements (wide, coalesced loads and stores
for any D, the 3 channels of an image included), and reads ``mean`` and
``std`` at ``offset % D``, which stay in L1/L2. D is a compile-time
constant (one build per feature width), so that modulo is a multiply and
a shift, on 32-bit offsets unless ``N * D`` needs 64.

``triton`` is imported inside :func:`launch`, so this module imports on a
machine without it.
"""

from __future__ import annotations

import torch

BLOCK = 4096  # elements per program: 16 per thread at 8 warps
_kernel = None


def _build():
    import triton
    import triton.language as tl

    @triton.jit
    def preprocess_kernel(x_ptr, mean_ptr, std_ptr, o_ptr, n,
                          D: tl.constexpr, BLOCK: tl.constexpr,
                          WIDE: tl.constexpr):
        pid = tl.program_id(0)
        if WIDE:  # 64-bit offsets only where N * D needs them
            pid = pid.to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        x = tl.load(x_ptr + offs, mask=mask, other=0).to(tl.float32)
        col = offs % D
        m = tl.load(mean_ptr + col, mask=mask, other=0.0)
        s = tl.load(std_ptr + col, mask=mask, other=1.0)
        y = tl.math.div_rn(x * (1.0 / 255.0) - m, s)
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)

    return preprocess_kernel


def launch(x2, mean, std, out_dtype):
    """x2: [N, D] contiguous uint8; mean, std: [D] contiguous fp32, on one
    CUDA device (checked by the caller). Returns a new [N, D] tensor of
    ``out_dtype``."""
    import triton

    global _kernel
    if _kernel is None:
        _kernel = _build()
    N, D = x2.shape
    o = torch.empty((N, D), dtype=out_dtype, device=x2.device)
    n = N * D
    if n:
        _kernel[(triton.cdiv(n, BLOCK),)](x2, mean, std, o, n, D=D,
                                          BLOCK=BLOCK, WIDE=n >= 2**31 - BLOCK,
                                          num_warps=8)
    return o
