"""Launcher of the hand-written chunked SSD-scan kernels
(``csrc/ssd_scan.cu``, CUDA C++ for sm_90a, bound through ctypes).

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py::
ssd_scan_bhsd``. The source file states the design and what bounds it on
the card: bf16 runs three tensor-core launches over chunks of
:data:`CHUNK` positions and groups of heads (chunk states, state passing,
outputs), with scratch allocated here; fp32 runs the CUDA-core kernel.
:func:`repro_torch.kernels.ops.ssd_scan` is the public entry point that
checks arguments, counts launches and picks this launcher for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_FWD = build.CFunction("ssd_scan", "ssd_scan_fwd",
                       [_P] * 7 + [_I] * 6 + [_L] * 10)
_BF16 = build.CFunction("ssd_scan", "ssd_scan_bf16_fwd",
                        [_P] * 8 + [_I] * 6 + [_L] * 10)

STATE_DIMS = (128,)  # d_state the kernels are built for
# fp32 (CUDA cores): the config's chunk, a multiple of TILE up to MAX_CHUNK;
# the head dim a multiple of COLS
TILE = 64
MAX_CHUNK = 256
COLS = 16  # head-dim columns of the state per CTA (P in the source)
# bf16 (tensor cores): the kernels' own chunk of positions, whatever the
# config's (the function does not depend on it up to rounding), and the
# head dim they are built for
CHUNK = 64
BF16_HEAD_DIMS = (64,)
# heads a CTA may take on the bf16 path: divisors of mamba2-130m's 24 heads
HEAD_GROUPS = (1, 2, 3, 4, 6, 8, 12, 24)
CTAS_PER_SM = 2  # the output launch's 98 KB of shared memory fits two an SM

_sm_count: dict[int, int] = {}


def heads_per_cta(n_chunks: int, nh: int, n_sm: int) -> int:
    """Heads a CTA of the bf16 launches takes, for ``n_chunks`` chunks of
    CHUNK positions over all batch rows: the fewest from HEAD_GROUPS that
    divide ``nh`` and fit the grid in one wave of CTAS_PER_SM CTAs an SM
    (more CTAs than that wait for a second wave; fewer heads a CTA than
    that leave the C.B^T of a chunk computed more often and the next head's
    loads less to overlap with); all ``nh`` when none fits."""
    for g in HEAD_GROUPS:
        if nh % g == 0 and n_chunks * (nh // g) <= CTAS_PER_SM * n_sm:
            return g
    return nh


def scratch_words(b: int, S: int, nh: int, hd: int, ds: int) -> int:
    """fp32 words of the bf16 path's one scratch buffer: each chunk's state
    contribution (fp32), the state entering it as bf16 hi/lo planes (as
    many bytes) and its decay exp(cums_last) (fp32)."""
    nc = -(-S // CHUNK)
    return b * nc * nh * (2 * hd * ds + 1)


def launch(x, dt, A, B, C, *, chunk: int, _heads: int | None = None):
    """x: [b,S,nh,hd], dt: [b,S,nh] fp32, A: [nh] fp32, B/C: [b,S,1,ds] on
    one CUDA device, last dims contiguous (checked by the caller). Returns
    new tensors y [b,S,nh,hd] (x's dtype) and state [b,nh,hd,ds] fp32.
    ``chunk`` is the fp32 kernel's; ``_heads`` overrides the bf16 launches'
    heads a CTA (kernel-level comparisons only)."""
    b, S, nh, hd = x.shape
    ds = B.shape[-1]
    dev = x.get_device()
    y = torch.empty((b, S, nh, hd), dtype=x.dtype, device=x.device)
    state = torch.empty((b, nh, hd, ds), dtype=torch.float32, device=x.device)
    strides = (x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
               dt.stride(2), B.stride(0), B.stride(1), C.stride(0), C.stride(1))
    if x.dtype != torch.bfloat16:
        _FWD(dev, x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), y.data_ptr(), state.data_ptr(), b, S, nh, hd, ds,
             int(chunk), *strides)
        return y, state
    n_sm = _sm_count.get(dev)
    if n_sm is None:
        n_sm = _sm_count[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    hpc = _heads or heads_per_cta(b * -(-S // CHUNK), nh, n_sm)
    scratch = torch.empty(scratch_words(b, S, nh, hd, ds), dtype=torch.float32,
                          device=x.device)
    _BF16(dev, x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
          C.data_ptr(), y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
          b, S, nh, hd, ds, hpc, *strides)
    return y, state
