"""Launcher of the hand-written RMSNorm kernel (``csrc/rmsnorm.cu``, CUDA
C++ for sm_90a, bound through ctypes).

Replaces the Pallas TPU kernel ``src/repro/kernels/rmsnorm.py::rmsnorm_2d``.
The source file states the design and what bounds it on the card;
:func:`repro_torch.kernels.ops.rmsnorm` is the public entry point that
checks arguments, counts launches and picks this launcher for CUDA tensors.
Its gradient, :func:`launch_bwd`, is the same file's ``rmsnorm_bwd`` (no
Pallas counterpart: JAX differentiates its jnp rmsnorm), on the geometry of
:func:`bwd_plan`: a narrow row to a group of lanes of one warp, a wide row
to a CTA, the CTAs an SM from the occupancy API.

At decode (8 rows) the kernel's device time is a few microseconds, so the
call's cost is the host's: this launcher allocates the output, reads three
pointers and hands eight arguments to a ctypes function resolved once
(:class:`repro_torch.kernels.build.CFunction`), with no reshape and no
per-call lookup.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD = build.CFunction("rmsnorm", "rmsnorm_fwd",
                       [_P, _P, _P, _I, _I, ctypes.c_float, _I])
_BWD = build.CFunction("rmsnorm", "rmsnorm_bwd",
                       [_P] * 6 + [_I] * 9 + [ctypes.c_float, _I])
_BWD_OCC = build.CFunction("rmsnorm", "rmsnorm_bwd_occupancy", [_I] * 7 + [_P])

# the widest row the backward kernels take (a wide row is a CTA of at most
# WIDE_THREADS threads of WIDE_ELEMS elements each)
BWD_MAX_D = 8192
WIDE_ELEMS = 16
WIDE_THREADS = 512
# the narrow kernel: accesses a lane it is built for, and the warps a CTA
# the plan gives each (at most, within the kernel's launch bounds)
NARROW_VECS = (2, 3, 4, 6)
NARROW_WARPS = {2: 8, 3: 4, 4: 4, 6: 4}
# partial rows a slice of the ordered dw sum takes at least (at most 32
# slices, a CTA of 32 columns x slices)
DW_SLICE_ROWS = 8


class BwdPlan(NamedTuple):
    """The backward's geometry (:func:`bwd_plan`). ``wide``: a row to a CTA
    of ``threads`` threads; else a row to a group of ``lanes`` lanes, ``32 //
    lanes`` rows a warp at once, ``threads // 32`` warps a CTA. ``elems``:
    elements an access (16 bytes' worth, or 1); ``vecs``: accesses a
    thread holds of a row. ``grid`` CTAs, each writing one of the fp32
    scratch's ``grid`` partial rows of dw; ``slices``: the dw sum's slices
    of consecutive partial rows."""

    wide: bool
    elems: int
    lanes: int
    vecs: int
    threads: int
    grid: int
    slices: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def bwd_shape(D: int, itemsize: int, vec: bool = True):
    """(wide, elems, lanes, vecs, threads) of a row of ``D`` elements of
    ``itemsize`` bytes, ``vec`` for the 16-byte path: a row of at most 32 x
    6 accesses is narrow, its lanes the fewest (a power of two) that hold it
    at the fewest of NARROW_VECS accesses a lane, its CTA NARROW_WARPS
    warps; a wider row takes a CTA of threads of WIDE_ELEMS elements
    each."""
    E = 16 // itemsize if vec else 1
    n_acc = D // E
    if n_acc <= 32 * NARROW_VECS[-1]:
        V = next(v for v in NARROW_VECS if 32 * v >= n_acc)
        return (False, E, _pow2_at_least(-(-n_acc // V)), V,
                32 * NARROW_WARPS[V])
    V = WIDE_ELEMS // E
    return True, E, 0, V, (-(-n_acc // V) + 31) // 32 * 32


def bwd_plan(N: int, D: int, itemsize: int, n_sm: int, per_sm: int,
             vec: bool = True) -> BwdPlan:
    """The backward's geometry for ``N`` rows of ``D`` on a card of ``n_sm``
    SMs that hold ``per_sm`` CTAs each of :func:`bwd_shape`'s (the
    occupancy API's answer). Narrow: the CTA's warps cut to the row groups
    ``N`` needs, at most ``n_sm * per_sm`` CTAs and never more than the rows'
    groups fill, each group walking rows the grid's groups apart (so every
    warp walks the same number to within one). Wide: at most ``n_sm *
    per_sm`` CTAs, each the same number of rows to within one. The dw sum:
    slices of at least DW_SLICE_ROWS partial rows, at most 32, none
    empty."""
    wide, E, lanes, V, threads = bwd_shape(D, itemsize, vec)
    most = n_sm * max(per_sm, 1)
    if wide:
        per = -(-N // most)
        grid = -(-N // per)
    else:
        groups = 32 // lanes
        w = min(threads // 32, -(-N // groups))
        threads = 32 * w
        grid = min(most, -(-N // (w * groups)))
    rows = max(DW_SLICE_ROWS, -(-grid // 32))  # partial rows a slice
    return BwdPlan(wide, E, lanes, V, threads, grid, -(-grid // rows))


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


_occ: dict[tuple, int] = {}  # (device, geometry) -> CTAs an SM
_sm_count: dict[int, int] = {}


def plan_on(dev: int, N: int, D: int, itemsize: int, dtypes: int,
            vec: bool) -> tuple[BwdPlan, int]:
    """(:func:`bwd_plan`, the CTAs an SM) on CUDA device ``dev`` for
    ``dtypes`` (as ``launch``'s), the CTAs an SM from the occupancy API at
    the CTA size of :func:`bwd_shape` (asked once a geometry)."""
    n_sm = _sm_count.get(dev)
    if n_sm is None:
        n_sm = _sm_count[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    wide, _, lanes, V, threads = shape = bwd_shape(D, itemsize, vec)
    key = (dev, dtypes, shape)
    per_sm = _occ.get(key)
    if per_sm is None:
        out = ctypes.c_int(0)
        _BWD_OCC(dev, D, int(vec), int(wide), V, lanes, threads, dtypes,
                 ctypes.addressof(out))
        per_sm = _occ[key] = max(out.value, 1)
    return bwd_plan(N, D, itemsize, n_sm, per_sm, vec), per_sm


def launch_bwd(x, w, dy, eps: float):
    """The gradients (dx, dw) of :func:`launch`'s output given ``dy``, its
    shape and dtype: x and dy contiguous, not empty, of one dtype, w
    contiguous, D at most :data:`BWD_MAX_D` (checked by the caller). Two
    launches on :func:`plan_on`'s geometry: the rows, each CTA writing its
    fp32 partial sum of dw, then their ordered sum."""
    D = w.shape[0]
    N = x.numel() // D
    dev = x.get_device()
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    isz = x.element_size()
    dtypes = (x.dtype is torch.bfloat16) | (w.dtype is torch.bfloat16) << 1
    vec = not (D * isz % 16 or any(t.data_ptr() % 16 for t in (x, w, dy, dx)))
    p, _ = plan_on(dev, N, D, isz, dtypes, vec)
    partial = torch.empty((p.grid, D), dtype=torch.float32, device=x.device)
    _BWD(dev, x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
         dw.data_ptr(), partial.data_ptr(), N, D, int(vec), int(p.wide),
         p.vecs, p.lanes, p.threads, p.grid, p.slices, eps, dtypes)
    return dx, dw
