"""Launcher of the hand-written chunked SSD-scan kernels
(``csrc/ssd_scan.cu``, CUDA C++ for sm_90a, bound through ctypes).

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py::
ssd_scan_bhsd``. The source file states the design and what bounds it on
the card: bf16 runs three tensor-core launches over chunks of
:data:`CHUNK` positions and groups of heads (chunk states, state passing,
outputs), with scratch allocated here; fp32 runs the CUDA-core kernel.
:func:`repro_torch.kernels.ops.ssd_scan` is the public entry point that
checks arguments, counts launches and picks this launcher for CUDA tensors.

Its gradient is :func:`launch_bwd`, the hand-written backward of
``csrc/ssd_scan_bwd.cu`` (no Pallas counterpart: JAX differentiates its jnp
``ssd_chunked``): launches over chunks of :data:`BWD_CHUNK` positions that
recompute the states entering each chunk instead of saving them -- bf16
four on the tensor cores (hd 64), fp32 five on the CUDA cores (the head
dims of :data:`BWD_HEAD_DIMS`), both at d_state 16 and 128; its scratch is
:func:`bwd_scratch_bytes`.
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
_BWD = build.CFunction("ssd_scan_bwd", "ssd_scan_bwd",
                       [_P] * 16 + [_I] * 7 + [_L] * 10)

STATE_DIMS = (16, 128)  # d_state the kernels are built for (jamba, mamba2)
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
# and of jamba-v0.1-52b's 128
HEAD_GROUPS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 128)
CTAS_PER_SM = 2  # the output launch's 98 KB (d_state 128) fits two an SM

# the backward: its own chunk of positions for every dtype, and the head
# dims it is built for (fp32; bf16 takes BF16_HEAD_DIMS)
BWD_CHUNK = 64
BWD_HEAD_DIMS = (16, 32, 48, 64)

_sm_count: dict[int, int] = {}


def _n_sm(dev: int) -> int:
    n = _sm_count.get(dev)
    if n is None:
        n = _sm_count[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


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
    hpc = _heads or heads_per_cta(b * -(-S // CHUNK), nh, _n_sm(dev))
    scratch = torch.empty(scratch_words(b, S, nh, hd, ds), dtype=torch.float32,
                          device=x.device)
    _BF16(dev, x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
          C.data_ptr(), y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
          b, S, nh, hd, ds, hpc, *strides)
    return y, state


def bwd_heads_per_cta(n_chunks: int, nh: int, n_sm: int) -> int:
    """Heads a CTA of the backward's output launch takes, for ``n_chunks``
    chunks of BWD_CHUNK positions over all batch rows: the most that divide
    ``nh`` and still give every SM a CTA (a CTA sums dB and dC over its
    heads in registers, so fewer groups write fewer partials, and each CTA
    loads its chunk's B and C once); 1 when even one head a CTA leaves SMs
    idle. bf16's output launch runs one CTA an SM (171 KiB of shared memory
    at d_state 128) and hides the next head's loads behind the current
    head's products with two stages, so a CTA takes many heads."""
    for g in sorted((d for d in range(1, nh + 1) if nh % d == 0),
                    reverse=True):
        if n_chunks * (nh // g) >= n_sm:
            return g
    return 1


def bwd_scratch_bytes(b: int, S: int, nh: int, hd: int, ds: int, dtype: str,
                      n_sm: int = 132) -> int:
    """Bytes of :func:`launch_bwd`'s scratch (``dtype`` "bf16" or "fp32",
    on a card of ``n_sm`` SMs): the states entering each chunk (H) and the
    gradients of the states leaving it (G') -- bf16: one bf16 plane each,
    written by the walk (no chunk contribution goes to memory); fp32: each
    chunk's contributions, written by launch 1 and turned into H and G' in
    place by the walks, and the chunks' decays --; the output launch's dB
    and dC partials (fp32, one a group of heads); the dA parts (fp64)."""
    nc = -(-S // BWD_CHUNK)
    state = b * nc * nh * hd * ds
    ng = nh // bwd_heads_per_cta(b * nc, nh, n_sm)
    walks = 2 * 2 * state if dtype == "bf16" else 2 * 4 * state + 4 * b * nc * nh
    return walks + 2 * 4 * b * ng * S * ds + 8 * b * nc * nh


def launch_bwd(x, dt, A, B, C, dy, *, _heads: int | None = None):
    """The gradients of :func:`launch`'s y given ``dy`` (the final state
    takes none) through ``csrc/ssd_scan_bwd.cu``. x, dt, A, B, C as
    :func:`launch` takes them; dy: contiguous [b,S,nh,hd] in x's dtype.
    Returns new contiguous (dx in x's dtype, ddt fp32 [b,S,nh], dA fp32
    [nh], dB and dC [b,S,1,ds] in B's dtype). ``_heads`` overrides the
    output launch's heads a CTA (kernel-level comparisons only)."""
    b, S, nh, hd = x.shape
    ds = B.shape[-1]
    dev = x.get_device()
    nc = -(-S // BWD_CHUNK)
    hpc = _heads or bwd_heads_per_cta(b * nc, nh, _n_sm(dev))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, S, nh), **f32)
    dA = torch.empty((nh,), **f32)
    dB, dC = (torch.empty((b, S, 1, ds), dtype=B.dtype, device=x.device)
              for _ in range(2))
    # H and G': bf16 planes, or the fp32 chunk contributions and decays the
    # fp32 walks turn into them in place
    bf = x.dtype == torch.bfloat16
    states, grads = (torch.empty((b, nc, nh, hd, ds), device=x.device,
                                 dtype=x.dtype) for _ in range(2))
    decay = None if bf else torch.empty((b, nc, nh), **f32)
    dbc = torch.empty((2, b, nh // hpc, S, ds), **f32)
    da_part = torch.empty((b, nc, nh), dtype=torch.float64, device=x.device)
    _BWD(dev, x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
         C.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
         dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), states.data_ptr(),
         grads.data_ptr(), 0 if bf else decay.data_ptr(), dbc.data_ptr(),
         da_part.data_ptr(),
         b, S, nh, hd, ds, hpc, int(bf),
         x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
         dt.stride(2), B.stride(0), B.stride(1), C.stride(0), C.stride(1))
    return dx, ddt, dA, dB, dC
