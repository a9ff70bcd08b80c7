"""Each hand-written kernel's work: (FLOPs, bytes) of one call.

:func:`kernel_work` is the one count of a kernel's work, whatever
implements it: the bytes the function must move (each input read once,
each output written once) and the operations it does on the call's inputs.
PERF.md's kernel table takes its bound column from it, ``chip_smoke.py``
phase 2 its bounds, ``kernels/ops.py``'s meta path the dry-run's kernel
counts (``repro_torch.launch.roofline``).
"""

from __future__ import annotations


def causal_pairs(Sq: int, window: int = 0, prior: int = 0,
                 real: int = None) -> int:
    """(query, key) pairs one head of one row computes under the causal
    mask: query i sees keys 0..i (and, with a ``window``, only the last
    ``window`` of them), after every one of ``prior`` cached keys; rows and
    keys at or past ``real`` are masked."""
    n = Sq if real is None else real
    if window and window < n:
        own = window * (window + 1) // 2 + (n - window) * window
    else:
        own = n * (n + 1) // 2
    return own + n * prior


def _rmsnorm(N, D, isz=2):
    # read x and w, write y; a square, a sum, a scale and a product an entry
    return 4 * N * D, (2 * N * D + D) * isz


def _rmsnorm_bwd(N, D, isz=2):
    # read x, dy (and w), write dx (and dw)
    return 10 * N * D, (3 * N * D + 2 * D) * isz


def _flash(B, Sq, Skv, H, Hkv, hd, hdv=None, isz=2, causal=True, window=0,
           prior=0, segments=False, pairs=None):
    """q and o of Sq rows, k and v of Skv (+ ``prior``) keys, each read or
    written once (the prior's int32 lengths, the segment ids and their run
    starts besides); 2 (hd + hdv) FLOPs a (query, key) pair a head.
    ``pairs``: the pairs one head computes, summed over the batch, where
    the data sets them (segment ids); else from the mask."""
    hdv = hd if hdv is None else hdv
    if pairs is None:
        pairs = B * (causal_pairs(Sq, window, prior) if causal
                     else Sq * (Skv + prior))
    nbytes = B * (Sq * H + (Skv + prior) * Hkv) * (hd + hdv) * isz
    nbytes += (B * 4 if prior else 0) + (2 * B * Sq * 4 if segments else 0)
    return 2 * (hd + hdv) * H * pairs, nbytes


def _flash_bwd(B, S, H, Hkv, hd, hdv=None, isz=2, real=None, pairs=None,
               Skv=None, causal=True, window=0):
    """q, k, v, o, dO and the log-sum-exp read once, dQ, dK, dV written
    once; 2 (3 hd + 2 hdv) FLOPs a pair a head (the five products S, dV,
    dP, dQ, dK). S query rows, ``Skv`` keys (default S); causal unless
    asked otherwise, rows and keys at or past ``real`` masked."""
    hdv = hd if hdv is None else hdv
    Skv = S if Skv is None else Skv
    if pairs is None:
        pairs = B * (causal_pairs(S, window, real=real) if causal
                     else S * Skv)
    nbytes = B * (S * H + Skv * Hkv) * 2 * (hd + hdv) * isz + 4 * B * H * S
    return 2 * (3 * hd + 2 * hdv) * H * pairs, nbytes


def _decode(B, H, Hkv, hd, positions, isz=2):
    """One query a row over ``positions`` valid cache slots (summed over
    the rows): q and o, those slots' k and v, the int32 lengths."""
    return (4 * hd * H * positions,
            (2 * B * H * hd + 2 * positions * Hkv * hd) * isz + B * 4)


def _paged_decode(B, H, Hkv, hd, positions, unique=None, table=0, isz=2):
    """:func:`_decode` through a page table: the blocks the rows share read
    once (``unique`` positions), the table's int32 entries besides."""
    unique = positions if unique is None else unique
    return (4 * hd * H * positions,
            (2 * B * H * hd + 2 * unique * Hkv * hd) * isz + table * 4 + B * 4)


def _mla_decode(B, H, r, dr, positions, isz=2, table=0):
    """Absorbed MLA decode: each valid latent row (r + dr wide) read once,
    q (r + dr) and the latent output (r) a head, the int32 lengths (and a
    page table); 2 (r + dr + r) FLOPs a row a head."""
    return (2 * (r + dr + r) * H * positions,
            positions * (r + dr) * isz + B * H * (r + dr + r) * isz + B * 4
            + table * 4)


def _ssd(b, S, nh, hd, ds, chunk, isz=2):
    """x, B, C (``isz``), dt, A read once, y and the fp32 final state
    written once. FLOPs a chunk of L positions: the causal half of C.B^T
    once (one B/C group serves every head); a head the causal half of the
    scores times dt x, the state update, and C.state from the second chunk
    on (the state starts at 0)."""
    nbytes = ((2 * b * S * nh * hd + 2 * b * S * ds) * isz + b * S * nh * 4
              + nh * 4 + b * nh * hd * ds * 4)
    flops = 0
    for c0 in range(0, S, chunk):
        L = min(chunk, S - c0)
        causal = L * (L + 1) // 2
        flops += 2 * causal * ds + nh * (
            2 * causal * hd + 2 * L * hd * ds * (2 if c0 else 1))
    return b * flops, nbytes


def _ssd_bwd(b, S, nh, hd, ds, isz=2, chunk=64):
    """x, dy, B, C (``isz``), dt and A (fp32) read once; dx, dB, dC, ddt and
    dA written once. FLOPs a chunk of ``chunk`` positions (the kernel's):
    the causal half of C.B^T once; a head the causal halves of dy.x'^T,
    (C.B^T)^T dy, W^T C and W B, and the state products -- the chunk's
    state contribution (not for the last chunk: the final state takes no
    gradient), its part of the entering state's gradient (not for the
    first), G'B^T and x'^T G' (not for the last), dy^T H (not for the
    first)."""
    nbytes = ((3 * b * S * nh * hd + 4 * b * S * ds) * isz
              + 2 * b * S * nh * 4 + 2 * nh * 4)
    flops = 0
    nc = -(-S // chunk)
    for c in range(nc):
        n = min(chunk, S - c * chunk)
        causal = n * (n + 1) // 2
        state = 2 * n * hd * ds
        n_state = (c < nc - 1) * 3 + (c > 0) * 2
        flops += b * (2 * causal * ds + nh * (
            4 * causal * hd + 4 * causal * ds + n_state * state))
    return flops, nbytes


def _preprocess(n, D, out_isz=2):
    """n uint8 entries read, n written in the output dtype, fp32 mean and
    std read; 4 fp32 operations an entry."""
    return 4 * n, n + n * out_isz + 8 * D


_WORK = {
    "rmsnorm": _rmsnorm, "rmsnorm_bwd": _rmsnorm_bwd,
    "flash_attention": _flash, "flash_attention_bwd": _flash_bwd,
    "decode_attention": _decode, "paged_decode_attention": _paged_decode,
    "mla_decode_attention": _mla_decode,
    "paged_mla_decode_attention": _mla_decode,
    "ssd_scan": _ssd, "ssd_scan_bwd": _ssd_bwd, "preprocess": _preprocess,
}
KERNELS = tuple(_WORK)


def kernel_work(name: str, *args, **kw) -> tuple:
    """(FLOPs, bytes) of one call of the hand-written kernel ``name`` (a
    key of ``ops.LAUNCHES``), whatever implements it: the bytes the
    function must move (each input read once, each output written once)
    and the operations it does on this call's inputs. Arguments by kernel:

    * ``rmsnorm`` / ``rmsnorm_bwd``: N rows, D, itemsize;
    * ``flash_attention``: B, Sq, Skv, H, Hkv, hd, hdv, isz, causal,
      window, prior (cached keys a row), segments, pairs;
    * ``flash_attention_bwd``: B, S, H, Hkv, hd, hdv, isz, real, pairs,
      Skv, causal, window;
    * ``decode_attention``: B, H, Hkv, hd, positions (valid slots summed
      over the rows), isz; ``paged_decode_attention`` adds ``unique`` (the
      positions of blocks read once) and ``table`` (page-table entries);
    * ``mla_decode_attention`` / ``paged_mla_decode_attention``: B, H, r,
      dr, positions, isz, table;
    * ``ssd_scan``: b, S, nh, hd, ds, chunk, isz; ``ssd_scan_bwd``: b, S,
      nh, hd, ds, isz, chunk (the kernel's 64);
    * ``preprocess``: n entries, D, out_isz.
    """
    return _WORK[name](*args, **kw)
