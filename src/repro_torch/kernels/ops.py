"""Public kernel entry points of the port, in the model's layouts.

Each op dispatches on the device of the tensors it is given:

* CPU tensors take the plain PyTorch version (:mod:`repro_torch.kernels.ref`);
* CUDA tensors launch the hand-written Hopper kernel, or raise. There is no
  fallback from a CUDA tensor to the plain version;
* meta tensors (the dry-run's shapes-only pass, ``launch/dryrun.py``) give
  empty meta outputs of the kernel's shapes and add the kernel's
  ``kernels/work.py`` ``kernel_work`` to the innermost tally of :data:`META_TALLIES`:
  no launch, none counted. Meta holds no data, so this hides no device.

Each op checks device, dtype, shape and contiguity before launching, and
counts its kernel launches in :data:`LAUNCHES` (plain-version calls are not
counted), so a run can show which kernels its main path went through.

Gradients. On the CPU the plain versions are differentiable PyTorch. On
the card an op whose inputs need a gradient (``torch.is_grad_enabled()``
and any input ``requires_grad``) either runs through its
``torch.autograd.Function``, whose backward is a hand-written kernel too
(``flash_attention`` without segment ids or a prior, ``rmsnorm``,
``ssd_scan``), or raises NotImplementedError naming what its backward
waits for: a kernel's output never leaves the autograd graph silently.

The counts are of kernels launched on the card, by an op or a replay. A
CUDA graph capture runs the ops' Python but launches no kernel, and a
replay launches the captured kernels with no Python at all: the decode
pool that captures a step takes the capture's counts back out and adds
them once per replay (:func:`add_launches`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mla_decode_attention as _mla
from repro_torch.kernels import paged_decode_attention as _pdec
from repro_torch.kernels import preprocess as _pp
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.work import kernel_work

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches since the last reset_launches(); only a CUDA launch counts
LAUNCHES: dict[str, int] = {"rmsnorm": 0, "flash_attention": 0,
                            "decode_attention": 0,
                            "paged_decode_attention": 0, "ssd_scan": 0,
                            "preprocess": 0, "mla_decode_attention": 0,
                            "paged_mla_decode_attention": 0,
                            "flash_attention_bwd": 0, "rmsnorm_bwd": 0,
                            "ssd_scan_bwd": 0}

SERVING_ONLY = "a serving kernel: no training path runs it"


# the dry-run's tallies: a kernel op on meta tensors calls the innermost's
# ``add_kernel(name, flops, nbytes, axes)``, ``axes`` the logical axes that
# split its work across a mesh
META_TALLIES: list = []


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` (kernel name -> launches) to
    :data:`LAUNCHES`: a replayed graph's kernels, or with ``times=-1`` a
    capture's, which launched none."""
    for name, n in counts.items():
        LAUNCHES[name] += times * n


def _on_cuda(*tensors) -> bool:
    """True when every tensor is on one CUDA device, False when every one
    is on the CPU (or every one on meta, the dry-run's); anything else
    raises. Attribute reads only: it runs on every launch."""
    first = tensors[0]
    if first.is_cuda:
        dev = first.get_device()
        for t in tensors:
            if not t.is_cuda or t.get_device() != dev:
                break
        else:
            return True
    else:
        kind = first.device.type  # cpu, or meta (the dry-run's)
        for t in tensors:
            if t.device.type != kind:
                break
        else:
            if kind in ("cpu", "meta"):
                return False
    raise ValueError(f"tensors must all be on one CUDA device, all on the "
                     f"CPU or all on meta: {[str(t.device) for t in tensors]}")


def _tally(name, work, axes) -> None:
    if META_TALLIES:
        META_TALLIES[-1].add_kernel(name, *work, axes)


class _MetaFn(torch.autograd.Function):
    """A kernel with a backward, on meta: the forward's and the backward's
    kernel_work tallied, empty outputs, empty gradients for the inputs
    that require one."""

    @staticmethod
    def forward(ctx, fwd, bwd, outs, n_diff, *inputs):
        _tally(*fwd)
        ctx.bwd = bwd
        ctx.specs = [(t.shape, t.dtype) if isinstance(t, torch.Tensor)
                     else None for t in inputs]
        out = outs()
        if isinstance(out, tuple):
            ctx.mark_non_differentiable(*out[n_diff:])
        return out

    @staticmethod
    def backward(ctx, *grads):
        _tally(*ctx.bwd)
        return (None, None, None, None, *(
            None if s is None or not ctx.needs_input_grad[4 + i]
            else torch.empty(s[0], dtype=s[1], device="meta")
            for i, s in enumerate(ctx.specs)))


def _meta_call(fwd, outs, inputs, bwd=None, n_diff=1):
    """An op on meta tensors: ``outs()`` (empty meta outputs of the
    kernel's shapes) with ``fwd`` = (name, kernel_work, axes) tallied.
    Where ``inputs`` require grad, through :class:`_MetaFn` with ``bwd``
    (the backward kernel's triple; the first ``n_diff`` outputs
    differentiable), or, for a kernel without one, raising as on the
    card."""
    if _needs_grad(*inputs):
        if bwd is None:
            raise NotImplementedError(f"{fwd[0]} kernel has no backward here; "
                                      "its inputs require grad")
        return _MetaFn.apply(fwd, bwd, outs, n_diff, *inputs)
    _tally(*fwd)
    return outs()


def _needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on ``tensors`` (None skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _refuse_grad(name, why, *tensors) -> None:
    """Raise where a kernel without a backward would cut the graph."""
    if _needs_grad(*tensors):
        raise NotImplementedError(f"{name} kernel has no backward ({why}); "
                                  "its inputs require grad")


def _aligned(t):
    """``t`` itself when its last dim is contiguous and its rows 16-byte
    aligned (what the backward kernel loads as vectors), else a fresh
    contiguous copy."""
    isz = t.element_size()
    if (t.stride(-1) == 1 and not t.data_ptr() % 16
            and not any(s * isz % 16 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _RmsnormFn(torch.autograd.Function):
    """rmsnorm on the card with its hand-written backward
    (``csrc/rmsnorm.cu`` ``rmsnorm_bwd``): the forward kernel as serving
    runs it, x and w saved; the backward recomputes the row statistics."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        out = _rn.launch(x, w, eps)
        LAUNCHES["rmsnorm"] += 1
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _rn.launch_bwd(x, w, dy.contiguous(), ctx.eps)
        LAUNCHES["rmsnorm_bwd"] += 1
        return dx, dw, None


class _FlashFn(torch.autograd.Function):
    """flash attention on the card with its hand-written backward
    (``csrc/flash_attention_bwd.cu``): the forward kernel also writes each
    row's log-sum-exp, saved with q, k, v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, sq_real, skv_real):
        B, Sq, H, _ = q.shape
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        o = _fa.launch(q, k, v, causal=causal, window=window, scale=scale,
                       segment_ids=None, sq_real=sq_real, skv_real=skv_real,
                       lse=lse)
        LAUNCHES["flash_attention"] += 1
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, window=window, scale=scale,
                        sq_real=sq_real, skv_real=skv_real)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _fa.launch_bwd(*(_aligned(t) for t in (q, k, v, o)),
                                    lse, _aligned(do), **ctx.args)
        LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None, None, None


class _SsdScanFn(torch.autograd.Function):
    """The SSD scan on the card with its hand-written backward
    (``csrc/ssd_scan_bwd.cu``): the forward launches as serving runs them,
    only the inputs saved (the backward recomputes the states entering each
    chunk); the final state is a serving output and takes no gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, state = _ssd.launch(x, dt, A, B, C, chunk=chunk)
        LAUNCHES["ssd_scan"] += 1
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.mark_non_differentiable(state)
        return y, state

    @staticmethod
    def backward(ctx, dy, _dstate):
        x, dt, A, B, C = ctx.saved_tensors
        grads = _ssd.launch_bwd(x, dt, A, B, C, dy.contiguous())
        LAUNCHES["ssd_scan_bwd"] += 1
        return (*grads, None)


def _check_kernel_dtype(name, *tensors):
    dt = tensors[0].dtype
    if dt not in KERNEL_DTYPES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{name} kernel takes one dtype among {KERNEL_DTYPES}: "
                        f"{[t.dtype for t in tensors]}")


def _check_last_dim_contiguous(name, *tensors):
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError(f"{name} kernel needs a contiguous last dim: "
                             f"strides {t.stride()}")


def _check_rows_aligned(name, *tensors):
    """The attention kernels load K/V rows, the SSD scan its x, B and C
    rows, as 16-byte vectors."""
    for t in tensors:
        isz = t.element_size()
        if t.data_ptr() % 16 or any(s * isz % 16 for s in t.stride()[:-1]):
            raise ValueError(f"{name} kernel needs 16-byte-aligned rows: "
                             f"strides {t.stride()}, offset {t.storage_offset()}")


# --------------------------------------------------------------------------- #
def preprocess(x_u8, mean, std, *, out_dtype=torch.bfloat16):
    """x_u8: [..., D] uint8; mean, std: [D] fp32 -> [..., D] ``out_dtype``
    (bf16 or fp32): ``(x / 255 - mean) / std`` per feature."""
    if x_u8.ndim == 0 or not mean.shape == std.shape == x_u8.shape[-1:]:
        raise ValueError(f"preprocess: x {tuple(x_u8.shape)}, mean "
                         f"{tuple(mean.shape)}, std {tuple(std.shape)}")
    if not _on_cuda(x_u8, mean, std):
        if x_u8.is_meta:  # the dry-run's shapes-only pass
            isz = torch.empty((), dtype=out_dtype).element_size()
            return _meta_call(
                ("preprocess", kernel_work("preprocess", x_u8.numel(),
                                           x_u8.shape[-1], isz), ("batch",)),
                lambda: torch.empty(x_u8.shape, dtype=out_dtype,
                                    device="meta"),
                (mean, std))
        return ref.preprocess_ref(x_u8, mean, std, out_dtype)
    _refuse_grad("preprocess", SERVING_ONLY, mean, std)
    if x_u8.dtype != torch.uint8 or out_dtype not in KERNEL_DTYPES:
        raise TypeError(f"preprocess kernel takes uint8 to one of "
                        f"{KERNEL_DTYPES}: {x_u8.dtype} -> {out_dtype}")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in (mean, std)):
        raise TypeError(f"preprocess kernel: mean and std must be contiguous "
                        f"fp32: {mean.dtype}, {std.dtype}")
    if not x_u8.is_contiguous():
        raise ValueError(f"preprocess kernel needs a contiguous x: "
                         f"{x_u8.stride()}")
    out = _pp.launch(x_u8.reshape(-1, x_u8.shape[-1]), mean, std, out_dtype)
    LAUNCHES["preprocess"] += 1
    return out.reshape(x_u8.shape)


def rmsnorm(x, w, *, eps: float = 1e-5):
    """x: [..., D]; w: [D] -> x's dtype and shape. On the card x and w are
    each fp32 or bf16; an empty x returns an empty tensor, no launch."""
    if x.shape[-1:] != w.shape:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if not _on_cuda(x, w):
        if x.is_meta:  # the dry-run's shapes-only pass
            D = w.shape[0]
            work = (x.numel() // max(D, 1), D, x.element_size())
            axes = ("batch", "act_seq")
            return _meta_call(
                ("rmsnorm", kernel_work("rmsnorm", *work), axes),
                lambda: torch.empty_like(x), (x, w),
                ("rmsnorm_bwd", kernel_work("rmsnorm_bwd", *work), axes))
        return ref.rmsnorm_ref(x, w, eps)
    _check_kernel_dtype("rmsnorm", x)
    if w.dtype not in KERNEL_DTYPES or not w.is_contiguous():
        raise TypeError(f"rmsnorm: w must be contiguous fp32/bf16: {w.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"rmsnorm kernel needs a contiguous x: {x.stride()}")
    if not x.numel():
        return torch.empty_like(x)
    if _needs_grad(x, w):
        if w.shape[0] > _rn.BWD_MAX_D:
            raise NotImplementedError(
                f"rmsnorm backward kernel takes D up to {_rn.BWD_MAX_D}: "
                f"D {w.shape[0]}; its inputs require grad")
        return _RmsnormFn.apply(x, w, eps)
    out = _rn.launch(x, w, eps)
    LAUNCHES["rmsnorm"] += 1
    return out


def segment_run_starts(segment_ids):
    """[B, S] int segment ids -> int32 [B, S]: the index where each
    position's run of equal ids begins (a few device ops, no host sync).
    The flash kernel starts a q-tile's key sweep at its first row's run
    start; a packed forward builds this once for all its layers."""
    B, S = segment_ids.shape
    pos = torch.arange(S, device=segment_ids.device).expand(B, S)
    new = torch.ones((B, S), dtype=torch.bool, device=segment_ids.device)
    new[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    return torch.cummax(torch.where(new, pos, 0), dim=1).values.to(torch.int32)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, segment_ids=None,
                    segment_starts=None, sq_real: Optional[int] = None,
                    skv_real: Optional[int] = None, prior_k=None,
                    prior_v=None, prior_valid=None):
    """q: [B,Sq,H,hd]; k: [B,Skv,Hkv,hd]; v: [B,Skv,Hkv,hdv] -> [B,Sq,H,hdv].

    ``hdv`` is ``hd`` but for MLA's prefill (q/k 192, v 128); the scale
    stays ``1/sqrt(hd)``, and a prior or segment ids need ``hdv == hd``.

    ``segment_ids``: optional [B, S] int packed-prefill ids (Sq == Skv,
    pads -1) forbidding cross-segment attention. Each id must form one
    contiguous run of its row, the pad run last (how a packed row is
    written): the kernel skips the key tiles before a q-tile's first run
    and does not check this (a check would sync the device); the plain
    version masks by id equality alone. ``segment_starts``: optional int32
    [B, S] :func:`segment_run_starts` of the ids, built here when absent
    (the plain version does not read it). ``sq_real``/``skv_real``
    mask query rows / keys at or past them (default: the full lengths).
    ``prior_k``/``prior_v`` [B,Pp,Hkv,hd] with ``prior_valid`` [B] int32:
    a cached prefix the queries attend to first (suffix prefill; query i of
    row b sits at absolute position ``prior_valid[b] + i``). Segment ids
    and a prior exclude each other.
    """
    B, Sq, H, hd = q.shape
    if (k.ndim != 4 or v.ndim != 4 or k.shape[:3] != v.shape[:3]
            or k.shape[0] != B or k.shape[3] != hd):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    Skv, Hkv, hdv = k.shape[1], k.shape[2], v.shape[3]
    if H % Hkv:
        raise ValueError(f"flash_attention: H={H} not a multiple of Hkv={Hkv}")
    if segment_ids is not None and (Sq != Skv
                                    or tuple(segment_ids.shape) != (B, Sq)):
        raise ValueError(f"flash_attention: segment_ids must be [B, S] with "
                         f"Sq == Skv: {tuple(segment_ids.shape)}")
    if segment_starts is not None and (
            segment_ids is None or segment_starts.shape != segment_ids.shape):
        raise ValueError("flash_attention: segment_starts goes with "
                         "segment_ids, in its shape")
    prior = (prior_k, prior_v, prior_valid)
    if hdv != hd and (segment_ids is not None
                      or any(t is not None for t in prior)):
        raise ValueError(f"flash_attention: a prior or segment ids need v's "
                         f"head dim {hdv} == q's {hd}")
    if any(t is not None for t in prior):
        if any(t is None for t in prior) or segment_ids is not None:
            raise ValueError("flash_attention: prior_k, prior_v and "
                             "prior_valid go together, without segment_ids")
        if (prior_k.ndim != 4 or prior_k.shape != prior_v.shape
                or prior_k.shape[0] != B or prior_k.shape[2:] != k.shape[2:]
                or tuple(prior_valid.shape) != (B,)):
            raise ValueError(f"flash_attention: prior {tuple(prior_k.shape)}, "
                             f"prior_valid {tuple(prior_valid.shape)}")
    sq_real = Sq if sq_real is None else int(sq_real)
    skv_real = Skv if skv_real is None else int(skv_real)
    if not (0 <= sq_real <= Sq and 0 <= skv_real <= Skv):
        raise ValueError(f"flash_attention: sq_real={sq_real}, "
                         f"skv_real={skv_real} outside [0, {Sq}] / [0, {Skv}]")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    tensors = [q, k, v] + [t for t in (segment_ids, *prior) if t is not None]
    if not _on_cuda(*tensors):
        if q.is_meta:  # the dry-run's shapes-only pass
            dims = dict(B=B, H=H, Hkv=Hkv, hd=hd, hdv=hdv,
                        isz=q.element_size())
            axes = ("batch", "heads")
            fwd = kernel_work("flash_attention", Sq=Sq, Skv=Skv, causal=causal,
                              window=window,
                              prior=0 if prior_k is None else prior_k.shape[1],
                              segments=segment_ids is not None, **dims)
            bwd = None  # packed and suffix prefill are serving paths
            if segment_ids is None and prior_k is None:
                bwd = ("flash_attention_bwd", kernel_work(
                    "flash_attention_bwd", S=Sq, Skv=Skv, causal=causal,
                    window=window, **dims), axes)
            return _meta_call(
                ("flash_attention", fwd, axes),
                lambda: torch.empty((B, Sq, H, hdv), dtype=q.dtype,
                                    device="meta"),
                tensors, bwd)
        return ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, scale=scale,
            segment_ids=segment_ids, sq_real=sq_real, skv_real=skv_real,
            prior_k=prior_k, prior_v=prior_v, prior_valid=prior_valid)
    kv = (k, v) if prior_k is None else (k, v, prior_k, prior_v)
    _check_kernel_dtype("flash_attention", q, *kv)
    _check_last_dim_contiguous("flash_attention", q, *kv)
    _check_rows_aligned("flash_attention", *kv)
    if (hd, hdv) not in _fa.HEAD_DIM_PAIRS:
        raise ValueError(f"flash_attention kernel head dims (q/k, v) "
                         f"{(hd, hdv)} not in {_fa.HEAD_DIM_PAIRS}")
    if prior_valid is not None and (prior_valid.dtype != torch.int32
                                    or not prior_valid.is_contiguous()):
        raise TypeError(f"flash_attention kernel: prior_valid must be "
                        f"contiguous int32: {prior_valid.dtype}")
    if segment_ids is not None:
        if segment_starts is None:
            segment_starts = segment_run_starts(segment_ids)
        elif (segment_starts.dtype != torch.int32
              or not segment_starts.is_contiguous()
              or not _on_cuda(q, segment_starts)):
            raise TypeError(f"flash_attention kernel: segment_starts must be "
                            f"contiguous int32 on q's device: "
                            f"{segment_starts.dtype}")
    if _needs_grad(q, k, v, *kv[2:]):
        if segment_ids is not None or prior_k is not None:
            raise NotImplementedError(
                "flash_attention kernel has no backward with segment ids or "
                "a prior (packed and suffix prefill are serving paths); its "
                "inputs require grad")
        return _FlashFn.apply(q, k, v, causal, window, scale, sq_real,
                              skv_real)
    out = _fa.launch(q, k, v, causal=causal, window=window, scale=scale,
                     segment_ids=segment_ids, sq_real=sq_real,
                     skv_real=skv_real, segment_starts=segment_starts,
                     prior_k=prior_k, prior_v=prior_v,
                     prior_valid=prior_valid)
    LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q, k, v, lengths, *, scale: Optional[float] = None,
                     w_real: Optional[int] = None):
    """q: [B,1,H,hd]; k,v: [B,W,Hkv,hd] ring cache; lengths: [B] int valid
    slots per row -> [B,1,H,hd]. ``w_real`` masks slots at or past it
    (default: W)."""
    B, one, H, hd = q.shape
    if one != 1 or k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != hd or tuple(lengths.shape) != (B,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, lengths {tuple(lengths.shape)}")
    W, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"decode_attention: H={H} not a multiple of Hkv={Hkv}")
    w_real = W if w_real is None else int(w_real)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if not _on_cuda(q, k, v, lengths):
        if q.is_meta:  # the dry-run's shapes-only pass
            return _meta_call(
                ("decode_attention", kernel_work(
                    "decode_attention", B, H, Hkv, hd, B * min(W, w_real),
                    q.element_size()), ("batch", "kv_seq", "heads")),
                lambda: torch.empty_like(q), (q, k, v))
        return ref.decode_attention_ref(q, k, v, lengths, scale=scale,
                                        w_real=w_real)
    _refuse_grad("decode_attention", SERVING_ONLY, q, k, v)
    _check_kernel_dtype("decode_attention", q, k, v)
    _check_last_dim_contiguous("decode_attention", q, k, v)
    _check_rows_aligned("decode_attention", k, v)
    if hd not in _dec.HEAD_DIMS:
        raise ValueError(f"decode_attention kernel: head_dim {hd} not in "
                         f"{_dec.HEAD_DIMS}")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError(f"decode_attention kernel: lengths must be contiguous "
                        f"int32: {lengths.dtype}")
    out = _dec.launch(q, k, v, lengths, scale=scale, w_real=w_real)
    LAUNCHES["decode_attention"] += 1
    return out


def paged_decode_attention(q, k_blocks, v_blocks, page_table, lengths, *,
                           scale: Optional[float] = None):
    """q: [B,1,H,hd]; k_blocks, v_blocks: [N,page,Hkv,hd] block pool;
    page_table: [B,n_pages] int32 (logical page j of row b lives in block
    ``page_table[b, j]``); lengths: [B] int32 valid positions per row ->
    [B,1,H,hd]. Positions at or past ``n_pages * page`` are masked, as the
    JAX wrapper's ``w_real``."""
    B, one, H, hd = q.shape
    if one != 1 or k_blocks.ndim != 4 or k_blocks.shape != v_blocks.shape \
            or k_blocks.shape[3] != hd or page_table.ndim != 2 \
            or page_table.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, blocks "
                         f"{tuple(k_blocks.shape)}, page_table "
                         f"{tuple(page_table.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    Hkv = k_blocks.shape[2]
    if H % Hkv:
        raise ValueError(f"paged_decode_attention: H={H} not a multiple of "
                         f"Hkv={Hkv}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if not _on_cuda(q, k_blocks, v_blocks, page_table, lengths):
        if q.is_meta:  # the dry-run's shapes-only pass
            pos = B * page_table.shape[1] * k_blocks.shape[1]
            return _meta_call(
                ("paged_decode_attention", kernel_work(
                    "paged_decode_attention", B, H, Hkv, hd, pos,
                    table=page_table.numel(), isz=q.element_size()),
                 ("batch", "kv_seq", "heads")),
                lambda: torch.empty_like(q), (q, k_blocks, v_blocks))
        return ref.paged_decode_attention_ref(q, k_blocks, v_blocks,
                                              page_table, lengths, scale=scale)
    _refuse_grad("paged_decode_attention", SERVING_ONLY, q, k_blocks, v_blocks)
    _check_kernel_dtype("paged_decode_attention", q, k_blocks, v_blocks)
    _check_last_dim_contiguous("paged_decode_attention", q, k_blocks, v_blocks)
    _check_rows_aligned("paged_decode_attention", k_blocks, v_blocks)
    if hd not in _pdec.HEAD_DIMS:
        raise ValueError(f"paged_decode_attention kernel: head_dim {hd} not in "
                         f"{_pdec.HEAD_DIMS}")
    page = k_blocks.shape[1]
    if any(t.stride(0) != page * t.stride(1) for t in (k_blocks, v_blocks)):
        raise ValueError(f"paged_decode_attention kernel needs evenly spaced "
                         f"block rows (a block's stride page times a row's): "
                         f"{k_blocks.stride()}, {v_blocks.stride()}")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"paged_decode_attention kernel: {name} must be "
                            f"contiguous int32: {t.dtype}")
    out = _pdec.launch(q, k_blocks, v_blocks, page_table, lengths, scale=scale)
    LAUNCHES["paged_decode_attention"] += 1
    return out


def _check_mla(name, q_lat, q_rope, ckv, krope, valid_len, lead):
    """Shapes shared by the ring and paged MLA decode ops: ``lead`` is the
    latent leaves' leading dims ([B, W] or [N, page])."""
    B, one, H, r = q_lat.shape
    if (one != 1 or q_rope.ndim != 4 or q_rope.shape[:3] != q_lat.shape[:3]
            or ckv.ndim != 3 or krope.ndim != 3
            or tuple(ckv.shape) != (*lead, r)
            or tuple(krope.shape) != (*lead, q_rope.shape[3])
            or tuple(valid_len.shape) != (B,)):
        raise ValueError(f"{name}: q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, ckv {tuple(ckv.shape)}, "
                         f"krope {tuple(krope.shape)}, valid_len "
                         f"{tuple(valid_len.shape)}")


def _check_mla_kernel(name, q_lat, q_rope, ckv, krope, valid_len):
    _check_kernel_dtype(name, q_lat, q_rope, ckv, krope)
    _check_last_dim_contiguous(name, q_lat, q_rope, ckv, krope)
    _check_rows_aligned(name, ckv, krope)
    H, dims = q_lat.shape[2], (ckv.shape[-1], krope.shape[-1])
    if dims not in _mla.LATENT_DIMS or H % _mla.HEAD_BLOCK:
        raise ValueError(f"{name} kernel: (latent, rope) dims {dims} not in "
                         f"{_mla.LATENT_DIMS}, or {H} heads not a multiple "
                         f"of {_mla.HEAD_BLOCK}")
    if valid_len.dtype != torch.int32 or not valid_len.is_contiguous():
        raise TypeError(f"{name} kernel: valid_len must be contiguous int32: "
                        f"{valid_len.dtype}")


def mla_decode_attention(q_lat, q_rope, ckv, krope, valid_len, *,
                         scale: float):
    """Absorbed MLA decode over the latent ring: q_lat [B,1,H,r] (the
    query's nope half through W_UK), q_rope [B,1,H,dr] (its RoPE half),
    ckv [B,W,r], krope [B,W,dr]; valid_len [B] int, slots at or past it
    (or W) masked -> [B,1,H,r], the probability-weighted latent rows (see
    :func:`ref.mla_decode_attention_ref`)."""
    B, W = ckv.shape[:2]
    _check_mla("mla_decode_attention", q_lat, q_rope, ckv, krope, valid_len,
               (B, W))
    if not _on_cuda(q_lat, q_rope, ckv, krope, valid_len):
        if q_lat.is_meta:  # the dry-run's shapes-only pass
            return _meta_call(
                ("mla_decode_attention", kernel_work(
                    "mla_decode_attention", B, q_lat.shape[2], ckv.shape[2],
                    krope.shape[2], B * W, ckv.element_size()),
                 ("batch", "kv_seq", "heads")),
                lambda: torch.empty_like(q_lat), (q_lat, q_rope, ckv, krope))
        return ref.mla_decode_attention_ref(
            q_lat, q_rope, ckv, krope, valid_len.clamp(max=W), scale=scale)
    _refuse_grad("mla_decode_attention", SERVING_ONLY, q_lat, q_rope, ckv,
                 krope)
    _check_mla_kernel("mla_decode_attention", q_lat, q_rope, ckv, krope,
                      valid_len)
    out = _mla.launch(q_lat, q_rope, ckv, krope, valid_len, scale=scale)
    LAUNCHES["mla_decode_attention"] += 1
    return out


def paged_mla_decode_attention(q_lat, q_rope, ckv_blocks, krope_blocks,
                               page_table, valid_len, *, scale: float):
    """:func:`mla_decode_attention` through a page table: ckv_blocks
    [N,page,r], krope_blocks [N,page,dr] (the latent block pool);
    page_table [B,n_pages] int32; positions at or past ``n_pages * page``
    are masked. Nothing is gathered on the card."""
    if page_table.ndim != 2 or page_table.shape[0] != q_lat.shape[0]:
        raise ValueError(f"paged_mla_decode_attention: page_table "
                         f"{tuple(page_table.shape)}, q_lat "
                         f"{tuple(q_lat.shape)}")
    _check_mla("paged_mla_decode_attention", q_lat, q_rope, ckv_blocks,
               krope_blocks, valid_len, ckv_blocks.shape[:2])
    if not _on_cuda(q_lat, q_rope, ckv_blocks, krope_blocks, page_table,
                    valid_len):
        if q_lat.is_meta:  # the dry-run's shapes-only pass
            B = q_lat.shape[0]
            return _meta_call(
                ("paged_mla_decode_attention", kernel_work(
                    "paged_mla_decode_attention", B, q_lat.shape[2],
                    ckv_blocks.shape[2], krope_blocks.shape[2],
                    B * page_table.shape[1] * ckv_blocks.shape[1],
                    ckv_blocks.element_size(), page_table.numel()),
                 ("batch", "kv_seq", "heads")),
                lambda: torch.empty_like(q_lat),
                (q_lat, q_rope, ckv_blocks, krope_blocks))
        return ref.paged_mla_decode_attention_ref(
            q_lat, q_rope, ckv_blocks, krope_blocks, page_table, valid_len,
            scale=scale)
    name = "paged_mla_decode_attention"
    _refuse_grad(name, SERVING_ONLY, q_lat, q_rope, ckv_blocks, krope_blocks)
    _check_mla_kernel(name, q_lat, q_rope, ckv_blocks, krope_blocks,
                      valid_len)
    page = ckv_blocks.shape[1]
    if any(t.stride(0) != page * t.stride(1)
           for t in (ckv_blocks, krope_blocks)):
        raise ValueError(f"{name} kernel needs evenly spaced block rows: "
                         f"{ckv_blocks.stride()}, {krope_blocks.stride()}")
    if page_table.dtype != torch.int32 or not page_table.is_contiguous():
        raise TypeError(f"{name} kernel: page_table must be contiguous "
                        f"int32: {page_table.dtype}")
    out = _mla.launch_paged(q_lat, q_rope, ckv_blocks, krope_blocks,
                            page_table, valid_len, scale=scale)
    LAUNCHES[name] += 1
    return out


def ssd_scan(x, dt, A, B, C, *, chunk: int):
    """Chunked Mamba-2 SSD scan from a zero state, in the model's layout.

    x: [b,S,nh,hd]; dt: [b,S,nh] (post-softplus); A: [nh] (negative); B, C:
    [b,S,1,ds] (one group) -> (y [b,S,nh,hd] in x's dtype, final_state
    [b,nh,hd,ds] fp32). The plain version chunks by ``min(chunk, S)`` as the
    JAX model does; the fp32 kernel keeps ``chunk``, the bf16 kernels their
    own chunk of 64 positions, and both mask the ragged tail (the result
    does not depend on the chunk length, up to rounding). On the card,
    inputs that require grad run through :class:`_SsdScanFn`, whose
    backward kernel gives y's gradient to x, dt, A, B and C; the final
    state takes none.
    """
    b, S, nh, hd = x.shape
    if (dt.shape != (b, S, nh) or A.shape != (nh,) or B.ndim != 4
            or B.shape != C.shape or B.shape[:3] != (b, S, 1) or S == 0):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}")
    if not _on_cuda(x, dt, A, B, C):
        if x.is_meta:  # the dry-run's shapes-only pass
            ds, isz = B.shape[-1], x.element_size()
            axes = ("batch", "ssm_heads")
            return _meta_call(
                ("ssd_scan",
                 kernel_work("ssd_scan", b, S, nh, hd, ds, chunk, isz), axes),
                lambda: (torch.empty_like(x),
                         torch.empty((b, nh, hd, ds), dtype=torch.float32,
                                     device="meta")),
                (x, dt, A, B, C),
                ("ssd_scan_bwd", kernel_work("ssd_scan_bwd", b, S, nh, hd, ds,
                                             isz), axes))
        return ref.ssd_scan_ref(x, dt, A, B, C, chunk)
    _check_kernel_dtype("ssd_scan", x, B, C)
    _check_last_dim_contiguous("ssd_scan", x, B, C)
    _check_rows_aligned("ssd_scan", x, B, C)
    if dt.dtype != torch.float32 or A.dtype != torch.float32 \
            or not A.is_contiguous():
        raise TypeError(f"ssd_scan kernel: dt and A must be fp32 (A "
                        f"contiguous): {dt.dtype}, {A.dtype}")
    if B.shape[-1] not in _ssd.STATE_DIMS:
        raise ValueError(f"ssd_scan kernel: d_state {B.shape[-1]} not in "
                         f"{_ssd.STATE_DIMS}")
    if x.dtype == torch.bfloat16:
        if hd not in _ssd.BF16_HEAD_DIMS:
            raise ValueError(f"ssd_scan bf16 kernel: head_dim {hd} not in "
                             f"{_ssd.BF16_HEAD_DIMS}")
    elif hd % _ssd.COLS or chunk % _ssd.TILE \
            or not 0 < chunk <= _ssd.MAX_CHUNK:
        raise ValueError(f"ssd_scan fp32 kernel: head_dim {hd} not a multiple "
                         f"of {_ssd.COLS}, or chunk {chunk} not a multiple of "
                         f"{_ssd.TILE} up to {_ssd.MAX_CHUNK}")
    if _needs_grad(x, dt, A, B, C):
        if x.dtype != torch.bfloat16 and hd not in _ssd.BWD_HEAD_DIMS:
            raise NotImplementedError(
                f"ssd_scan fp32 backward kernel takes head_dim in "
                f"{_ssd.BWD_HEAD_DIMS}: {hd}; its inputs require grad")
        return _SsdScanFn.apply(x, dt, A, B, C, chunk)
    y, state = _ssd.launch(x, dt, A, B, C, chunk=chunk)
    LAUNCHES["ssd_scan"] += 1
    return y, state
