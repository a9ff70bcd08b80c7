"""Public kernel entry points of the port, in the model's layouts.

Each op dispatches on the device of the tensors it is given:

* CPU tensors take the plain PyTorch version (:mod:`repro_torch.kernels.ref`);
* CUDA tensors launch the hand-written Hopper kernel, or raise. There is no
  fallback from a CUDA tensor to the plain version.

Each op checks device, dtype, shape and contiguity before launching, and
counts its kernel launches in :data:`LAUNCHES` (plain-version calls are not
counted), so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches since the last reset_launches(); only a CUDA launch counts
LAUNCHES: dict[str, int] = {"rmsnorm": 0, "flash_attention": 0,
                            "decode_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors) -> bool:
    """True when every tensor is on one CUDA device, False when every one
    is on the CPU; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors must all be on one CUDA device or all on the "
                     f"CPU: {[str(t.device) for t in tensors]}")


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
    """The attention kernels load K/V rows as 16-byte vectors."""
    for t in tensors:
        isz = t.element_size()
        if t.data_ptr() % 16 or any(s * isz % 16 for s in t.stride()[:-1]):
            raise ValueError(f"{name} kernel needs 16-byte-aligned K/V rows: "
                             f"strides {t.stride()}, offset {t.storage_offset()}")


# --------------------------------------------------------------------------- #
def rmsnorm(x, w, *, eps: float = 1e-5):
    """x: [..., D]; w: [D] -> x's dtype and shape."""
    if x.shape[-1:] != w.shape:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if not _on_cuda(x, w):
        return ref.rmsnorm_ref(x, w, eps)
    _check_kernel_dtype("rmsnorm", x)
    if w.dtype not in KERNEL_DTYPES or not w.is_contiguous():
        raise TypeError(f"rmsnorm: w must be contiguous fp32/bf16: {w.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"rmsnorm kernel needs a contiguous x: {x.stride()}")
    x2 = x.reshape(-1, x.shape[-1])
    out = _rn.launch(x2, w, eps)
    LAUNCHES["rmsnorm"] += 1
    return out.reshape(x.shape)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, segment_ids=None,
                    sq_real: Optional[int] = None,
                    skv_real: Optional[int] = None):
    """q: [B,Sq,H,hd]; k,v: [B,Skv,Hkv,hd] -> [B,Sq,H,hd].

    ``segment_ids``: optional [B, S] int packed-prefill ids (Sq == Skv,
    pads -1) forbidding cross-segment attention. ``sq_real``/``skv_real``
    mask query rows / keys at or past them (default: the full lengths).
    """
    B, Sq, H, hd = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"flash_attention: H={H} not a multiple of Hkv={Hkv}")
    if segment_ids is not None and (Sq != Skv
                                    or tuple(segment_ids.shape) != (B, Sq)):
        raise ValueError(f"flash_attention: segment_ids must be [B, S] with "
                         f"Sq == Skv: {tuple(segment_ids.shape)}")
    sq_real = Sq if sq_real is None else int(sq_real)
    skv_real = Skv if skv_real is None else int(skv_real)
    if not (0 <= sq_real <= Sq and 0 <= skv_real <= Skv):
        raise ValueError(f"flash_attention: sq_real={sq_real}, "
                         f"skv_real={skv_real} outside [0, {Sq}] / [0, {Skv}]")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    tensors = (q, k, v) if segment_ids is None else (q, k, v, segment_ids)
    if not _on_cuda(*tensors):
        return ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, scale=scale,
            segment_ids=segment_ids, sq_real=sq_real, skv_real=skv_real)
    _check_kernel_dtype("flash_attention", q, k, v)
    _check_last_dim_contiguous("flash_attention", q, k, v)
    _check_rows_aligned("flash_attention", k, v)
    if hd not in _fa.HEAD_DIMS:
        raise ValueError(f"flash_attention kernel head_dim {hd} not in "
                         f"{_fa.HEAD_DIMS}")
    out = _fa.launch(q, k, v, causal=causal, window=window, scale=scale,
                     segment_ids=segment_ids, sq_real=sq_real,
                     skv_real=skv_real)
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
        return ref.decode_attention_ref(q, k, v, lengths, scale=scale,
                                        w_real=w_real)
    _check_kernel_dtype("decode_attention", q, k, v)
    _check_last_dim_contiguous("decode_attention", q, k, v)
    _check_rows_aligned("decode_attention", k, v)
    if hd not in _dec.HEAD_DIMS or H // Hkv > _dec.MAX_GROUP:
        raise ValueError(f"decode_attention kernel: head_dim {hd} not in "
                         f"{_dec.HEAD_DIMS} or group {H // Hkv} > "
                         f"{_dec.MAX_GROUP}")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError(f"decode_attention kernel: lengths must be contiguous "
                        f"int32: {lengths.dtype}")
    out = _dec.launch(q, k, v, lengths, scale=scale, w_real=w_real)
    LAUNCHES["decode_attention"] += 1
    return out
