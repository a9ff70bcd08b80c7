"""Plain PyTorch versions of the port's kernels.

Each function computes what its hand-written Hopper kernel computes, in
straightforward tensor code: the CPU path of :mod:`repro_torch.kernels.ops`
and the reference the kernels are held against on the card. They transcribe
the JAX package's ``kernels/ref.py`` oracles, plus the arguments the TPU
kernels take that those oracles lack (``sq_real``/``skv_real``, segment ids,
``w_real``, per-row lengths). Masking uses NEG_INF = -1e30, not -inf, so a
masked term contributes exactly ``exp(-1e30 - m) == 0`` and packed segments
stay bitwise independent of each other; probabilities are zeroed where
masked and the row sum is floored at 1e-30, so a fully masked row (an empty
decode slot) returns zeros, not NaN.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def rmsnorm_ref(x, w, eps: float = 1e-5):
    """x: [..., D]; w: [D] -> x's dtype. fp32 mean of squares, the
    normalised row cast to x's dtype BEFORE the ``* w`` (bf16 rounding
    order of the JAX model)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    return (y.float() * w.float()).to(x.dtype)


def _softmax_rows(s, mask):
    """Masked online-softmax result in closed form: exp(s - max) zeroed
    where masked, normalised by the row sum floored at 1e-30."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None,
                        segment_ids=None, sq_real: Optional[int] = None,
                        skv_real: Optional[int] = None):
    """q: [B,Sq,H,hd]; k,v: [B,Skv,Hkv,hd] -> [B,Sq,H,hd] in q's dtype.

    GQA: query head h reads KV head h // G. ``segment_ids`` [B, S]
    (Sq == Skv, pads -1) forbids attention across segments. Rows at or past
    ``sq_real`` and keys at or past ``skv_real`` are masked.
    """
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    sq_real = Sq if sq_real is None else sq_real
    skv_real = Skv if skv_real is None else skv_real
    qg = q.float().reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Skv, device=q.device)[None, :]
    mask = (qi < sq_real) & (ki < skv_real)
    if causal:
        mask = mask & (qi >= ki)
    if window > 0:
        mask = mask & (ki > qi - window)
    mask = mask[None, None, None]  # [1,1,1,Sq,Skv]
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        smask = seg[:, :, None] == seg[:, None, :]  # [B,Sq,Skv]
        mask = mask & smask[:, None, None]
    p = _softmax_rows(s, mask)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention_ref(q, k, v, lengths, *, scale: Optional[float] = None,
                         w_real: Optional[int] = None):
    """q: [B,1,H,hd]; k,v: [B,W,Hkv,hd]; lengths: [B] int -> [B,1,H,hd].

    Row b attends to ring slots ``kpos < lengths[b]`` and ``kpos < w_real``;
    a row of length 0 returns zeros.
    """
    B, _, H, hd = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    w_real = W if w_real is None else w_real
    qg = q.float().reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    kpos = torch.arange(W, device=q.device)[None, :]
    valid = (kpos < lengths.to(torch.int64)[:, None]) & (kpos < w_real)
    p = _softmax_rows(s, valid[:, None, None, :])
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)
