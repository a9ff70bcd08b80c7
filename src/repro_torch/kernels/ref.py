"""Plain PyTorch versions of the port's kernels.

Each function computes what its hand-written Hopper kernel computes, in
straightforward tensor code: the CPU path of :mod:`repro_torch.kernels.ops`
and the reference the kernels are held against on the card. They transcribe
the JAX package's ``kernels/ref.py`` oracles, plus the arguments the TPU
kernels take that those oracles lack (``sq_real``/``skv_real``, segment ids,
``w_real``, per-row lengths, a prior KV for suffix prefill); the SSD scan
transcribes the JAX model's chunked ``ssd_chunked``, the function the JAX
model runs where its Pallas kernel stands beside it. Masking uses
NEG_INF = -1e30, not -inf, so a masked term contributes exactly
``exp(-1e30 - m) == 0`` and packed segments stay bitwise independent of
each other; probabilities are zeroed where masked and the row sum is
floored at 1e-30, so a fully masked row (an empty decode slot) returns
zeros, not NaN.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def preprocess_ref(x_u8, mean, std, out_dtype=torch.bfloat16):
    """x_u8: [..., D] uint8; mean, std: [D] fp32 -> [..., D] out_dtype:
    ``(x / 255 - mean) / std`` in fp32, then the cast (the JAX oracle's
    order: it divides by 255 where the kernel multiplies by fp32(1/255))."""
    x = x_u8.to(torch.float32) / 255.0
    return ((x - mean) / std).to(out_dtype)


def rmsnorm_ref(x, w, eps: float = 1e-5):
    """x: [..., D]; w: [D] -> x's dtype. fp32 mean of squares, the
    normalised row cast to x's dtype BEFORE the ``* w`` (bf16 rounding
    order of the JAX model)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    return (y.float() * w.float()).to(x.dtype)


def rmsnorm_bwd_ref(x, w, dy, eps: float = 1e-5):
    """(dx, dw): the gradients of :func:`rmsnorm_ref`'s output given dy
    (its shape and dtype), by ``torch.autograd.grad`` through it -- the
    plain version the rmsnorm backward kernel is held against."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        wg = w.detach().requires_grad_(True)
        dx, dw = torch.autograd.grad(rmsnorm_ref(xg, wg, eps), (xg, wg), dy)
    return dx, dw


def _softmax_rows(s, mask):
    """Masked online-softmax result in closed form: exp(s - max) zeroed
    where masked, normalised by the row sum floored at 1e-30."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _masked_lse(s, mask):
    """The row's log-sum-exp over its unmasked scores, ``max + log(l)``
    as the kernels form it; -inf for a row with none (whose output is 0)."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    l = torch.where(mask, torch.exp(s - m[..., None]),
                    torch.zeros_like(s)).sum(dim=-1)
    return torch.where(l > 0, m + torch.log(l), torch.full_like(m, -math.inf))


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None,
                        segment_ids=None, sq_real: Optional[int] = None,
                        skv_real: Optional[int] = None, prior_k=None,
                        prior_v=None, prior_valid=None):
    """q: [B,Sq,H,hd]; k: [B,Skv,Hkv,hd]; v: [B,Skv,Hkv,hdv] -> [B,Sq,H,hdv]
    in q's dtype (hdv == hd but for MLA's prefill; the scale stays
    1/sqrt(hd)).

    GQA: query head h reads KV head h // G. ``segment_ids`` [B, S]
    (Sq == Skv, pads -1) forbids attention across segments. Rows at or past
    ``sq_real`` and keys at or past ``skv_real`` are masked.

    ``prior_k``/``prior_v`` [B,Pp,Hkv,hd] and ``prior_valid`` [B] make it a
    suffix prefill over a cached prefix, with the mask of the JAX package's
    ``chunked_attention``: row b's prior columns below ``prior_valid[b]``
    are visible to every query (they precede it), its suffix columns are
    causal relative to the suffix, and query i sits at absolute position
    ``prior_valid[b] + i`` for the window test.
    """
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    sq_real = Sq if sq_real is None else sq_real
    skv_real = Skv if skv_real is None else skv_real
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Skv, device=q.device)[None, :]
    mask = (qi < sq_real) & (ki < skv_real)
    if causal:
        mask = mask & (qi >= ki)
    if window > 0:
        mask = mask & (ki > qi - window)
    mask = mask[None].expand(B, Sq, Skv)
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        mask = mask & (seg[:, :, None] == seg[:, None, :])
    if prior_k is not None:
        Pp = prior_k.shape[1]
        pv = prior_valid.to(torch.int64)[:, None, None]  # [B,1,1]
        col = torch.arange(Pp, device=q.device)[None, None, :]
        pmask = (col < pv) & (qi < sq_real)[None]
        if window > 0:
            pmask = pmask & (col > pv + qi[None] - window)
        mask = torch.cat([pmask, mask], dim=-1)
        k = torch.cat([prior_k.to(k.dtype), k], dim=1)
        v = torch.cat([prior_v.to(v.dtype), v], dim=1)
    qg = q.float().reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    p = _softmax_rows(s, mask[:, None, None])
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, do, **kw):
    """(dq, dk, dv): the gradients of :func:`flash_attention_ref`'s output
    given do (its shape and dtype), by ``torch.autograd.grad`` through it
    with the same keyword arguments -- the plain version the flash
    backward kernel is held against."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention_ref(*qkv, **kw)
        return torch.autograd.grad(o, qkv, do)


def decode_attention_ref(q, k, v, lengths, *, scale: Optional[float] = None,
                         w_real: Optional[int] = None, return_lse: bool = False):
    """q: [B,1,H,hd]; k,v: [B,W,Hkv,hd]; lengths: [B] int -> [B,1,H,hd].

    Row b attends to ring slots ``kpos < lengths[b]`` and ``kpos < w_real``;
    a row of length 0 returns zeros. ``return_lse`` also returns each
    (row, head)'s log-sum-exp of its scaled scores, fp32 [B,H] (-inf for a
    row with no valid slot), as the kernel's ``lse`` output.
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
    o = o.reshape(B, 1, H, hd).to(q.dtype)
    if not return_lse:
        return o
    return o, _masked_lse(s, valid[:, None, None, :]).reshape(B, H)


def paged_decode_attention_ref(q, k_blocks, v_blocks, page_table, lengths, *,
                               scale: Optional[float] = None):
    """q: [B,1,H,hd]; k_blocks, v_blocks: [N,page,Hkv,hd] block pool;
    page_table: [B,n_pages] int; lengths: [B] int -> [B,1,H,hd].

    Gathers each row's pages (ids clamped into the pool, like the JAX
    gather's ``mode="clip"``) into a dense ``n_pages * page`` cache and
    runs the ring version on it, ``w_real`` = that width.
    """
    B, n_pages = page_table.shape
    page = k_blocks.shape[1]
    idx = page_table.to(torch.int64).clamp(0, k_blocks.shape[0] - 1)
    dense = [blk[idx].reshape((B, n_pages * page) + tuple(blk.shape[2:]))
             for blk in (k_blocks, v_blocks)]
    return decode_attention_ref(q, dense[0], dense[1], lengths, scale=scale,
                                w_real=n_pages * page)


def mla_decode_attention_ref(q_lat, q_rope, ckv, krope, valid_len, *,
                             scale: float, return_lse: bool = False):
    """Absorbed MLA decode: q_lat [B,1,H,r], q_rope [B,1,H,dr] against the
    latent ring ckv [B,W,r] and the shared RoPE key krope [B,W,dr];
    valid_len [B] int -> [B,1,H,r] in ckv's dtype.

    The JAX package's ``mla_decode_update`` ``attend`` plus its
    normalisation: score = ``q_lat . ckv + q_rope . krope`` in fp32, times
    ``scale``; slots at or past ``valid_len[b]`` masked; ``e = exp(s -
    max)``, zero where masked, ``l`` its fp32 sum; the value sum of ``e``
    cast to the cache dtype (JAX's order in bf16) against ``ckv``, cast to
    that dtype, divided by ``l`` floored at 1e-30 (a row of length 0 gives
    zeros). Slot order is not position order in a wrapped ring; the sum
    does not care. ``return_lse`` also returns each (row, head)'s
    log-sum-exp of its scaled scores, fp32 [B,H] (-inf for a row with no
    valid slot), as the kernel's ``lse`` output.
    """
    W = ckv.shape[1]
    s = (torch.einsum("bhr,bkr->bhk", q_lat[:, 0].float(), ckv.float())
         + torch.einsum("bhd,bkd->bhk", q_rope[:, 0].float(), krope.float()))
    s = s * scale
    valid = (torch.arange(W, device=ckv.device)[None, :]
             < valid_len.to(torch.int64)[:, None])[:, None, :]  # [B,1,W]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    e = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                    torch.zeros_like(s))
    l = e.sum(dim=-1)  # [B,H]
    ctx = torch.einsum("bhk,bkr->bhr", e.to(ckv.dtype).float(),
                       ckv.float()).to(ckv.dtype)
    out = ctx / l.clamp_min(1e-30).to(ckv.dtype)[..., None]
    if not return_lse:
        return out[:, None]
    return out[:, None], _masked_lse(s, valid)


def paged_mla_decode_attention_ref(q_lat, q_rope, ckv_blocks, krope_blocks,
                                   page_table, valid_len, *, scale: float):
    """:func:`mla_decode_attention_ref` through a page table: ckv_blocks
    [N,page,r], krope_blocks [N,page,dr]; page_table [B,n_pages] int
    (slot t of row b in block ``page_table[b, t // page]``, ids clamped
    into the pool as the JAX gather's ``mode="clip"``); positions at or
    past ``n_pages * page`` are masked."""
    B, n_pages = page_table.shape
    page = ckv_blocks.shape[1]
    idx = page_table.to(torch.int64).clamp(0, ckv_blocks.shape[0] - 1)
    dense = [blk[idx].reshape(B, n_pages * page, blk.shape[-1])
             for blk in (ckv_blocks, krope_blocks)]
    return mla_decode_attention_ref(
        q_lat, q_rope, dense[0], dense[1],
        valid_len.clamp(max=n_pages * page), scale=scale)


def ssd_scan_ref(x, dt, A, B, C, chunk: int):
    """Chunked Mamba-2 SSD scan from a zero state, in the model's layout.

    x: [b,S,nh,hd]; dt: [b,S,nh] (post-softplus); A: [nh] (negative);
    B, C: [b,S,1,ds]. Returns (y [b,S,nh,hd] in x's dtype, final_state
    [b,nh,hd,ds] fp32): h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t =
    C_t . h_t.

    The JAX model's ``ssd_chunked`` after ``mamba_forward``'s padding rule:
    chunks of ``min(chunk, S)`` with the sequence zero-padded to a multiple
    (a padded position has dt = 0: no decay, no input), then three passes
    -- each chunk's own contribution to the state, the recurrence over
    chunk summaries, and each chunk's output from its L x L decay-masked
    C.B^T scores plus the state entering it. The scores are cast to x's
    dtype before they meet the inputs, as there. With one B/C group the
    C.B^T product is the same for every head and is computed once.
    Float64 inputs run in float64 throughout (an oracle for the fp32
    kernels where the fp32 plain version's own rounding is the larger).
    """
    b, S, nh, hd = x.shape
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = x.shape[1] // L
    xa = (x * dt[..., None]).reshape(b, nc, L, nh, hd)  # JAX's promotion
    dA = (dt * A.to(acc)).reshape(b, nc, L, nh)
    Bc = B[:, :, 0].reshape(b, nc, L, -1)
    Cc = C[:, :, 0].reshape(b, nc, L, -1)
    cums = torch.cumsum(dA, dim=2)  # [b,nc,L,nh]

    # pass 1: each chunk's contribution to the state at its end
    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)
    states = torch.einsum("bcls,bclh,bclhd->bchds", Bc.to(acc), decay_to_end,
                          xa.to(acc))
    # pass 2: the recurrence over chunk summaries
    chunk_decay = torch.exp(cums[:, :, -1, :])  # [b,nc,nh]
    carry = torch.zeros((b, nh, hd, Bc.shape[-1]), dtype=acc,
                        device=x.device)
    prev = []  # the state entering each chunk
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    # pass 3: each chunk's outputs
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        cs = cums[:, c].transpose(1, 2)  # [b,nh,L]
        seg = torch.where(tril, cs[..., :, None] - cs[..., None, :],
                          torch.full_like(tril, float("-inf"), dtype=cs.dtype))
        cb = torch.einsum("bls,bms->blm", Cc[:, c], Bc[:, c])  # [b,L,L]
        sc = (cb[:, None] * torch.exp(seg)).to(x.dtype)  # [b,nh,L,L]
        y_in = torch.einsum("bhlm,bmhd->blhd", sc.to(acc), xa[:, c].to(acc))
        y_x = torch.einsum("bls,bhds->blhd", Cc[:, c].to(acc), prev[c]) \
            * torch.exp(cums[:, c])[..., None]
        ys.append((y_in + y_x).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(b, nc * L, nh, hd)[:, :S]
    return y, carry


def ssd_scan_bwd_ref(x, dt, A, B, C, dy, chunk: int, *,
                     compute=torch.float32):
    """(dx, ddt, dA, dB, dC): the gradients of :func:`ssd_scan_ref`'s y
    given dy (the final state takes none), by ``torch.autograd.grad``
    through it on copies of the inputs in ``compute`` (fp32; float64 for
    an oracle), cast to the backward kernel's output dtypes (dx in x's,
    ddt and dA fp32, dB and dC in B's and C's) -- the plain version the
    SSD-scan backward kernel is held against."""
    with torch.enable_grad():
        ins = [t.detach().to(compute).requires_grad_(True)
               for t in (x, dt, A, B, C)]
        y, _ = ssd_scan_ref(*ins, chunk)
        dx, ddt, dA, dB, dC = torch.autograd.grad(y, ins, dy.to(compute))
    f32 = torch.float32
    return (dx.to(x.dtype), ddt.to(f32), dA.to(f32), dB.to(B.dtype),
            dC.to(C.dtype))
