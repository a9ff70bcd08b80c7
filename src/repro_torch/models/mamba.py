"""Mamba-2 block (SSD -- state-space duality, arXiv:2405.21060).

The port of the JAX package's ``models/mamba.py``. Prefill runs the chunked
SSD scan through :func:`repro_torch.kernels.ops.ssd_scan` (the hand-written
kernel on the card, where the JAX model runs its jnp ``ssd_chunked``), from a
zero state. Decode is the one-token state recurrence in plain PyTorch (the
JAX package has no kernel for it) and writes the layer's conv window and
state into its cache in place. The cache -- a ``[K-1, d_in + 2 ds]`` conv
window and an fp32 ``[nh, hd, ds]`` state per row -- has the same size
whatever the prompt length: the constant-size serving payload. A training
pass on a device mesh runs :func:`mamba_sharded`, the block split by heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.schema import ParamSpec


def mamba_schema(cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = d * s.expand
    nh = s.n_heads(d)
    conv_ch = d_in + 2 * s.d_state  # x, B, C (one B/C group)
    return {
        "in_proj": ParamSpec((d, 2 * d_in + 2 * s.d_state + nh),
                             ("embed", "ssm_in")),
        "conv_w": ParamSpec((s.d_conv, conv_ch), ("conv", "ssm_in")),
        "conv_b": ParamSpec((conv_ch,), ("ssm_in",), init="zeros"),
        "A_log": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "D": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "gate_norm": ParamSpec((d_in,), ("ssm_in",), init="ones"),
        "out_proj": ParamSpec((d_in, d), ("ssm_in", "embed")),
    }


def _split_zxbcdt(cfg, zxbcdt):
    s = cfg.ssm
    d_in = cfg.d_model * s.expand
    return torch.split(
        zxbcdt, [d_in, d_in + 2 * s.d_state, s.n_heads(cfg.d_model)], dim=-1)


def _causal_conv(xBC, w, b):
    """Depthwise causal conv1d with SiLU. xBC: [B,S,C]; w: [K,C]; fp32
    accumulation in the JAX package's order, cast back to xBC's dtype."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(K):
        out = out + pad[:, i:i + S].float() * w[i].float()
    return F.silu(out + b.float()).to(xBC.dtype)


def ssd_decode_step(x, dt, A, B, C, state):
    """One-token SSD recurrence, updating ``state`` in place.

    x: [b,1,nh,hd]; dt: [b,1,nh] fp32; A: [nh]; B, C: [b,1,1,ds]; state:
    [b,nh,hd,ds] fp32. Returns y [b,1,nh,hd] in x's dtype.
    """
    dA = torch.exp(dt[:, 0] * A)  # [b,nh]
    xa = (x * dt[..., None])[:, 0].float()  # [b,nh,hd]
    Bx = B[:, 0, 0].float()[:, None, None, :] * xa[..., None]  # [b,nh,hd,ds]
    state.mul_(dA[:, :, None, None]).add_(Bx)
    y = torch.einsum("bhds,bs->bhd", state, C[:, 0, 0].float())
    return y[:, None].to(x.dtype)


def mamba_forward(p, cfg, u, *, cache=None):
    """Full Mamba-2 block over u: [B,S,d].

    Without ``cache`` it is a prefill from a zero state and returns (out
    [B,S,d], {"conv": [B,K-1,C], "state": [B,nh,hd,ds] fp32}). With the
    layer's ``cache`` it is one decode step (S == 1) that writes the new
    conv window and state into ``cache`` in place and returns (out, cache).
    """
    s = cfg.ssm
    d_in = cfg.d_model * s.expand
    nh = s.n_heads(cfg.d_model)
    Bsz = u.shape[0]

    z, xBC, dt = _split_zxbcdt(cfg, u @ p["in_proj"])
    K = s.d_conv
    if cache is not None:
        window = torch.cat([cache["conv"], xBC], dim=1)  # [B,K,C]
        conv = (window.float() * p["conv_w"].float()).sum(dim=1, keepdim=True)
        xBC_c = F.silu(conv + p["conv_b"].float()).to(xBC.dtype)
        cache["conv"].copy_(window[:, 1:])
    else:
        xBC_c = _causal_conv(xBC, p["conv_w"], p["conv_b"])
        S = xBC.shape[1]
        new_conv = (xBC[:, S - (K - 1):].contiguous() if S >= K - 1
                    else F.pad(xBC, (0, 0, K - 1 - S, 0)))

    x = xBC_c[..., :d_in].reshape(Bsz, -1, nh, s.head_dim)
    B_ = xBC_c[..., d_in:d_in + s.d_state].reshape(Bsz, -1, 1, s.d_state)
    C_ = xBC_c[..., d_in + s.d_state:].reshape(Bsz, -1, 1, s.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"].float())  # [B,S,nh]
    A = -torch.exp(p["A_log"].float())

    if cache is not None:
        y = ssd_decode_step(x, dt, A, B_, C_, cache["state"])
        new_cache = cache
    else:
        y, state = ops.ssd_scan(x, dt, A, B_, C_, chunk=s.chunk)
        new_cache = {"conv": new_conv, "state": state}

    y = (y + x * p["D"][None, None, :, None].to(y.dtype)).to(u.dtype)
    y = y.reshape(Bsz, -1, d_in)
    gate = F.silu(z.float()).to(y.dtype)
    y = ops.rmsnorm(y * gate, p["gate_norm"], eps=cfg.norm_eps)
    return y @ p["out_proj"], new_cache


def mamba_sharded(p, cfg, h, sp):
    """The training pass's Mamba-2 block with its heads over ``model``
    (JAX's ``mamba_forward`` under a training context, whose rules split
    ``ssm_heads`` and ``ssm_in``), over the normalised residual ``h`` (a
    SlotPass activation). Each slot gathers its batch rows at every
    position -- the scan needs the whole sequence -- and computes its
    ``nh / n`` heads: its columns of ``z``, ``x`` and ``dt`` and the shared
    ``B``/``C`` columns of ``in_proj``, the causal conv over its ``x``
    channels and ``B``/``C``, the SSD scan at its head count, ``D`` and
    the gate.

    ``in_proj``'s columns are laid out [z | x | B | C | dt] and
    ``conv_w``/``conv_b``'s [x | B | C], so a contiguous ``model`` block of
    them is not one head shard's: both are gathered whole and each slot
    takes its columns (the gather's backward sums the shared ``B``/``C``
    columns' gradient over the row, as GSPMD does). ``A_log``, ``D``,
    ``dt_bias``, ``gate_norm`` and ``out_proj``'s rows split on head
    boundaries (``d_in = nh * hd``) and are the slot's blocks. The scan
    reads x, B and C as views of the conv's output row [b, S, w + 2 ds],
    as the unsharded block does: w is whole heads, so the rows stay as
    aligned as the kernel needs.

    The gated norm normalises over the whole ``d_in``: each slot gathers
    the gated rows of its ``model`` row (:meth:`SlotPass.split_cols`) and
    runs the rmsnorm kernel on whole rows, then multiplies its own columns
    by its rows of ``out_proj`` (row-parallel). Returns (partials [b, S,
    d] a slot, whether they sum over ``model``)."""
    s = cfg.ssm
    d_in = cfg.d_model * s.expand
    nh, hd, ds = s.n_heads(cfg.d_model), s.head_dim, s.d_state
    n = sp.count("ssm_heads")
    hl, w = nh // n, d_in // n  # a slot's heads and columns
    gated, cols = {}, {}
    for c in sp.coords:
        i = sp.index("ssm_heads", c)
        cols[c] = own = slice(i * w, (i + 1) * w)  # z's, x's, the gated rows'
        proj = sp.weight(p["in_proj"], c, keep=None)  # [z | x | B C | dt]
        conv_w = sp.weight(p["conv_w"], c, keep=None)  # [x | B C]
        conv_b = sp.weight(p["conv_b"], c, keep=None)
        bc = slice(d_in, d_in + 2 * ds)  # B and C after x
        dt0 = 2 * d_in + 2 * ds + i * hl
        hg = sp.full_seq(h, c)
        zxbcdt = hg @ torch.cat([proj[:, own], proj[:, d_in:][:, own],
                                 proj[:, d_in:][:, bc], proj[:, dt0:dt0 + hl]],
                                dim=1)
        z, xBC, dt = torch.split(zxbcdt, [w, w + 2 * ds, hl], dim=-1)
        xBC = _causal_conv(xBC, torch.cat([conv_w[:, own], conv_w[:, bc]], 1),
                           torch.cat([conv_b[own], conv_b[bc]]))
        b, S = hg.shape[:2]
        x = xBC[..., :w].reshape(b, S, hl, hd)
        B_ = xBC[..., w:w + ds].reshape(b, S, 1, ds)
        C_ = xBC[..., w + ds:].reshape(b, S, 1, ds)
        dt = F.softplus(dt.float() + sp.weight(p["dt_bias"], c).float())
        A = -torch.exp(sp.weight(p["A_log"], c).float())
        y, _ = ops.ssd_scan(x, dt, A, B_, C_, chunk=s.chunk)
        D = sp.weight(p["D"], c)
        y = (y + x * D[None, None, :, None].to(y.dtype)).to(h.dtype)
        y = y.reshape(b, S, w)
        gated[c] = y * F.silu(z.float()).to(y.dtype)
    rows = sp.split_cols(gated, d_in, "ssm_in")
    partials = {}
    for c in sp.coords:
        y = ops.rmsnorm(sp.full_cols(rows, c),
                        sp.weight(p["gate_norm"], c, keep=None),
                        eps=cfg.norm_eps)
        partials[c] = y[..., cols[c]] @ sp.weight(p["out_proj"], c)
    return partials, n > 1
