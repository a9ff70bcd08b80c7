"""Mamba-2 block (SSD -- state-space duality, arXiv:2405.21060).

The port of the JAX package's ``models/mamba.py``. Prefill runs the chunked
SSD scan through :func:`repro_torch.kernels.ops.ssd_scan` (the hand-written
kernel on the card, where the JAX model runs its jnp ``ssd_chunked``), from a
zero state. Decode is the one-token state recurrence in plain PyTorch (the
JAX package has no kernel for it) and writes the layer's conv window and
state into its cache in place. The cache -- a ``[K-1, d_in + 2 ds]`` conv
window and an fp32 ``[nh, hd, ds]`` state per row -- has the same size
whatever the prompt length: the constant-size serving payload.
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
