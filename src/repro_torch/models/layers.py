"""Shared layer math: RMSNorm, RoPE, SwiGLU, embedding, output head and
the training loss."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.schema import ParamSpec


# --------------------------------------------------------------------------- #
# RMSNorm
# --------------------------------------------------------------------------- #
def rmsnorm_schema(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def rmsnorm(x, w, eps: float = 1e-5):
    """fp32 mean of squares, normalised row cast to x's dtype BEFORE the
    ``* w`` (the JAX model's bf16 rounding order). Runs the rmsnorm kernel
    on CUDA tensors."""
    return ops.rmsnorm(x, w, eps=eps)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S] (int).
    Split-half rotation with fp32 angles."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # [hd/2]
    angles = positions.to(torch.float32)[..., None] * freqs  # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# SwiGLU FFN
# --------------------------------------------------------------------------- #
def ffn_schema(d: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamSpec((d, d_ff), ("embed", "ffn")),
        "w_up": ParamSpec((d, d_ff), ("embed", "ffn")),
        "w_down": ParamSpec((d_ff, d), ("ffn", "embed")),
    }


def ffn_apply(p, x):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# --------------------------------------------------------------------------- #
# Embedding + output head (tied table, vocab padded to a multiple of 256)
# --------------------------------------------------------------------------- #
def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def embed_schema(vocab_padded: int, d: int) -> ParamSpec:
    return ParamSpec((vocab_padded, d), ("vocab", "embed"),
                     init="small_normal")


def embed_lookup(table, tokens):
    return F.embedding(tokens, table)


def lm_head(table, x, true_vocab: int):
    """Logits against the tied table; pad ids masked to -1e9."""
    logits = x @ table.t().to(x.dtype)  # [..., vocab_padded]
    if table.shape[0] != true_vocab:
        logits[..., true_vocab:] = -1e9
    return logits


def cross_entropy(logits, labels, mask=None):
    """Mean token NLL (JAX's ``cross_entropy``): fp32 logsumexp minus the
    gold logit; with ``mask`` [B, S] the masked mean, over at least one."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
