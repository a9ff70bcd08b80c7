"""Shared layer math: RMSNorm, RoPE, SwiGLU, embedding, output head and
the training loss."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.schema import ParamSpec
from repro_torch.sharding.partition import Sharded, axes_of, psum, shard


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


def embed_lookup(table, tokens, shard_ctx=None):
    """Rows of the embedding table for ``tokens``.

    With a vocab-sharded table (a :class:`~repro_torch.sharding.partition.
    Sharded`, or a context whose rules shard ``vocab``, which splits the
    table here) it is Megatron's vocab-parallel embedding, as the JAX
    package's ``shard_map`` body: each vocab block gathers its own id range
    on its slot's device, ids outside it giving zero rows, and the partials
    are summed (:func:`~repro_torch.sharding.partition.psum`) onto the
    mesh's first device. Each token's row comes from one block and zeros
    from the rest, so the sum is exact. The batch stays whole."""
    if shard_ctx is not None and shard_ctx.shards_vocab \
            and not isinstance(table, Sharded):
        table = shard(table, shard_ctx, "vocab", "embed")
    if not isinstance(table, Sharded):
        return F.embedding(tokens, table)
    parts = []
    for (vb, _), (_, t) in _vocab_blocks(table):
        n_local = t.shape[0]
        ids = tokens.to(t.device) - vb * n_local
        inside = (ids >= 0) & (ids < n_local)
        rows = F.embedding(torch.where(inside, ids, 0), t)
        parts.append(torch.where(inside[..., None], rows, 0).to(t.dtype))
    return psum(parts, table.mesh.first_device)


def _vocab_blocks(table: Sharded):
    """The vocab blocks of a table split along vocab only, in order."""
    if any(axes_of(p) for p in table.spec[1:]):
        raise ValueError(f"a table split past its vocab dim: {table.spec}")
    return sorted(table.blocks().items())


def lm_head(table, x, true_vocab: int):
    """Logits against the tied table; pad ids masked to -1e9. A
    vocab-sharded table gives each block's logits on its slot's device,
    concatenated along vocab on the mesh's first device."""
    if isinstance(table, Sharded):
        dev = table.mesh.first_device
        logits = torch.cat([(x.to(t.device) @ t.t().to(x.dtype)).to(dev)
                            for _, (_, t) in _vocab_blocks(table)], dim=-1)
    else:
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
