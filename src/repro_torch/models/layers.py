"""Shared layer math: RMSNorm, RoPE, SwiGLU, embedding, output head and
the training loss."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.schema import ParamSpec
from repro_torch.sharding.partition import (
    Sharded,
    axes_of,
    pmax,
    psum,
    recompute,
    shard,
)


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
    parts = [_block_rows(t, tokens.to(t.device), vb * t.shape[0])
             for (vb, _), (_, t) in _vocab_blocks(table)]
    return psum(parts, table.mesh.first_device)


def _block_rows(t, tokens, start):
    """The rows of a vocab block ``t`` (ids ``start`` onward) for
    ``tokens``: zero rows for ids outside it."""
    ids = tokens - start
    inside = (ids >= 0) & (ids < t.shape[0])
    rows = F.embedding(torch.where(inside, ids, 0), t)
    return torch.where(inside[..., None], rows, 0).to(t.dtype)


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


def embed_lookup_sharded(table: Sharded, tokens, sp, prefix=None):
    """The training pass's vocab-parallel embedding (JAX's ``embed_lookup``
    under a training context): each slot gathers its vocab block of the
    table over ``data`` (FSDP) and looks up its batch rows' tokens, ids
    outside the block giving zero rows; the partials are summed over
    ``model`` onto each slot's block of positions (a
    :class:`~repro_torch.sharding.partition.SlotPass` ``reduce``).
    ``prefix(c)`` (a VLM's projected features, [b, F, d] for slot ``c``'s
    batch rows) goes ahead of the token rows, the pass then spanning F + S
    positions; where the partials sum over ``model`` only the first slot
    of each ``model`` row adds it (the others add zeros), so the sum stays
    exact. Returns the residual stream's blocks, one a slot."""
    summed = table.counts()[0] > 1
    partials = {}
    for c in sp.coords:
        t = sp.weight(table, c)
        rows = _block_rows(t, sp.batch_rows(tokens, c),
                           table.block(c)[0] * t.shape[0])
        if prefix is not None:
            if not summed or tuple(c) == sp.model_row(c)[0]:
                pre = prefix(c).to(rows.dtype)
            else:
                pre = rows.new_zeros((rows.shape[0], sp.S - rows.shape[1],
                                      rows.shape[2]))
            rows = torch.cat([pre, rows], dim=1)
        partials[c] = rows
    return sp.reduce(partials, summed=summed)


def _nll_chunk(starts, true_vocab, dev, *tensors):
    """One chunk of :func:`vocab_parallel_nll`: ``tensors`` are each vocab
    block's rows of x, then its table block, then the labels. Each block's
    fp32 logits on its own device, the max shift (no gradient), the summed
    exponentials and the gold logit merged onto ``dev``."""
    k = len(starts)
    xs, tables, labels = tensors[:k], tensors[k:2 * k], tensors[2 * k]
    logits = []
    for x, t, start in zip(xs, tables, starts):
        lg = (x @ t.t()).float()  # [b, c, V_l]
        if start + t.shape[0] > true_vocab:
            ids = start + torch.arange(t.shape[0], device=lg.device)
            lg = lg.masked_fill(ids >= true_vocab, float("-inf"))
        logits.append(lg)
    m = pmax([lg.amax(dim=-1) for lg in logits], dev).detach()
    se = psum([torch.exp(lg - m.to(lg.device)[..., None]).sum(dim=-1)
               for lg in logits], dev)
    golds = []
    for lg, start in zip(logits, starts):
        lid = labels.to(lg.device).to(torch.int64) - start
        inside = (lid >= 0) & (lid < lg.shape[-1])
        g = torch.gather(lg, -1, lid.clamp(0, lg.shape[-1] - 1)[..., None])
        golds.append(torch.where(inside, g[..., 0], 0.0))
    return ((torch.log(se) + m) - psum(golds, dev),)


def vocab_parallel_nll(x: Sharded, table: Sharded, labels, sp,
                       true_vocab: int, chunk: int = 1024, start: int = 0):
    """Fused LM head + cross-entropy with the table split by ``vocab``
    (JAX's ``vocab_parallel_nll``): for each batch block, each slot of its
    ``model`` row computes its vocab block's fp32 logits on its own device,
    ``chunk`` positions at a time, each chunk rematerialised in the
    backward (``sharding.partition.recompute``, JAX's ``jax.checkpoint``
    in its scan); pad ids are masked to -inf; the shift is the max over the blocks
    with no gradient (JAX's ``_pmax_sg``), the log-sum-exp comes from the
    sum of the blocks' summed exponentials and the gold logit from the
    block that holds the label. The whole [B, S, V] logits never exist.
    ``x`` is the residual stream (split by batch and ``act_seq``), gathered
    over positions from ``start`` on (a VLM's text suffix: its feature rows
    take no loss); ``labels`` [B, S - start] whole or split by batch.
    Returns the token NLL [B, S - start] fp32 on the mesh's first device.
    With ``vocab`` whole (one block) it is the plain cross-entropy of the
    tied head."""
    S = sp.S - start
    c = min(chunk, S)
    if S % c:  # ragged: one chunk, as JAX
        c = S
    first = sp.mesh.first_device
    rows = {}
    for coord in sp.coords:
        bi = sp.rows(coord).start
        if bi in rows:
            continue
        slots, seen = [], set()
        for r in sp.model_row(coord):  # one slot a vocab block
            if table.block(r)[0] not in seen:
                seen.add(table.block(r)[0])
                slots.append(r)
        xs = [sp.full_seq(x, r)[:, start:] for r in slots]
        tables = [sp.weight(table, r) for r in slots]
        starts = [table.block(r)[0] * t.shape[0]
                  for r, t in zip(slots, tables)]
        dev = sp.dev(slots[0])
        lab = sp.batch_rows(labels, coord).to(dev)
        fn = functools.partial(_nll_chunk, starts, true_vocab, dev)
        pieces = [recompute(fn, *(t[:, j:j + c] for t in xs), *tables,
                            lab[:, j:j + c])[0] for j in range(0, S, c)]
        rows[bi] = torch.cat(pieces, dim=1).to(first)
    return torch.cat([rows[b] for b in sorted(rows)])
