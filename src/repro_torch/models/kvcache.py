"""Ring-buffer KV caches as nested dicts/lists of tensors.

An attention layer's cache is ``{"k": [B, W, Hkv, hd], "v": [B, W, Hkv, hd]}``.
Ring semantics: token ``t`` of a row lives at slot ``t % W``, so a prefill
of ``true_len <= W`` tokens occupies slots ``[0, true_len)`` and a full
ring models a sliding-window cache exactly (W = window).

Unlike the JAX package, whose arrays are immutable, :func:`ring_write`
updates the cache in place: the decode step then holds one cache buffer,
as the JAX engine gets by donating it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.schema import tree_map


def ring_write(cache_kv, new, lengths):
    """cache_kv: [B, W, ...]; new: [B, 1, ...]; lengths: [B] int. Writes
    row b's new entry at slot ``lengths[b] % W`` in place; returns the
    cache."""
    B, W = cache_kv.shape[:2]
    idx = torch.remainder(lengths.to(torch.int64), W)
    rows = torch.arange(B, device=cache_kv.device)
    cache_kv[rows, idx] = new[:, 0].to(cache_kv.dtype)
    return cache_kv


def attn_cache_shapes(cfg, B: int, W: int) -> dict:
    if cfg.mla is not None or cfg.is_encdec:
        raise NotImplementedError(
            "MLA and encoder-decoder caches come with the architectures slice")
    return {
        "k": (B, W, cfg.n_kv_heads, cfg.head_dim),
        "v": (B, W, cfg.n_kv_heads, cfg.head_dim),
    }


def layer_cache_shapes(cfg, sig, B: int, W: int) -> dict:
    kind, _ = sig
    if kind != "attn":
        raise NotImplementedError(
            "SSM state caches come with the SSM/hybrid slice")
    return attn_cache_shapes(cfg, B, W)


def grow_cache(caches, new_w: int):
    """Zero-pad the ring dim (axis 1) of every k/v leaf of a prefill cache
    tree to ``new_w`` so decode can append."""

    def grow(leaf):
        w = leaf.shape[1]
        if w >= new_w:
            return leaf
        # pad spec runs from the last dim: (hd, Hkv, W)
        return F.pad(leaf, (0, 0, 0, 0, 0, new_w - w))

    return tree_map(grow, caches)
