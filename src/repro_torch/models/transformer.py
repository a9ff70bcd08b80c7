"""Decoder stack: layer grouping and per-layer application.

Layers are grouped as in the JAX package (``layer_groups``), so parameter
and cache trees keep its ``g{i}.l{j}`` names; where JAX scans over a
group's stacked layers, the port keeps one entry per layer in a list and
runs a Python loop over it. This slice serves attention-only, non-MoE,
non-MLA stacks; other layer kinds raise and name the slice that brings them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.attention import (
    attn_schema,
    decode_attention_update,
    prefill_attention,
    project_qkv,
)
from repro_torch.models.layers import ffn_apply, ffn_schema, rmsnorm, rmsnorm_schema


@dataclasses.dataclass(frozen=True)
class Group:
    sigs: tuple  # layer signatures within one superblock
    count: int  # number of superblocks


def layer_signatures(cfg):
    return tuple(
        (cfg.layer_kind(i), cfg.layer_is_moe(i)) for i in range(cfg.n_layers)
    )


def layer_groups(cfg) -> list:
    sigs = layer_signatures(cfg)
    n = len(sigs)
    for P in range(1, min(8, n) + 1):
        if n % P == 0 and all(sigs[i] == sigs[i % P] for i in range(n)):
            return [Group(sigs[:P], n // P)]
    groups, i = [], 0
    while i < n:
        j = i
        while j < n and sigs[j] == sigs[i]:
            j += 1
        groups.append(Group((sigs[i],), j - i))
        i = j
    return groups


def check_supported(cfg):
    """Raise for the layer kinds later slices of the port bring."""
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder stacks come with the "
                                  "architectures slice (seamless)")
    if cfg.frontend:
        raise NotImplementedError("vision/audio frontends come with the "
                                  "architectures slice (pixtral, seamless)")
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention comes with the architectures "
                                  "slice (deepseek-v2)")
    for kind, is_moe in layer_signatures(cfg):
        if kind != "attn":
            raise NotImplementedError("SSM layers come with the SSM/hybrid "
                                      "slice (mamba2, jamba)")
        if is_moe:
            raise NotImplementedError("MoE layers come with the architectures "
                                      "slice (grok, deepseek)")


# --------------------------------------------------------------------------- #
# Schemas
# --------------------------------------------------------------------------- #
def layer_schema(cfg, sig) -> dict:
    d = cfg.d_model
    return {
        "ln1": rmsnorm_schema(d),
        "attn": attn_schema(cfg),
        "ln2": rmsnorm_schema(d),
        "ffn": ffn_schema(d, cfg.d_ff),
    }


def stack_schema(cfg) -> dict:
    """{"g{i}": [superblock 0, superblock 1, ...]}, each superblock a dict
    {"l{j}": layer schema} (the JAX package stacks the superblocks along a
    leading axis instead)."""
    check_supported(cfg)
    return {
        f"g{gi}": [
            {f"l{j}": layer_schema(cfg, sig) for j, sig in enumerate(g.sigs)}
            for _ in range(g.count)
        ]
        for gi, g in enumerate(layer_groups(cfg))
    }


def _layers(groups):
    """Yield (group, superblock index, j, sig) over the stack in order."""
    for gi, g in enumerate(groups):
        for i in range(g.count):
            for j, sig in enumerate(g.sigs):
                yield f"g{gi}", i, f"l{j}", sig


# --------------------------------------------------------------------------- #
# Full-sequence (prefill) and one-token (decode) layer application
# --------------------------------------------------------------------------- #
def apply_layer_full(lp, cfg, sig, x, positions):
    """x: [B,S,d] -> (x, cache {"k","v"} [B,S,Hkv,hd])."""
    B, S, _ = x.shape
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = project_qkv(lp["attn"], cfg, h, positions)
    o = prefill_attention(q, k, v, window=cfg.sliding_window)
    x = x + o.reshape(B, S, -1) @ lp["attn"]["wo"]
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    x = x + ffn_apply(lp["ffn"], h2)
    return x, {"k": k, "v": v}


def apply_layer_decode(lp, cfg, sig, x, lcache, lengths):
    """x: [B,1,d]; lcache's k/v ring-written in place. Returns x."""
    B = x.shape[0]
    positions = lengths[:, None]  # [B,1]
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    W = lcache["k"].shape[1]
    valid_len = torch.clamp(lengths + 1, max=W).to(torch.int32)
    q, k, v = project_qkv(lp["attn"], cfg, h, positions)
    o = decode_attention_update(q, k, v, lcache["k"], lcache["v"], lengths,
                                valid_len=valid_len)
    x = x + o.reshape(B, 1, -1) @ lp["attn"]["wo"]
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + ffn_apply(lp["ffn"], h2)


def stack_apply_full(params, cfg, x, positions, *, groups):
    """Prefill pass over every layer. Returns (x, caches) with caches in
    the parameter tree's layout."""
    caches = {f"g{gi}": [{} for _ in range(g.count)]
              for gi, g in enumerate(groups)}
    for gname, i, lname, sig in _layers(groups):
        x, cache = apply_layer_full(params[gname][i][lname], cfg, sig, x,
                                    positions)
        caches[gname][i][lname] = cache
    return x, caches


def stack_apply_decode(params, cfg, x, caches, lengths, *, groups):
    """One-token decode pass; ``caches`` are updated in place."""
    for gname, i, lname, sig in _layers(groups):
        x = apply_layer_decode(params[gname][i][lname], cfg, sig, x,
                               caches[gname][i][lname], lengths)
    return x
