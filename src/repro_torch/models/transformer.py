"""Decoder stack: layer grouping and per-layer application.

Layers are grouped as in the JAX package (``layer_groups``), so parameter
and cache trees keep its ``g{i}.l{j}`` names; where JAX scans over a
group's stacked layers, the port keeps one entry per layer in a list and
runs a Python loop over it. The port serves attention and Mamba-2 (SSM)
layers without MoE or MLA; other layer kinds raise and name the slice that
brings them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import kvcache as kvc
from repro_torch.models.attention import (
    attn_schema,
    decode_attention_update,
    paged_decode_attention_update,
    prefill_attention,
    project_qkv,
)
from repro_torch.models.layers import ffn_apply, ffn_schema, rmsnorm, rmsnorm_schema
from repro_torch.models.mamba import mamba_forward, mamba_schema


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
    for _, is_moe in layer_signatures(cfg):
        if is_moe:
            raise NotImplementedError("MoE layers come with the architectures "
                                      "slice (grok, deepseek)")


# --------------------------------------------------------------------------- #
# Schemas
# --------------------------------------------------------------------------- #
def layer_schema(cfg, sig) -> dict:
    """The JAX package's per-kind rule: ``ln1`` and the mixer (``attn`` or
    ``ssm``), then ``ln2`` and ``ffn`` unless the family is ``ssm``."""
    kind, _ = sig
    d = cfg.d_model
    s = {"ln1": rmsnorm_schema(d)}
    if kind == "attn":
        s["attn"] = attn_schema(cfg)
    else:
        s["ssm"] = mamba_schema(cfg)
    if cfg.family != "ssm":
        s["ln2"] = rmsnorm_schema(d)
        s["ffn"] = ffn_schema(d, cfg.d_ff)
    return s


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
def _ffn_block(lp, cfg, x):
    """The residual FFN half of a layer (none in an ``ssm``-family stack)."""
    if cfg.family == "ssm":
        return x
    return x + ffn_apply(lp["ffn"], rmsnorm(x, lp["ln2"], cfg.norm_eps))


def apply_layer_full(lp, cfg, sig, x, positions, *, prior=None,
                     prior_blocks=None, prior_pt=None, prior_valid=None,
                     segment_ids=None, segment_starts=None):
    """x: [B,S,d] -> (x, cache): {"k","v"} [B,S,Hkv,hd] for an attention
    layer, {"conv","state"} for an SSM layer (prefilled from a zero state).

    With ``prior_valid`` [B] it is a suffix prefill over this layer's prior
    KV: ``prior`` ({"k","v"} [B,Pp,Hkv,hd], dense), or ``prior_blocks``
    (this layer's block pool) with ``prior_pt`` [B, Pn], gathered here,
    right before the flash launch, ``Pn`` pages wide. ``segment_ids``
    [B,S] with ``segment_starts`` make it a packed prefill (attention
    layers only, both)."""
    B, S, _ = x.shape
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if sig[0] != "attn":
        o, cache = mamba_forward(lp["ssm"], cfg, h)
        return _ffn_block(lp, cfg, x + o), cache
    q, k, v = project_qkv(lp["attn"], cfg, h, positions)
    if prior_blocks is not None:
        prior = {n: kvc.gather_leaf(prior_blocks[n], prior_pt)
                 for n in ("k", "v")}
    o = prefill_attention(q, k, v, window=cfg.sliding_window, prior=prior,
                          prior_valid=prior_valid, segment_ids=segment_ids,
                          segment_starts=segment_starts)
    x = x + o.reshape(B, S, -1) @ lp["attn"]["wo"]
    return _ffn_block(lp, cfg, x), {"k": k, "v": v}


def apply_layer_decode(lp, cfg, sig, x, lcache, lengths):
    """x: [B,1,d]; lcache's k/v ring-written (or its conv window and state
    updated) in place. Returns x."""
    B = x.shape[0]
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if sig[0] != "attn":
        o, _ = mamba_forward(lp["ssm"], cfg, h, cache=lcache)
        return _ffn_block(lp, cfg, x + o)
    positions = lengths[:, None]  # [B,1]
    W = lcache["k"].shape[1]
    valid_len = torch.clamp(lengths + 1, max=W).to(torch.int32)
    q, k, v = project_qkv(lp["attn"], cfg, h, positions)
    o = decode_attention_update(q, k, v, lcache["k"], lcache["v"], lengths,
                                valid_len=valid_len)
    x = x + o.reshape(B, 1, -1) @ lp["attn"]["wo"]
    return _ffn_block(lp, cfg, x)


def apply_layer_decode_paged(lp, cfg, sig, x, lblocks, page_table, lengths):
    """x: [B,1,d]; the new K/V lands in lblocks' blocks through the page
    table (in place). A paged row never wraps, so ``valid_len`` is
    ``lengths + 1`` (clamped to the table's width, as the ring's is to W).
    Returns x."""
    B = x.shape[0]
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    width = page_table.shape[1] * lblocks["k"].shape[1]
    valid_len = torch.clamp(lengths + 1, max=width).to(torch.int32)
    q, k, v = project_qkv(lp["attn"], cfg, h, lengths[:, None])
    o = paged_decode_attention_update(q, k, v, lblocks, page_table, lengths,
                                      valid_len=valid_len)
    x = x + o.reshape(B, 1, -1) @ lp["attn"]["wo"]
    return _ffn_block(lp, cfg, x)


def stack_apply_full(params, cfg, x, positions, *, groups, prior=None,
                     prior_blocks=None, prior_pt=None, prior_valid=None,
                     segment_ids=None, segment_starts=None):
    """Prefill pass over every layer. Returns (x, caches) with caches in
    the parameter tree's layout. ``prior`` (a dense cache tree) or
    ``prior_blocks`` (a block pool tree) with ``prior_pt``, and
    ``prior_valid``, make it a suffix prefill; ``segment_ids`` with
    ``segment_starts`` a packed one (see :func:`apply_layer_full`)."""
    caches = {f"g{gi}": [{} for _ in range(g.count)]
              for gi, g in enumerate(groups)}
    for gname, i, lname, sig in _layers(groups):
        lprior = None if prior is None else prior[gname][i][lname]
        lblocks = (None if prior_blocks is None
                   else prior_blocks[gname][i][lname])
        x, cache = apply_layer_full(params[gname][i][lname], cfg, sig, x,
                                    positions, prior=lprior,
                                    prior_blocks=lblocks, prior_pt=prior_pt,
                                    prior_valid=prior_valid,
                                    segment_ids=segment_ids,
                                    segment_starts=segment_starts)
        caches[gname][i][lname] = cache
    return x, caches


def stack_apply_decode(params, cfg, x, caches, lengths, *, groups):
    """One-token decode pass; ``caches`` are updated in place."""
    for gname, i, lname, sig in _layers(groups):
        x = apply_layer_decode(params[gname][i][lname], cfg, sig, x,
                               caches[gname][i][lname], lengths)
    return x


def stack_apply_decode_paged(params, cfg, x, blocks, page_table, lengths, *,
                             groups):
    """One-token decode pass over the paged pool; ``blocks`` are updated in
    place."""
    for gname, i, lname, sig in _layers(groups):
        x = apply_layer_decode_paged(params[gname][i][lname], cfg, sig, x,
                                     blocks[gname][i][lname], page_table,
                                     lengths)
    return x
