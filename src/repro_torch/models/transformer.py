"""Decoder and encoder stacks: layer grouping and per-layer application.

Layers are grouped as in the JAX package (``layer_groups``), so parameter
and cache trees keep its ``g{i}.l{j}`` names; where JAX scans over a
group's stacked layers, the port keeps one entry per layer in a list and
runs a Python loop over it. The port serves attention (GQA or MLA) and
Mamba-2 (SSM) layers, each with a dense or an MoE FFN, in any interleave
(jamba's hybrid: attention where ``i % attn_every == attn_offset``, MoE
where ``i >= first_dense`` and ``(i - first_dense) % every == 0``), and
the encoder-decoder stack (seamless): a bidirectional encoder and decoder
layers that cross-attend to its output (``xattn`` after ``ln_x``). Each
full-sequence pass returns the MoE layers' summed load-balance loss beside
its output, as the JAX stack does.

A training pass (``want_cache=False``) keeps no K/V caches, and may
rematerialise each layer in the backward (``remat``, JAX's
``REMAT_POLICIES``): ``"full"`` saves nothing of a layer but its input
(``torch.utils.checkpoint``, non-reentrant), ``"dots"`` also saves the
outputs of its matrix products, ``"none"`` saves everything. JAX
checkpoints a scanned superblock; the port, one layer. On a device mesh the
training pass runs every stack tensor- and sequence-parallel
(:func:`stack_apply_sharded`, an encoder's :func:`encoder_apply_sharded`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.kernels import ops
from repro_torch.models import kvcache as kvc
from repro_torch.models.attention import (
    attention_sharded,
    attn_schema,
    cross_attention_sharded,
    decode_attention_update,
    paged_decode_attention_update,
    prefill_attention,
    project_qkv,
)
from repro_torch.models.layers import ffn_apply, ffn_schema, rmsnorm, rmsnorm_schema
from repro_torch.models.mamba import mamba_forward, mamba_schema, mamba_sharded
from repro_torch.models.mla import (
    mla_decode_update,
    mla_prefill,
    mla_schema,
    mla_sharded,
    paged_mla_decode_update,
)
from repro_torch.models.moe import moe_apply, moe_apply_sharded, moe_schema
from repro_torch.sharding.partition import recompute, tree_parts, tree_with_parts


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


# --------------------------------------------------------------------------- #
# Schemas
# --------------------------------------------------------------------------- #
def layer_schema(cfg, sig) -> dict:
    """The JAX package's per-kind rule: ``ln1`` and the mixer (``attn``,
    MLA's schema under it for an MLA stack, or ``ssm``), with an
    encoder-decoder's attention layer's ``ln_x`` and ``xattn``, then
    ``ln2`` and ``moe`` (an MoE layer) or ``ffn`` unless the family is
    ``ssm``."""
    kind, is_moe = sig
    d = cfg.d_model
    s = {"ln1": rmsnorm_schema(d)}
    if kind == "attn":
        s["attn"] = (mla_schema(cfg) if cfg.mla is not None
                     else attn_schema(cfg))
        if cfg.is_encdec:
            s["ln_x"] = rmsnorm_schema(d)
            s["xattn"] = attn_schema(cfg)
    else:
        s["ssm"] = mamba_schema(cfg)
    if cfg.family != "ssm":
        s["ln2"] = rmsnorm_schema(d)
        if is_moe:
            s["moe"] = moe_schema(cfg)
        else:
            s["ffn"] = ffn_schema(d, cfg.d_ff)
    return s


def stack_schema(cfg) -> dict:
    """{"g{i}": [superblock 0, superblock 1, ...]}, each superblock a dict
    {"l{j}": layer schema} (the JAX package stacks the superblocks along a
    leading axis instead)."""
    return {
        f"g{gi}": [
            {f"l{j}": layer_schema(cfg, sig) for j, sig in enumerate(g.sigs)}
            for _ in range(g.count)
        ]
        for gi, g in enumerate(layer_groups(cfg))
    }


def encoder_schema(cfg) -> dict:
    """The bidirectional encoder: ``encoder_layers`` attention + dense FFN
    layers, {"g0": [layer 0, layer 1, ...]} (JAX stacks them in one
    scanned group)."""
    d = cfg.d_model
    return {"g0": [{"ln1": rmsnorm_schema(d), "attn": attn_schema(cfg),
                    "ln2": rmsnorm_schema(d), "ffn": ffn_schema(d, cfg.d_ff)}
                   for _ in range(cfg.encoder_layers)]}


REMAT_POLICIES = ("full", "dots", "none")
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpoint policy of ``"dots"``: keep the outputs of the
    matrix products (JAX's ``dots_with_no_batch_dims_saveable``, which on
    a 3-D activation times a 2-D weight saves the same products),
    recompute the rest."""
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn, policy, *args):
    """``fn(*args)`` saved for the backward as ``policy`` (one of
    :data:`REMAT_POLICIES`, or None: no rematerialisation, as ``"none"``)."""
    if policy in (None, "none"):
        return fn(*args)
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


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
    """The residual FFN half of a layer (none in an ``ssm``-family stack):
    every path (full, suffix, packed, decode, paged decode) reaches the FFN
    here. Returns (x, aux): an MoE layer dispatches the [B*S, d] rows it is
    given, pad rows included, and returns its load-balance loss; other
    layers return None."""
    if cfg.family == "ssm":
        return x, None
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        B, S, d = h.shape
        o, aux = moe_apply(lp["moe"], cfg, h.reshape(B * S, d))
        return x + o.reshape(B, S, d), aux
    return x + ffn_apply(lp["ffn"], h), None


def _cross_kv(p, cfg, enc_out):
    """The cross-attention keys and values of the encoder's output
    [B, F, d]: [B, F, Hkv, hd] each, no RoPE (JAX's ``_cross_kv``)."""
    shape = enc_out.shape[:2] + (cfg.n_kv_heads, cfg.head_dim)
    return ((enc_out @ p["wk"]).reshape(shape),
            (enc_out @ p["wv"]).reshape(shape))


def _cross_block(lp, cfg, x, *, kv=None, enc_out=None):
    """The residual cross-attention half of a decoder layer: ``ln_x``, the
    query projection, attention over every encoder row (flash with
    ``causal=False``, ``Sq != Skv``, for a full sequence; the decode
    kernel over the static ``xk``/``xv`` leaves, all F rows valid, for one
    token) and ``wo``. ``kv`` is the cached (xk, xv); without it they come
    from ``enc_out``. Returns (x, (xk, xv))."""
    p = lp["xattn"]
    xk, xv = kv if kv is not None else _cross_kv(p, cfg, enc_out)
    h = rmsnorm(x, lp["ln_x"], cfg.norm_eps)
    B, S = h.shape[:2]
    q = (h @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if kv is None:
        o = ops.flash_attention(q, xk, xv, causal=False)
    else:
        full = torch.full((B,), xk.shape[1], dtype=torch.int32,
                          device=xk.device)
        o = ops.decode_attention(q, xk, xv, full)
    return x + o.reshape(B, S, -1) @ p["wo"], (xk, xv)


def _encoder_layer(lp, cfg, x, positions):
    B, F_ = x.shape[:2]
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = project_qkv(lp["attn"], cfg, h, positions)
    o = ops.flash_attention(q, k, v, causal=False)
    x = x + o.reshape(B, F_, -1) @ lp["attn"]["wo"]
    return x + ffn_apply(lp["ffn"], rmsnorm(x, lp["ln2"], cfg.norm_eps))


def encoder_apply(params, cfg, x, positions, *, remat=None):
    """The bidirectional encoder over x [B, F, d] (projected frame
    features): per layer, RoPE'd self-attention through flash with
    ``causal=False`` and a dense FFN, each after its norm; each layer
    saved for the backward as ``remat`` (see :func:`remat_call`)."""
    for lp in params["g0"]:
        x = remat_call(_encoder_layer, remat, lp, cfg, x, positions)
    return x


def apply_layer_full(lp, cfg, sig, x, positions, *, prior=None,
                     prior_blocks=None, prior_pt=None, prior_valid=None,
                     segment_ids=None, segment_starts=None, enc_out=None):
    """x: [B,S,d] -> (x, aux, cache): aux the MoE layer's load-balance
    loss (None for a dense FFN), cache {"k","v"} [B,S,Hkv,hd] for an
    attention layer ({"ckv","krope"} [B,S,r] / [B,S,rope] for MLA),
    {"conv","state"} for an SSM layer (prefilled from a zero state).

    With ``prior_valid`` [B] it is a suffix prefill over this layer's prior
    KV: ``prior`` ({"k","v"} [B,Pp,Hkv,hd], dense), or ``prior_blocks``
    (this layer's block pool) with ``prior_pt`` [B, Pn], gathered here,
    right before the flash launch, ``Pn`` pages wide. ``segment_ids``
    [B,S] with ``segment_starts`` make it a packed prefill (attention
    layers only, both; MLA takes neither a prior nor segment ids, and
    raises JAX's ValueErrors). ``enc_out`` [B,F,d] (an encoder-decoder's
    decoder) adds the cross-attention after the self-attention, and its
    static ``xk``/``xv`` [B,F,Hkv,hd] to the cache."""
    B, S, _ = x.shape
    if segment_ids is not None and (sig[0] != "attn" or cfg.mla is not None):
        raise ValueError("packed prefill requires plain attention layers")
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if sig[0] != "attn":
        o, cache = mamba_forward(lp["ssm"], cfg, h)
        return (*_ffn_block(lp, cfg, x + o), cache)
    if cfg.mla is not None:
        if prior is not None or prior_blocks is not None:
            raise ValueError("prefix-reuse prefill not supported for MLA")
        o, cache = mla_prefill(lp["attn"], cfg, h, positions,
                               window=cfg.sliding_window)
        return (*_ffn_block(lp, cfg, x + o), cache)
    q, k, v = project_qkv(lp["attn"], cfg, h, positions)
    if prior_blocks is not None:
        prior = {n: kvc.gather_leaf(prior_blocks[n], prior_pt)
                 for n in ("k", "v")}
    o = prefill_attention(q, k, v, window=cfg.sliding_window, prior=prior,
                          prior_valid=prior_valid, segment_ids=segment_ids,
                          segment_starts=segment_starts)
    x = x + o.reshape(B, S, -1) @ lp["attn"]["wo"]
    cache = {"k": k, "v": v}
    if enc_out is not None:
        x, (cache["xk"], cache["xv"]) = _cross_block(lp, cfg, x,
                                                     enc_out=enc_out)
    return (*_ffn_block(lp, cfg, x), cache)


def apply_layer_decode(lp, cfg, sig, x, lcache, lengths, *, shard_ctx=None):
    """x: [B,1,d]; lcache's k/v (MLA: ckv/krope) ring-written (or its conv
    window and state updated) in place; an encoder-decoder's layer then
    cross-attends over its static xk/xv. Returns x. ``shard_ctx`` reaches
    the attention's sequence-sharded decode; an SSM layer runs as without
    it (as in JAX)."""
    B = x.shape[0]
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if sig[0] != "attn":
        o, _ = mamba_forward(lp["ssm"], cfg, h, cache=lcache)
        return _ffn_block(lp, cfg, x + o)[0]
    positions = lengths[:, None]  # [B,1]
    W = lcache["ckv" if cfg.mla is not None else "k"].shape[1]
    valid_len = torch.clamp(lengths + 1, max=W).to(torch.int32)
    if cfg.mla is not None:
        o = mla_decode_update(lp["attn"], cfg, h, lcache, lengths, positions,
                              valid_len=valid_len, shard_ctx=shard_ctx)
        return _ffn_block(lp, cfg, x + o)[0]
    q, k, v = project_qkv(lp["attn"], cfg, h, positions)
    o = decode_attention_update(q, k, v, lcache["k"], lcache["v"], lengths,
                                valid_len=valid_len, shard_ctx=shard_ctx)
    x = x + o.reshape(B, 1, -1) @ lp["attn"]["wo"]
    if "xk" in lcache:
        x = _cross_block(lp, cfg, x, kv=(lcache["xk"], lcache["xv"]))[0]
    return _ffn_block(lp, cfg, x)[0]  # decode drops the aux, as JAX does


def apply_layer_decode_paged(lp, cfg, sig, x, lblocks, page_table, lengths):
    """x: [B,1,d]; the new K/V lands in lblocks' blocks through the page
    table (in place). A paged row never wraps, so ``valid_len`` is
    ``lengths + 1`` (clamped to the table's width, as the ring's is to W).
    Returns x."""
    B = x.shape[0]
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    page = lblocks["ckv" if cfg.mla is not None else "k"].shape[1]
    valid_len = torch.clamp(lengths + 1, max=page_table.shape[1] * page).to(
        torch.int32)
    if cfg.mla is not None:
        o = paged_mla_decode_update(lp["attn"], cfg, h, lblocks, page_table,
                                    lengths, lengths[:, None],
                                    valid_len=valid_len)
        return _ffn_block(lp, cfg, x + o)[0]
    q, k, v = project_qkv(lp["attn"], cfg, h, lengths[:, None])
    o = paged_decode_attention_update(q, k, v, lblocks, page_table, lengths,
                                      valid_len=valid_len)
    x = x + o.reshape(B, 1, -1) @ lp["attn"]["wo"]
    return _ffn_block(lp, cfg, x)[0]


def stack_apply_full(params, cfg, x, positions, *, groups, prior=None,
                     prior_blocks=None, prior_pt=None, prior_valid=None,
                     segment_ids=None, segment_starts=None, enc_out=None,
                     want_cache=True, remat=None):
    """Prefill pass over every layer. Returns (x, aux, caches): aux the
    MoE layers' summed load-balance loss (an fp32 scalar, 0 without MoE),
    caches in the parameter tree's layout. ``prior`` (a dense cache tree)
    or ``prior_blocks`` (a block pool tree) with ``prior_pt``, and
    ``prior_valid``, make it a suffix prefill; ``segment_ids`` with
    ``segment_starts`` a packed one; ``enc_out`` the decoder of an
    encoder-decoder (see :func:`apply_layer_full`). Each layer is saved
    for the backward as ``remat`` (see :func:`remat_call`).

    ``want_cache=False`` is the training pass: caches None, each layer's
    cache dropped as soon as the layer returns."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = ({f"g{gi}": [{} for _ in range(g.count)]
               for gi, g in enumerate(groups)} if want_cache else None)
    for gname, i, lname, sig in _layers(groups):
        layer = functools.partial(
            apply_layer_full,
            prior=None if prior is None else prior[gname][i][lname],
            prior_blocks=(None if prior_blocks is None
                          else prior_blocks[gname][i][lname]),
            prior_pt=prior_pt, prior_valid=prior_valid,
            segment_ids=segment_ids, segment_starts=segment_starts,
            enc_out=enc_out)
        x, aux, cache = remat_call(layer, remat, params[gname][i][lname],
                                   cfg, sig, x, positions)
        if want_cache:
            caches[gname][i][lname] = cache
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total, caches


def stack_apply_decode(params, cfg, x, caches, lengths, *, groups,
                       shard_ctx=None):
    """One-token decode pass; ``caches`` are updated in place."""
    for gname, i, lname, sig in _layers(groups):
        x = apply_layer_decode(params[gname][i][lname], cfg, sig, x,
                               caches[gname][i][lname], lengths,
                               shard_ctx=shard_ctx)
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


# --------------------------------------------------------------------------- #
# The training pass on a device mesh
# --------------------------------------------------------------------------- #
def _norm_sharded(x, w, eps, sp):
    """rmsnorm of each slot's block of the residual stream, the weight
    gathered over ``data``: a SlotPass activation."""
    return sp.act({c: rmsnorm(x.locals[c], sp.weight(w, c), eps)
                   for c in sp.coords}, x.shape[2])


def apply_layer_sharded(lp, cfg, sig, x, sp, enc=None, causal=True):
    """One layer of the training pass on ``sp``'s mesh (JAX's
    ``apply_layer_full`` under a training context), x the residual stream
    split ("batch", "act_seq", None). Megatron's sequence parallelism: each
    half gathers its normalised block over positions, runs
    tensor-parallel and reduce-scatters its partials back onto the slots'
    blocks of positions, which keeps the residual in JAX's ``("batch",
    "act_seq", None)`` constraint after the layer. The mixer: attention
    (:func:`attention_sharded`, bidirectional with ``causal=False`` -- an
    encoder layer --, or :func:`mla_sharded`) or Mamba-2
    (:func:`mamba_sharded`, ``sig[0] != "attn"``); with ``enc`` (an
    encoder-decoder's encoder output, split as a residual stream over its
    frames) then the cross-attention after ``ln_x``
    (:func:`cross_attention_sharded`); then the FFN half, none in an
    ``ssm``-family stack: column-parallel ``w_gate``/``w_up`` and
    row-parallel ``w_down``, or :func:`moe_apply_sharded`. Returns (the
    new residual's blocks, aux or None)."""
    sp = sp.scope()
    d = x.shape[2]

    def add(x, w, mix):  # x + the reduced partials of mix(norm(x, w))
        r = sp.reduce(*mix(_norm_sharded(x, w, cfg.norm_eps, sp)))
        return sp.act({c: x.locals[c] + r[c] for c in sp.coords}, d)

    if sig[0] != "attn":
        x = add(x, lp["ln1"], lambda h: mamba_sharded(lp["ssm"], cfg, h, sp))
    elif cfg.mla is not None:
        x = add(x, lp["ln1"], lambda h: mla_sharded(lp["attn"], cfg, h, sp))
    else:
        x = add(x, lp["ln1"], lambda h: attention_sharded(
            lp["attn"], cfg, h, sp, causal=causal))
    if enc is not None:
        x = add(x, lp["ln_x"], lambda h: cross_attention_sharded(
            lp["xattn"], cfg, h, enc, sp))
    if cfg.family == "ssm":
        return {c: x.locals[c] for c in sp.coords}, None
    h = _norm_sharded(x, lp["ln2"], cfg.norm_eps, sp)
    if "moe" in lp:
        o, aux = moe_apply_sharded(lp["moe"], cfg, h, sp)
    else:
        partials = {c: ffn_apply({n: sp.weight(w, c)
                                  for n, w in lp["ffn"].items()},
                                 sp.full_seq(h, c)) for c in sp.coords}
        o, aux = sp.reduce(partials, summed=sp.count("ffn") > 1), None
    return {c: x.locals[c] + o[c] for c in sp.coords}, aux


def _remat_layer_sharded(lp, cfg, sig, x, sp, enc=None, causal=True):
    """:func:`apply_layer_sharded` fully rematerialised: its inputs -- the
    layer's weight parts, the computing slots' residual blocks and, for a
    decoder layer of an encoder-decoder, their blocks of the encoder's
    output -- are all it saves (``sharding.partition.recompute``, whose
    backward runs once however many devices the layer spans, and gives
    gradients only to the tensors it is handed: without ``enc``'s blocks
    among them the cross-attention would send nothing back into the
    encoder)."""
    coords = sp.coords
    n, k = len(tree_parts(lp)), len(coords)

    def run(*ts):
        e = None if enc is None else sp.like(enc, dict(zip(coords,
                                                           ts[n + k:])))
        locs, aux = apply_layer_sharded(
            tree_with_parts(lp, ts[:n]), cfg, sig,
            sp.act(dict(zip(coords, ts[n:n + k])), x.shape[2]), sp, enc=e,
            causal=causal)
        return tuple(locs[c] for c in coords) + (() if aux is None
                                                 else (aux,))

    enc_blocks = () if enc is None else tuple(enc.locals[c] for c in coords)
    out = recompute(run, *tree_parts(lp), *(x.locals[c] for c in coords),
                    *enc_blocks)
    aux = out[k] if len(out) > k else None
    return dict(zip(coords, out)), aux


def _sharded_layer(remat):
    if remat not in (None, "none", "full"):
        raise ValueError(f"the sharded pass rematerialises a whole layer "
                         f"or nothing: remat_policy {remat!r}")
    return _remat_layer_sharded if remat == "full" else apply_layer_sharded


def stack_apply_sharded(params, cfg, x, *, groups, sp, remat=None, enc=None):
    """The training pass over every layer on a device mesh: attention
    (GQA or MLA), Mamba-2 and hybrid stacks, dense or MoE, and an
    encoder-decoder's decoder (``enc``: its encoder's output, split as a
    residual stream over the frames, which every attention layer
    cross-attends to). x and the result are the residual stream as a
    SlotPass activation. With ``remat="full"`` each layer, its gathers
    included, is rematerialised in the backward
    (:func:`_remat_layer_sharded`), so the backward re-gathers and keeps no
    layer's whole weights; ``None`` or ``"none"`` saves everything.
    (``"dots"``, a selective policy, is the unsharded pass's alone.)
    Returns (x, aux: the MoE layers' summed load-balance loss)."""
    layer = _sharded_layer(remat)
    aux_total = torch.zeros((), dtype=torch.float32,
                            device=sp.mesh.first_device)
    for gname, i, lname, sig in _layers(groups):
        locs, aux = layer(params[gname][i][lname], cfg, sig, x, sp,
                          enc=enc if sig[0] == "attn" else None)
        x = sp.act(locs, x.shape[2])
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def encoder_apply_sharded(params, cfg, x, sp, *, remat=None):
    """The bidirectional encoder on a device mesh (JAX's ``encoder_apply``
    under a training context): x [B, F, d] the projected frames as a
    SlotPass activation over F positions, each layer
    :func:`apply_layer_sharded` with ``causal=False`` -- self-attention and
    the dense FFN, tensor-parallel, the residual split by ``act_seq`` --
    saved as ``remat`` (:func:`stack_apply_sharded`'s policies)."""
    layer = _sharded_layer(remat)
    for lp in params["g0"]:
        locs, _ = layer(lp, cfg, ("attn", False), x, sp, causal=False)
        x = sp.act(locs, x.shape[2])
    return x
