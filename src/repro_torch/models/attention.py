"""GQA attention: projections, prefill through the flash kernel (with a
cached prefix for suffix prefill), ring decode through the decode kernel and
paged decode through the paged kernel (the plain PyTorch versions on the
CPU).

Unlike the JAX package, whose model runs pure-jnp attention beside its
Pallas kernels, the port's model calls the kernels, so on the card they do
the real work of the serving path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import kvcache as kvc
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.schema import ParamSpec
from repro_torch.sharding.partition import Sharded, axes_of, pmax, psum


def attn_schema(cfg) -> dict:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, h * hd), ("embed", "heads")),
        "wk": ParamSpec((d, hk * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, hk * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((h * hd, d), ("heads", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
        s["k_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
    return s


def _split_heads(x, hd):
    return x.reshape(x.shape[:-1] + (x.shape[-1] // hd, hd))


def project_qkv(p, cfg, x, positions):
    """x: [B,S,d] -> q [B,S,H,hd], k/v [B,S,Hkv,hd] with qk-norm + RoPE.
    The head counts are the weights' widths over ``head_dim``: a
    tensor-parallel slot passes its columns of ``wq``/``wk``/``wv``."""
    q = _split_heads(x @ p["wq"], cfg.head_dim)
    k = _split_heads(x @ p["wk"], cfg.head_dim)
    v = _split_heads(x @ p["wv"], cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def prefill_attention(q, k, v, *, window: int = 0, prior=None,
                      prior_valid=None, segment_ids=None, segment_starts=None):
    """Causal self-attention over a (right-padded) prompt batch: trailing
    pad is invisible to real positions under the causal mask. ``prior``
    ({"k","v"} [B,Pp,Hkv,hd], RoPE'd at absolute positions) with
    ``prior_valid`` [B] makes it suffix attention over a cached prefix;
    ``segment_ids`` [B,S] (with their ``segment_starts``, see
    :func:`ops.segment_run_starts`) a packed prefill, where a query sees
    only keys of its own segment."""
    if prior is None:
        return ops.flash_attention(q, k, v, causal=True, window=window,
                                   segment_ids=segment_ids,
                                   segment_starts=segment_starts)
    return ops.flash_attention(q, k, v, causal=True, window=window,
                               prior_k=prior["k"], prior_v=prior["v"],
                               prior_valid=prior_valid)


def kv_columns(cfg, h0: int, hq: int):
    """The kv heads [k0, k1) that query heads [h0, h0 + hq) read (GQA:
    head h reads kv head h // (H / Hkv)), refused where the flash kernel's
    grouping of the slice would differ: hq must hold whole groups or lie
    within one."""
    g = cfg.n_heads // cfg.n_kv_heads
    if hq % g and g % hq:
        raise ValueError(f"a shard of {hq} query heads splits GQA groups of "
                         f"{g}")
    k0 = h0 // g
    return k0, (h0 + hq - 1) // g + 1


def _slot_weights(p, cfg, sp, c):
    """Slot ``c``'s attention weights: its ``heads`` columns of ``wq``
    (rows of ``wo``) and the kv heads those read -- its ``kv_heads``
    block, or the columns of a replicated ``wk``/``wv``
    (:func:`kv_columns`) -- each gathered over ``data``."""
    lp = {k: sp.weight(w, c) for k, w in p.items()}
    nh = sp.count("heads")
    if sp.count("kv_heads") == 1 and nh > 1:
        hq, hd = cfg.n_heads // nh, cfg.head_dim
        k0, k1 = kv_columns(cfg, sp.index("heads", c) * hq, hq)
        for n in ("wk", "wv"):
            lp[n] = lp[n][:, k0 * hd:k1 * hd]
    return lp


def attention_sharded(p, cfg, h, sp, causal=True):
    """The training pass's tensor-parallel attention over the normalised
    residual ``h`` (a SlotPass activation): each slot gathers its batch
    rows at every position, projects them through its weights
    (:func:`_slot_weights`), runs the flash kernel over its head shard --
    causal, or bidirectional for an encoder (``causal=False``, no window)
    -- and multiplies by its rows of ``wo`` (row-parallel). Returns
    (partials [b, S, d] a slot, whether they sum over ``model``)."""
    partials = {}
    for c in sp.coords:
        lp = _slot_weights(p, cfg, sp, c)
        hg = sp.full_seq(h, c)
        q, k, v = project_qkv(lp, cfg, hg, sp.positions(c))
        o = ops.flash_attention(q, k, v, causal=causal,
                                window=cfg.sliding_window if causal else 0)
        partials[c] = o.reshape(hg.shape[:2] + (-1,)) @ lp["wo"]
    return partials, sp.count("heads") > 1


def cross_attention_sharded(p, cfg, h, enc, sp):
    """The training pass's cross-attention of an encoder-decoder's decoder
    layer (JAX's ``_cross_kv`` and ``_cross_attend_full`` under a training
    context), tensor-parallel as :func:`attention_sharded`: each slot's
    queries come from its batch rows of ``h`` (the normalised residual) at
    every position, through its ``heads`` columns of ``wq``; its keys and
    values from its batch rows of ``enc`` (the encoder's output, a tensor
    [B, F, d] split as a residual stream) gathered over every frame,
    through the kv heads its queries read; no RoPE; flash with
    ``causal=False`` over S queries and F keys; its rows of ``wo``.
    Returns (partials [b, S, d] a slot, whether they sum over
    ``model``)."""
    hd = cfg.head_dim
    partials = {}
    for c in sp.coords:
        lp = _slot_weights(p, cfg, sp, c)
        hg, e = sp.full_seq(h, c), sp.full_seq(enc, c)
        q = _split_heads(hg @ lp["wq"], hd)
        o = ops.flash_attention(q, _split_heads(e @ lp["wk"], hd),
                                _split_heads(e @ lp["wv"], hd), causal=False)
        partials[c] = o.reshape(hg.shape[:2] + (-1,)) @ lp["wo"]
    return partials, sp.count("heads") > 1


def decode_attention_update(q, k_new, v_new, k_cache, v_cache, lengths, *,
                            valid_len, shard_ctx=None):
    """Ring-write the new K/V at slot ``lengths % W`` (in place), then one
    token's attention over the first ``valid_len[b]`` ring slots.

    q, k_new, v_new: [B,1,H/Hkv,hd]; caches: [B,W,Hkv,hd]; lengths,
    valid_len: [B] int32. Returns out [B,1,H,hd].

    With a context whose rules shard ``kv_seq``, the caches are
    :class:`~repro_torch.sharding.partition.Sharded` by their sequence dim
    (``sharding.partition.place_for_ctx``) and both the write and the
    attention run per shard, as the JAX package's ``shard_map`` body does
    (:func:`seq_sharded_decode`): the decode kernel once a shard.
    """
    if shard_ctx is None or shard_ctx.kv_seq_axes is None:
        kvc.ring_write(k_cache, k_new, lengths)
        kvc.ring_write(v_cache, v_new, lengths)
        return ops.decode_attention(q, k_cache, v_cache, valid_len)

    def attend(locs, rows, vl):
        k_l, v_l = locs
        return ops.decode_attention(q[rows].to(k_l.device), k_l, v_l, vl,
                                    return_lse=True)

    return seq_sharded_decode((k_cache, v_cache), (k_new, v_new), lengths,
                              valid_len, attend, q.dtype)


def local_ring_write(cache_l, new, lengths, start: int, w_total: int):
    """Write row b's ``new[b, 0]`` into this shard's block ``cache_l`` [b,
    W_l, ...] of a ring of ``w_total`` slots, in place, where the global
    slot ``lengths[b] % w_total`` falls in ``[start, start + W_l)`` (JAX's
    ``_local_ring_write``). A select, not a scatter: every row writes its
    old value back where the slot lies in another shard, so nothing waits
    on the host."""
    B, W_l = cache_l.shape[:2]
    idx = torch.remainder(lengths.to(torch.int64), w_total) - start
    inside = (idx >= 0) & (idx < W_l)
    rows = torch.arange(B, device=cache_l.device)
    at = idx.clamp(0, W_l - 1)
    old = cache_l[rows, at]
    mask = inside.view((B,) + (1,) * (old.ndim - 1))
    cache_l[rows, at] = torch.where(mask, new[:, 0].to(cache_l.dtype), old)


def seq_sharded_decode(caches, news, lengths, valid_len, attend, out_dtype):
    """One decode token over caches split along their sequence dim (and
    their batch dim, by the batch axes): for each block, ring-write its
    share of ``news`` (:func:`local_ring_write`) and attend its ``W_l``
    slots with ``clamp(valid_len - start, 0, W_l)`` valid, through
    ``attend(local caches, batch rows, local valid) -> (out [b,1,H,*], lse
    [b,H])`` on the block's device; then merge each batch block's shards by
    the JAX package's rule -- ``m_g = pmax(m)``, ``num = psum(out *
    e^(m - m_g))``, ``den = psum(l * e^(m - m_g))`` -- which with each
    shard's normalised out and ``lse = m + log l`` reads ``m_g = pmax(lse)``,
    ``num = psum(out * e^(lse - m_g))``, ``den = psum(e^(lse - m_g))``. A
    shard with no valid slot has lse = -inf and weighs nothing. The result
    is whole on the mesh's first device, in ``out_dtype``."""
    lead = caches[0]
    if not isinstance(lead, Sharded):
        raise TypeError("a kv_seq-sharded decode takes its caches as "
                        "Sharded leaves: lay them out with "
                        "sharding.partition.place_for_ctx")
    mesh, first = lead.mesh, lead.mesh.first_device
    nb, ns = lead.counts()[:2]
    if any(axes_of(p) for p in lead.spec[2:]):
        raise ValueError(f"a cache split past its sequence dim: {lead.spec}")
    B, W = lead.shape[:2]
    b_l, w_l = B // nb, W // ns
    written, parts = set(), {}
    for coord in mesh.coords():
        bi, si = lead.block(coord)[:2]
        locs = [c.locals[coord] for c in caches]
        dev = locs[0].device
        rows = slice(bi * b_l, (bi + 1) * b_l)
        lens = lengths[rows].to(dev)
        for loc, new in zip(locs, news):
            if id(loc) not in written:  # a block held twice is written once
                written.add(id(loc))
                local_ring_write(loc, new[rows].to(dev), lens, si * w_l, W)
        if (bi, si) not in parts:
            vl = (valid_len[rows].to(dev) - si * w_l).clamp(0, w_l)
            parts[bi, si] = attend(locs, rows, vl.to(torch.int32))
    outs = []
    for bi in range(nb):
        shards = [parts[bi, si] for si in range(ns)]
        m_g = pmax([lse for _, lse in shards], first)
        m_g = torch.where(torch.isfinite(m_g), m_g, 0.0)  # no valid slot
        w = [torch.exp(lse.to(first) - m_g) for _, lse in shards]
        num = psum([o.float().to(first) * wi[:, None, :, None]
                    for (o, _), wi in zip(shards, w)], first)
        den = psum(w, first)[:, None, :, None]
        outs.append((num / den.clamp_min(1e-30)).to(out_dtype))
    return outs[0] if nb == 1 else torch.cat(outs)


def paged_decode_attention_update(q, k_new, v_new, blocks, page_table,
                                  lengths, *, valid_len):
    """Write the new K/V into the row's block at position ``lengths`` (in
    place, through the page table), then one token's attention over the
    row's first ``valid_len[b]`` positions through the paged kernel.
    Nothing is gathered.

    q, k_new, v_new: [B,1,H/Hkv,hd]; blocks: {"k","v"} [N+1,page,Hkv,hd];
    page_table: [B,n_pages] int32; lengths, valid_len: [B] int32. Returns
    out [B,1,H,hd].
    """
    kvc.paged_write(blocks["k"], k_new, lengths, page_table)
    kvc.paged_write(blocks["v"], v_new, lengths, page_table)
    return ops.paged_decode_attention(q, blocks["k"], blocks["v"], page_table,
                                      valid_len)
