"""DeepSeek-V2 multi-head latent attention (MLA), the counterpart of the JAX
package's ``models/mla.py``.

Each token caches one latent ``ckv`` (``kv_lora_rank`` wide, normalised)
and one RoPE key ``krope`` (``qk_rope_dim``) shared by every head: 1,152
bytes a token and layer in bf16 at deepseek-v2's 512 + 64, the natively
small serving payload.

Prefill decompresses the latent into per-head K (nope through ``wk_b``,
the shared RoPE key broadcast over heads) and V (through ``wv_b``) and runs
the flash kernel at q/k head dim 192 and v head dim 128. Decode runs the
*absorbed* form: ``wk_b`` is folded into the query (``q_abs``), so the
hand-written MLA decode kernel attends straight against the latent cache
(ring or paged), and ``wv_b`` then ``wo`` project its latent output. The
products with ``wk_b``, ``wv_b`` and the projections are plain matrix
products, as in JAX (outside any Pallas kernel there). The new latent
entries are written into the cache in place, as the GQA path writes K/V.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models import kvcache as kvc
from repro_torch.models.attention import seq_sharded_decode
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.schema import ParamSpec


def mla_schema(cfg) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    m = cfg.mla
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    s = {
        "wkv_a": ParamSpec((d, m.kv_lora_rank + m.qk_rope_dim), ("embed", "lora")),
        "kv_norm": ParamSpec((m.kv_lora_rank,), ("lora",), init="ones"),
        "wk_b": ParamSpec((m.kv_lora_rank, h, m.qk_nope_dim),
                          ("lora", "heads", None)),
        "wv_b": ParamSpec((m.kv_lora_rank, h, m.v_head_dim),
                          ("lora", "heads", None)),
        "wo": ParamSpec((h * m.v_head_dim, d), ("heads", "embed")),
    }
    if m.q_lora_rank:
        s["wq_a"] = ParamSpec((d, m.q_lora_rank), ("embed", "lora"))
        s["q_norm"] = ParamSpec((m.q_lora_rank,), ("lora",), init="ones")
        s["wq_b"] = ParamSpec((m.q_lora_rank, h * qk_dim), ("lora", "heads"))
    else:
        s["wq"] = ParamSpec((d, h * qk_dim), ("embed", "heads"))
    return s


def _scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim)


def _project_q(p, cfg, x):
    """x [..., d] -> (q_nope, q_rope) [..., H, nope] / [..., H, rope]; the
    low-rank query (``wq_a``, ``q_norm`` on the rmsnorm kernel, ``wq_b``)
    or the plain ``wq``."""
    m = cfg.mla
    if m.q_lora_rank:
        q = rmsnorm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    qk = m.qk_nope_dim + m.qk_rope_dim
    q = q.reshape(x.shape[:-1] + (q.shape[-1] // qk, qk))
    return q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]


def latent_kv(p, cfg, x, positions):
    """x [B,S,d] -> (c_kv [B,S,r] normalised, k_rope [B,S,rope] roped as
    one head): the cache entries."""
    r = cfg.mla.kv_lora_rank
    kv = x @ p["wkv_a"]
    c_kv = rmsnorm(kv[..., :r].contiguous(), p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, r:], positions, cfg.rope_theta)
    return c_kv, k_rope[..., 0, :]


def mla_prefill(p, cfg, x, positions, *, window: int = 0):
    """Decompressed MLA attention over a (right-padded) prompt batch x
    [B,S,d]. Returns (out [B,S,d], {"ckv": [B,S,r], "krope": [B,S,rope]}).

    ``k_nope`` and ``v`` are cast to the activation dtype before attention,
    as in JAX; the flash kernel runs q/k at nope + rope and v at
    ``v_head_dim``, scale ``1/sqrt(nope + rope)``."""
    m = cfg.mla
    q_nope, q_rope = _project_q(p, cfg, x)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = latent_kv(p, cfg, x, positions)
    k_nope = torch.einsum("bsr,rhd->bshd", c_kv, p["wk_b"]).to(x.dtype)
    v = torch.einsum("bsr,rhd->bshd", c_kv, p["wv_b"]).to(x.dtype)
    k = torch.cat([k_nope, k_rope[..., None, :].expand(
        k_nope.shape[:-1] + (m.qk_rope_dim,))], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = ops.flash_attention(q, k, v.contiguous(), causal=True,
                              window=window, scale=_scale(cfg))
    B, S = x.shape[:2]
    out = out.reshape(B, S, out.shape[2] * out.shape[3]) @ p["wo"]
    return out, {"ckv": c_kv, "krope": k_rope}


def mla_sharded(p, cfg, h, sp):
    """The training pass's MLA with ``heads`` over ``model`` (JAX's
    ``mla_prefill`` under a training context): the latent projections
    (``wkv_a``, ``wq_a``, the norms) stay whole, as JAX's rules leave
    ``lora`` unsplit, and every slot computes them for its batch rows at
    every position; the per-head ``wq_b``, ``wk_b`` and ``wv_b`` and the
    flash kernel (q/k 192, v 128 at deepseek-v2's widths) run on the
    slot's head shard; ``wo`` is row-parallel. Returns (partials [b, S, d]
    a slot, whether they sum over ``model``)."""
    partials = {}
    for c in sp.coords:
        lp = {k: sp.weight(w, c) for k, w in p.items()}
        partials[c] = mla_prefill(lp, cfg, sp.full_seq(h, c),
                                  sp.positions(c),
                                  window=cfg.sliding_window)[0]
    return partials, sp.count("heads") > 1


def _absorbed_query(p, cfg, x, positions):
    """x [B,1,d] -> (q_abs [B,1,H,r] in x's dtype, q_rope [B,1,H,rope])."""
    q_nope, q_rope = _project_q(p, cfg, x)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, p["wk_b"]).to(x.dtype)
    return q_abs, q_rope


def _project_out(p, cfg, ctx, x):
    """The latent context [B,1,H,r] -> [B,1,d] through ``wv_b``, then
    ``wo``."""
    out = torch.einsum("bqhr,rhd->bqhd", ctx, p["wv_b"]).to(x.dtype)
    return out.reshape(x.shape[0], 1, -1) @ p["wo"]


def mla_decode_update(p, cfg, x, cache, lengths, positions, *, valid_len,
                      shard_ctx=None):
    """One token of absorbed MLA decode over the latent ring: write both
    leaves of x's entry at slot ``lengths % W`` (in place), then attend the
    first ``valid_len[b]`` slots through the MLA decode kernel.

    x: [B,1,d]; cache: {"ckv": [B,W,r], "krope": [B,W,rope]}; lengths,
    valid_len: [B] int32; positions [B,1]. Returns out [B,1,d].

    With a context whose rules shard ``kv_seq``, both leaves are
    :class:`~repro_torch.sharding.partition.Sharded` by their sequence dim
    and the write and the attention run per shard (the MLA kernel once a
    shard), merged by the max/sum rule, as the JAX package's ``shard_map``
    body does (:func:`~repro_torch.models.attention.seq_sharded_decode`)."""
    q_abs, q_rope = _absorbed_query(p, cfg, x, positions)
    ckv_new, krope_new = latent_kv(p, cfg, x, positions)
    if shard_ctx is None or shard_ctx.kv_seq_axes is None:
        kvc.ring_write(cache["ckv"], ckv_new, lengths)
        kvc.ring_write(cache["krope"], krope_new, lengths)
        ctx = ops.mla_decode_attention(q_abs, q_rope, cache["ckv"],
                                       cache["krope"], valid_len,
                                       scale=_scale(cfg))
        return _project_out(p, cfg, ctx, x)

    def attend(locs, rows, vl):
        ckv_l, krope_l = locs
        dev = ckv_l.device
        return ops.mla_decode_attention(
            q_abs[rows].to(dev), q_rope[rows].to(dev), ckv_l, krope_l, vl,
            scale=_scale(cfg), return_lse=True)

    ctx = seq_sharded_decode((cache["ckv"], cache["krope"]),
                             (ckv_new, krope_new), lengths, valid_len,
                             attend, q_abs.dtype)
    return _project_out(p, cfg, ctx, x)


def paged_mla_decode_update(p, cfg, x, blocks, page_table, lengths,
                            positions, *, valid_len):
    """:func:`mla_decode_update` over the latent block pool: both leaves
    written into the row's block at position ``lengths`` (in place, through
    the page table), then the paged MLA decode kernel. Nothing is gathered.

    blocks: {"ckv": [N+1,page,r], "krope": [N+1,page,rope]}; page_table:
    [B,n_pages] int32."""
    q_abs, q_rope = _absorbed_query(p, cfg, x, positions)
    ckv_new, krope_new = latent_kv(p, cfg, x, positions)
    kvc.paged_write(blocks["ckv"], ckv_new, lengths, page_table)
    kvc.paged_write(blocks["krope"], krope_new, lengths, page_table)
    ctx = ops.paged_mla_decode_attention(q_abs, q_rope, blocks["ckv"],
                                         blocks["krope"], page_table,
                                         valid_len, scale=_scale(cfg))
    return _project_out(p, cfg, ctx, x)
