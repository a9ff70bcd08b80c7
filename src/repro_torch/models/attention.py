"""GQA attention: projections, prefill through the flash kernel (with a
cached prefix for suffix prefill), ring decode through the decode kernel and
paged decode through the paged kernel (the plain PyTorch versions on the
CPU).

Unlike the JAX package, whose model runs pure-jnp attention beside its
Pallas kernels, the port's model calls the kernels, so on the card they do
the real work of the serving path.
"""

from __future__ import annotations

from repro_torch.kernels import ops
from repro_torch.models import kvcache as kvc
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.schema import ParamSpec


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


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def project_qkv(p, cfg, x, positions):
    """x: [B,S,d] -> q [B,S,H,hd], k/v [B,S,Hkv,hd] with qk-norm + RoPE."""
    q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    k = _split_heads(x @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(x @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
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


def decode_attention_update(q, k_new, v_new, k_cache, v_cache, lengths, *,
                            valid_len):
    """Ring-write the new K/V at slot ``lengths % W`` (in place), then one
    token's attention over the first ``valid_len[b]`` ring slots.

    q, k_new, v_new: [B,1,H/Hkv,hd]; caches: [B,W,Hkv,hd]; lengths,
    valid_len: [B] int32. Returns out [B,1,H,hd].
    """
    kvc.ring_write(k_cache, k_new, lengths)
    kvc.ring_write(v_cache, v_new, lengths)
    return ops.decode_attention(q, k_cache, v_cache, valid_len)


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
