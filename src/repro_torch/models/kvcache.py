"""KV caches as nested dicts/lists of tensors: ring caches and the paged
block pool.

An attention layer's cache is ``{"k": [B, W, Hkv, hd], "v": [B, W, Hkv, hd]}``,
an MLA layer's ``{"ckv": [B, W, kv_lora_rank], "krope": [B, W, qk_rope_dim]}``
(one latent and one shared RoPE key a token); an encoder-decoder's
decoder layer adds the static cross-attention leaves ``{"xk", "xv"}: [B,
F, Hkv, hd]`` (the encoder's F rows, written once by the prefill); an SSM
layer's is
``{"conv": [B, K-1, d_in + 2 ds], "state": [B, nh, hd, ds]}``, its state
in fp32 whatever the model's dtype. Ring semantics: token
``t`` of a row lives at slot ``t % W``, so a prefill of ``true_len <= W``
tokens occupies slots ``[0, true_len)`` and a full ring models a
sliding-window cache exactly (W = window). SSM leaves and the cross
leaves have no ring: they always move whole.

Unlike the JAX package, whose arrays are immutable, :func:`ring_write`,
:func:`scatter_pages`, :func:`paged_write` and :func:`splice_suffix` update
the cache in place: the decode step (and a chunked admission) then holds
one cache buffer, as the JAX engine gets by donating it.
"""

from __future__ import annotations

import numpy as np
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


def attn_cache_shapes(cfg, B: int, W: int, enc_len: int = 0) -> dict:
    """An attention layer's leaves; an encoder-decoder's with ``enc_len``
    encoder rows adds xk/xv."""
    if cfg.mla is not None:
        m = cfg.mla
        s = {"ckv": (B, W, m.kv_lora_rank), "krope": (B, W, m.qk_rope_dim)}
    else:
        s = {"k": (B, W, cfg.n_kv_heads, cfg.head_dim),
             "v": (B, W, cfg.n_kv_heads, cfg.head_dim)}
    if cfg.is_encdec and enc_len:
        s["xk"] = (B, enc_len, cfg.n_kv_heads, cfg.head_dim)
        s["xv"] = (B, enc_len, cfg.n_kv_heads, cfg.head_dim)
    return s


def ssm_cache_shapes(cfg, B: int) -> dict:
    s = cfg.ssm
    d_in = cfg.d_model * s.expand
    nh = s.n_heads(cfg.d_model)
    return {
        "conv": (B, s.d_conv - 1, d_in + 2 * s.d_state),
        "state": (B, nh, s.head_dim, s.d_state),
    }


def layer_cache_shapes(cfg, sig, B: int, W: int, enc_len: int = 0) -> dict:
    kind, _ = sig
    if kind == "attn":
        return attn_cache_shapes(cfg, B, W, enc_len)
    return ssm_cache_shapes(cfg, B)


# leaves with a ring (sequence) dim at axis 1: GQA's k/v, MLA's latents
# (the cross leaves xk/xv are static: every encoder row, never ring-written)
SEQ_KEYS = ("k", "v", "ckv", "krope")
_F32_KEYS = ("state",)  # the SSM state carries fp32 for numerical stability


def leaf_dtype(key: str, dtype):
    """A cache leaf's dtype: fp32 for the SSM state, else the model's."""
    return torch.float32 if key in _F32_KEYS else dtype


def cache_logical_axes(cfg, sig, kv_seq_sharded: bool) -> dict:
    """Logical axes of each of a layer's cache leaves (the JAX package's
    ``cache_logical_axes``): with the sequence sharded (``kv_seq``, decode),
    the heads stay local."""
    kind, _ = sig
    seq_ax = "kv_seq" if kv_seq_sharded else "seq"
    kvh = None if kv_seq_sharded else "kv_heads"
    if kind == "attn":
        if cfg.mla is not None:
            ax = {"ckv": ("batch", seq_ax, None),
                  "krope": ("batch", seq_ax, None)}
        else:
            ax = {"k": ("batch", seq_ax, kvh, None),
                  "v": ("batch", seq_ax, kvh, None)}
        if cfg.is_encdec:
            ax["xk"] = ("batch", None, "kv_heads", None)
            ax["xv"] = ("batch", None, "kv_heads", None)
        return ax
    return {"conv": ("batch", None, "ssm_in"),
            "state": ("batch", "ssm_heads", None, None)}


def init_layer_cache(shapes: dict, dtype, device) -> dict:
    """Zeroed leaves of one layer's cache, each in its :func:`leaf_dtype`."""
    return {k: torch.zeros(s, dtype=leaf_dtype(k, dtype), device=device)
            for k, s in shapes.items()}


def grow_cache(caches, new_w: int):
    """Zero-pad the ring dim (axis 1) of every sequence leaf (k/v, MLA's
    ckv/krope) of a prefill cache tree to ``new_w`` so decode can append;
    SSM and cross (xk/xv) leaves stay as they are."""

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        w = tree.shape[1]
        if key not in SEQ_KEYS or w >= new_w:
            return tree
        # pad spec runs from the last dim: every dim after W unpadded
        return F.pad(tree, (0, 0) * (tree.ndim - 2) + (0, new_w - w))

    return walk(caches)


def _map_keyed(fn, tree, key=None):
    """``fn(leaf, key)`` over a cache tree, ``key`` the leaf's dict key."""
    if isinstance(tree, dict):
        return {k: _map_keyed(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_keyed(fn, v, key) for v in tree]
    return fn(tree, key)


def slice_cache(caches, n_rows: int, prefix_len: int):
    """A cache tree cut to its valid extent: the first ``n_rows`` rows of
    every leaf and, for the sequence leaves, the first ``prefix_len`` ring
    slots, both clamped to the leaf (views, no copy). SSM conv/state and
    cross xk/xv leaves keep their whole rows. What a disaggregated handoff
    puts on the wire: a prefill writes slots ``[0, true_len)``, so a
    ``prefix_len`` at or above every row's length loses nothing. :func:`pad_cache_rows` is its
    row inverse."""

    def cut(leaf, key):
        leaf = leaf[:n_rows]
        return leaf[:, :prefix_len] if key in SEQ_KEYS else leaf

    return _map_keyed(cut, caches)


def pad_cache_rows(caches, n_rows: int):
    """Zero-pad the batch dim (axis 0) of a row-sliced cache tree back to
    ``n_rows``; leaves already that wide are returned as they are."""

    def pad(leaf, key):
        extra = n_rows - leaf.shape[0]
        if extra <= 0:
            return leaf
        return F.pad(leaf, (0, 0) * (leaf.ndim - 1) + (0, extra))

    return _map_keyed(pad, caches)


def unpack_segments(caches, seg_starts, out_w: int):
    """Un-pack a packed-prefill cache tree into per-segment rows.

    ``caches`` come from :meth:`Model.prefill_packed`: every k/v leaf is
    ``[1, T, Hkv, hd]`` with segment ``j``'s KV at packed slots
    ``[seg_starts[j], seg_starts[j] + len_j)``. Each leaf becomes ``[N,
    out_w, Hkv, hd]`` (N = len(seg_starts), an int tensor on the leaves'
    device): row ``j`` reads ``out_w`` consecutive packed slots from its
    start, clipped at T-1, so a short or dummy segment trails its
    neighbours' KV, which decode masks by length as it masks bucketed
    prefill's pad. Packed prefill is attention-only, so no SSM leaf
    appears."""
    T = _first_leaf(caches).shape[1]
    win = (seg_starts.to(torch.int64)[:, None]
           + torch.arange(out_w, device=seg_starts.device)[None, :])
    win = win.clamp(max=T - 1)
    return tree_map(lambda leaf: leaf[0][win], caches)


def splice_suffix(prior, suffix, offset):
    """Write a suffix cache tree into a same-layout prior at ring
    ``offset``, in place; returns ``prior``.

    prior/suffix k/v leaves: ``[B, W, Hkv, hd]`` / ``[B, C, Hkv, hd]`` with
    C <= W; ``offset`` is a one-element int tensor on the leaves' device,
    clamped into ``[0, W - C]`` as ``jax.lax.dynamic_update_slice`` clamps
    it, so one code path serves every chunk of a chunked prefill with no
    host sync."""
    C = _first_leaf(suffix).shape[1]
    W = _first_leaf(prior).shape[1]
    start = offset.reshape(-1)[:1].to(torch.int64).clamp(0, W - C)
    idx = start + torch.arange(C, device=start.device)

    def put(p_leaf, s_leaf):
        p_leaf.index_copy_(1, idx, s_leaf.to(p_leaf.dtype))

    _zip_leaves(put, prior, suffix)
    return prior


def _first_leaf(tree):
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def request_cache_nbytes(caches, true_len: int, *, itemsize=None) -> int:
    """Bytes of ONE sequence's live cache in a pooled or padded tree: the
    sequence leaves count their per-token bytes times ``true_len`` (clamped to
    the ring width), SSM conv/state leaves their whole row. The pool's
    batch and ring padding is excluded. ``itemsize``: optional fn(leaf) ->
    bytes per element for a wire format (int8 host staging)."""
    total = 0

    def count(leaf, key):
        nonlocal total
        isz = itemsize(leaf) if itemsize else leaf.element_size()
        B = leaf.shape[0]
        if key in SEQ_KEYS:
            W = leaf.shape[1]
            total += leaf.numel() // (B * W) * min(true_len, W) * isz
        else:
            total += leaf.numel() // B * isz

    _map_keyed(count, caches)
    return total


# --------------------------------------------------------------------------- #
# Paged KV pool: fixed-size blocks + per-request page tables + refcounts.
#
# A paged layer cache is {"k","v"}: [N + 1, page, Hkv, hd] -- the dense
# [B, W, Hkv, hd] leaf with (batch, ring) replaced by (block, page). Block 0
# is the permanent zero sentinel: page tables initialise to it and gathers
# through it read zeros (masked by the valid length downstream). JAX sends a
# write aimed at the sentinel out of bounds, where its scatter drops it; a
# CUDA index_put would write it (or fault). So the pool carries one extra
# *sink* block, index N, that no page table ever maps: device-side writes
# aimed at the sentinel are redirected there with torch.where (no host
# sync), and host-built writes drop sentinel rows on the host.
# --------------------------------------------------------------------------- #
def paged_specs(dense_specs, num_blocks: int, page_size: int):
    """Shape tree of the block pool backing ``dense_specs`` (a dense
    ``(B, W, Hkv, hd)`` cache-shape tree): ``num_blocks`` blocks (block 0
    the sentinel) plus the write sink, ``page_size`` rows each."""
    return tree_map(lambda s: (num_blocks + 1, page_size) + tuple(s[2:]),
                    dense_specs)


def init_paged(dense_specs, num_blocks: int, page_size: int, *, dtype,
               device):
    """Zeroed block pool tree (block 0 = the zero sentinel, block
    ``num_blocks`` = the write sink)."""
    return tree_map(lambda s: torch.zeros(s, dtype=dtype, device=device),
                    paged_specs(dense_specs, num_blocks, page_size))


def gather_leaf(blocks, page_table):
    """blocks: [N(+1), page, ...]; page_table: [B, n_pages] int -> the dense
    [B, n_pages * page, ...] rows, pages in table order. Ids are clamped
    into the pool like the JAX gather's ``mode="clip"``."""
    B, n_pages = page_table.shape
    idx = page_table.to(torch.int64).clamp(0, blocks.shape[0] - 1)
    g = blocks[idx]  # [B, n_pages, page, ...]
    return g.reshape((B, n_pages * blocks.shape[1]) + tuple(blocks.shape[2:]))


def gather_pages(paged, page_table):
    """Materialise per-request dense caches from a block pool tree:
    ``[B, n_pages * page, Hkv, hd]`` per leaf; unallocated entries (block
    0) read zeros."""
    return tree_map(lambda leaf: gather_leaf(leaf, page_table), paged)


def scatter_pages(paged, dense, dest_blocks):
    """Write a dense ``[B, L, Hkv, hd]`` tree into the pool page-wise, in
    place; returns the pool tree.

    ``dest_blocks``: host ``[B, L / page]`` int destination block per page.
    Entries that are the zero sentinel or out of range (dummy admission
    rows, pages past a row's table) are dropped on the host before the
    device write, as JAX's scatter drops them.
    """
    dest = np.asarray(dest_blocks).reshape(-1)

    def put(blocks, new):
        B, L = new.shape[:2]
        page = blocks.shape[1]
        keep = np.nonzero((dest > 0) & (dest < blocks.shape[0] - 1))[0]
        if keep.size == 0:
            return
        pages = new.reshape((B * (L // page), page) + tuple(new.shape[2:]))
        sel = torch.as_tensor(keep, device=new.device)
        ids = torch.as_tensor(dest[keep].astype(np.int64), device=blocks.device)
        blocks[ids] = pages[sel].to(blocks.dtype)

    _zip_leaves(put, paged, dense)
    return paged


def paged_write(blocks, new, lengths, page_table):
    """The paged counterpart of the JAX package's ``scatter_token``: write
    row b's new entry ``new[b, 0]`` at block ``page_table[b, slot // page]``,
    offset ``slot % page``, with ``slot = lengths[b] % (n_pages * page)``,
    in place. Rows whose entry is the zero sentinel (freed or never
    admitted slots) write the sink block instead. Returns ``blocks``."""
    B, n_pages = page_table.shape
    page = blocks.shape[1]
    slot = torch.remainder(lengths.to(torch.int64), n_pages * page)
    blk = torch.gather(page_table.to(torch.int64), 1,
                       (slot // page)[:, None])[:, 0]
    blk = torch.where(blk == 0, blocks.shape[0] - 1, blk)
    blocks[blk, slot % page] = new[:, 0].to(blocks.dtype)
    return blocks


def _zip_leaves(fn, a, b):
    """Call ``fn(leaf_a, leaf_b)`` on paired leaves of two trees."""
    if isinstance(a, dict):
        for k in a:
            _zip_leaves(fn, a[k], b[k])
    elif isinstance(a, list):
        for x, y in zip(a, b):
            _zip_leaves(fn, x, y)
    else:
        fn(a, b)


class PagedKVPool:
    """Host-side allocator for a block pool: refcounts + free list (a copy
    of the JAX package's ``PagedKVPool``).

    The device blocks live with their owner (the decode pool); this class
    owns only the bookkeeping that makes shared prefixes safe: a block is
    reusable only when its refcount reaches zero, so an evicting prefix
    index can never free a block a live request still reads. Block 0 is the
    permanent zero sentinel and is never handed out.
    """

    def __init__(self, num_blocks: int, page_size: int):
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2: {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.page = int(page_size)
        self.reset()

    def reset(self):
        self.refs = np.zeros((self.num_blocks,), np.int32)
        self.refs[0] = 1  # sentinel: permanently live
        # pop() from the end -> ascending allocation order (deterministic)
        self._free = list(range(self.num_blocks - 1, 0, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        """Blocks currently referenced (excluding the sentinel)."""
        return int((self.refs[1:] > 0).sum())

    def alloc(self, n: int):
        """Claim ``n`` blocks (refcount 1 each) or None if short."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self.refs[b] = 1
        return out

    def ref(self, ids):
        for b in ids:
            if b == 0:
                continue
            if self.refs[b] <= 0:
                raise RuntimeError(f"ref of a free block {b}")
            self.refs[b] += 1

    def deref(self, ids) -> list:
        """Drop one reference per id; returns the ids that became free."""
        freed = []
        for b in ids:
            if b == 0:
                continue
            if self.refs[b] <= 0:
                raise RuntimeError(f"deref of a free block {b}")
            self.refs[b] -= 1
            if self.refs[b] == 0:
                self._free.append(int(b))
                freed.append(int(b))
        return freed
