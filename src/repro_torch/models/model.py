"""Top-level Model of the port: schema, init, prefill and decode entry points.

Functional like the JAX package's ``Model``: parameters and caches are plain
nested dicts/lists of tensors that the caller passes in. The model lives on
one device, CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import kvcache as kvc
from repro_torch.models import schema as sch
from repro_torch.models.layers import (
    embed_lookup,
    embed_schema,
    lm_head,
    pad_vocab,
    rmsnorm,
    rmsnorm_schema,
)
from repro_torch.models.transformer import (
    layer_groups,
    stack_apply_decode,
    stack_apply_decode_paged,
    stack_apply_full,
    stack_schema,
)


class Model:
    """Decoder-only model: dense attention stacks and Mamba-2 (SSM) stacks.

    ``device`` defaults to CUDA; with no CUDA device the constructor raises
    unless ``device="cpu"`` is given. Every tensor method expects its
    inputs on :attr:`device`.
    """

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                 device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.groups = layer_groups(cfg)
        self._schema = self.schema()  # raises for layer kinds not yet ported

    @property
    def attention_only(self) -> bool:
        """True when every layer is attention: only then does right-padding
        (bucketed and suffix prefill) leave the caches exact -- pad tokens
        would flow through an SSM layer's conv window and state."""
        return all(kind == "attn" for g in self.groups for (kind, _) in g.sigs)

    def _require_attention_only(self, what: str):
        if not self.attention_only:
            raise ValueError(
                f"{what} right-pads its rows, which would push pad tokens "
                f"into the recurrent state of {self.cfg.name}'s SSM layers: "
                "use the exact-shape prefill")

    # ------------------------------------------------------------------ #
    # Schema / params
    # ------------------------------------------------------------------ #
    def schema(self) -> dict:
        cfg = self.cfg
        return {
            "embed": embed_schema(pad_vocab(cfg.vocab_size), cfg.d_model),
            "final_norm": rmsnorm_schema(cfg.d_model),
            "decoder": stack_schema(cfg),
        }

    def init(self, generator: torch.Generator) -> dict:
        """Seeded weights drawn on the model's device from ``generator``
        (which must live on that device)."""
        return sch.init_params(generator, self._schema, self.dtype, self.device)

    # ------------------------------------------------------------------ #
    # Forward passes
    # ------------------------------------------------------------------ #
    def backbone(self, params, tokens):
        """Embed + decoder stack + final norm over [B, S] tokens.
        Returns (x [B,S,d], caches)."""
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        x, caches = stack_apply_full(params["decoder"], self.cfg, x, pos,
                                     groups=self.groups)
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        return x, caches

    def forward(self, params, tokens):
        """Full-sequence logits [B, S, vocab_padded] and caches."""
        x, caches = self.backbone(params, tokens)
        return lm_head(params["embed"], x, self.cfg.vocab_size), caches

    def prefill(self, params, tokens):
        """tokens [B, S] -> (last_logits [B,V], caches, lengths [B]); the LM
        head runs on the last position only."""
        x, caches = self.backbone(params, tokens)
        B, S = x.shape[:2]
        logits = lm_head(params["embed"], x[:, -1:], self.cfg.vocab_size)
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        return logits[:, 0], caches, lengths

    def prefill_bucketed(self, params, tokens, lengths):
        """Padded-bucket prefill: tokens [B, L] right-padded, lengths [B]
        real. Causal attention hides trailing pad from real positions, so
        only the LM-head gather differs from :meth:`prefill`: logits are
        read at each row's last real position. Pad positions write garbage
        KV that decode never reads (valid_len masks it and the next real
        token overwrites slot ``lengths % W``). Attention-only stacks; raises
        ValueError for others. Returns (last_logits [B,V], caches, lengths
        int32)."""
        self._require_attention_only("prefill_bucketed")
        x, caches = self.backbone(params, tokens)
        S = x.shape[1]
        idx = torch.clamp(lengths.to(torch.int64) - 1, 0, S - 1)
        rows = torch.arange(x.shape[0], device=x.device)
        x_last = x[rows, idx][:, None]  # [B,1,d]
        logits = lm_head(params["embed"], x_last, self.cfg.vocab_size)
        return logits[:, 0], caches, lengths.to(torch.int32)

    def prefill_suffix(self, params, tokens, lengths, cached_lens, prior_pt,
                       blocks):
        """Suffix-only bucketed prefill over a cached prefix (paged reuse).

        tokens [B, L] hold each row's UNCACHED suffix (right-padded,
        ``lengths`` [B] real suffix lengths); ``cached_lens`` [B] int32 is
        each row's reused prefix, whose already-RoPE'd KV lives in
        ``blocks`` (the paged pool tree) at the pages ``prior_pt`` [B, Pn]
        names (Pn pages: the group's longest prefix; shorter rows pad with
        the zero sentinel). Queries run at absolute positions
        ``cached_lens[b] + i``; each layer gathers its own prior right
        before its flash launch. Returns (first_logits [B,V],
        suffix_caches, total_lengths = cached_lens + lengths); the caches
        hold ONLY the suffix KV. Attention-only stacks; raises ValueError
        for others.
        """
        return self._suffix(params, tokens, lengths, cached_lens,
                            prior_blocks=blocks, prior_pt=prior_pt)

    def prefill_suffix_dense(self, params, tokens, lengths, cached_lens,
                             prior):
        """:meth:`prefill_suffix` over a dense prior: ``prior`` is a cache
        tree ({"k","v"} [B, Pp, Hkv, hd] a layer, RoPE'd at absolute
        positions) of which row b uses its first ``cached_lens[b]`` slots
        (the JAX package's ``prefill_suffix``). One chunk of a chunked
        prefill runs through it against the request's fixed-width prior."""
        return self._suffix(params, tokens, lengths, cached_lens, prior=prior)

    def _suffix(self, params, tokens, lengths, cached_lens, **prior):
        self._require_attention_only("prefill_suffix")
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        S = x.shape[1]
        pos = cached_lens.to(torch.int64)[:, None] + torch.arange(
            S, device=x.device)[None, :]
        x, caches = stack_apply_full(
            params["decoder"], self.cfg, x, pos, groups=self.groups,
            prior_valid=cached_lens, **prior)
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        idx = torch.clamp(lengths.to(torch.int64) - 1, 0, S - 1)
        rows = torch.arange(x.shape[0], device=x.device)
        logits = lm_head(params["embed"], x[rows, idx][:, None],
                         self.cfg.vocab_size)
        total = (cached_lens + lengths).to(torch.int32)
        return logits[:, 0], caches, total

    def prefill_packed(self, params, tokens, positions, segment_ids,
                       last_idx):
        """Token-packed prefill: several prompts back to back in ONE row.

        tokens [1, T] hold the segments (pad token 0 after the last);
        ``positions`` [1, T] restart at 0 in each segment, so RoPE matches
        an unpacked prefill; ``segment_ids`` [1, T] int32 give each token's
        segment (-1 on pads), each segment one contiguous run; ``last_idx``
        [N] is the packed index of each segment's last token (dummy
        segments may point anywhere: the caller drops their logits).
        Attention is segment-masked, so each segment's hidden states and
        its KV run in the packed caches are what a lone prefill of that
        prompt gives, up to summation order. The run starts the flash
        kernel skips by are built once here for every layer. Returns
        (last_logits [N, V], packed caches with [1, T, Hkv, hd] k/v
        leaves). Attention-only stacks; raises ValueError for others."""
        self._require_attention_only("prefill_packed")
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        x, caches = stack_apply_full(
            params["decoder"], self.cfg, x, positions, groups=self.groups,
            segment_ids=segment_ids,
            segment_starts=ops.segment_run_starts(segment_ids))
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        x_last = x[0, last_idx.to(torch.int64)][None]  # [1, N, d]
        logits = lm_head(params["embed"], x_last, self.cfg.vocab_size)
        return logits[0], caches

    def decode_step(self, params, caches, tokens, lengths):
        """tokens [B,1], lengths [B] int32 -> (logits [B,V], caches,
        lengths+1). The caches are ring-written in place and returned."""
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        x = stack_apply_decode(params["decoder"], self.cfg, x, caches, lengths,
                               groups=self.groups)
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        logits = lm_head(params["embed"], x, self.cfg.vocab_size)
        return logits[:, 0], caches, lengths + 1

    def decode_step_paged(self, params, blocks, page_table, tokens, lengths):
        """One decode step over the paged pool: tokens [B,1], page_table
        [B, n_pages] int32, lengths [B] int32 -> (logits [B,V], lengths+1).
        Each layer writes its new K/V into the row's block and attends
        through the page table (the paged kernel on the card); ``blocks``
        are updated in place."""
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        x = stack_apply_decode_paged(params["decoder"], self.cfg, x, blocks,
                                     page_table, lengths, groups=self.groups)
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        logits = lm_head(params["embed"], x, self.cfg.vocab_size)
        return logits[:, 0], lengths + 1

    # ------------------------------------------------------------------ #
    # Cache construction
    # ------------------------------------------------------------------ #
    def _seq_budget(self, seq_len: int) -> int:
        if self.cfg.sliding_window:
            return min(seq_len, self.cfg.sliding_window)
        return seq_len

    def cache_specs(self, B: int, seq_len: int) -> dict:
        """Shapes of the cache tree for B rows of ``seq_len`` ring slots
        (an SSM layer's shapes do not depend on ``seq_len``)."""
        W = self._seq_budget(seq_len)
        return {
            f"g{gi}": [
                {f"l{j}": kvc.layer_cache_shapes(self.cfg, sig, B, W)
                 for j, sig in enumerate(g.sigs)}
                for _ in range(g.count)
            ]
            for gi, g in enumerate(self.groups)
        }

    def init_cache(self, B: int, seq_len: int, dtype=None) -> dict:
        """Zeroed caches on the model's device, each leaf in ``dtype``
        (default: the model's) except the SSM state, which is fp32."""
        dtype = dtype or self.dtype
        return {
            gname: [{lname: kvc.init_layer_cache(shapes, dtype, self.device)
                     for lname, shapes in block.items()} for block in group]
            for gname, group in self.cache_specs(B, seq_len).items()
        }
