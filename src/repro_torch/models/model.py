"""Top-level Model of the port: schema, init, prefill and decode entry points.

Functional like the JAX package's ``Model``: parameters and caches are plain
nested dicts/lists of tensors that the caller passes in. The model lives on
one device, CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
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
    stack_apply_full,
    stack_schema,
)


class Model:
    """Decoder-only model (attention-only, dense FFN stacks in this slice).

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
        token overwrites slot ``lengths % W``). Returns (last_logits [B,V],
        caches, lengths int32)."""
        x, caches = self.backbone(params, tokens)
        S = x.shape[1]
        idx = torch.clamp(lengths.to(torch.int64) - 1, 0, S - 1)
        rows = torch.arange(x.shape[0], device=x.device)
        x_last = x[rows, idx][:, None]  # [B,1,d]
        logits = lm_head(params["embed"], x_last, self.cfg.vocab_size)
        return logits[:, 0], caches, lengths.to(torch.int32)

    def decode_step(self, params, caches, tokens, lengths):
        """tokens [B,1], lengths [B] int32 -> (logits [B,V], caches,
        lengths+1). The caches are ring-written in place and returned."""
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        x = stack_apply_decode(params["decoder"], self.cfg, x, caches, lengths,
                               groups=self.groups)
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        logits = lm_head(params["embed"], x, self.cfg.vocab_size)
        return logits[:, 0], caches, lengths + 1

    # ------------------------------------------------------------------ #
    # Cache construction
    # ------------------------------------------------------------------ #
    def _seq_budget(self, seq_len: int) -> int:
        if self.cfg.sliding_window:
            return min(seq_len, self.cfg.sliding_window)
        return seq_len

    def cache_specs(self, B: int, seq_len: int) -> dict:
        """Shapes of the ring cache tree for B rows of ``seq_len`` slots."""
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
        """Zeroed ring caches on the model's device."""
        dtype = dtype or self.dtype
        return sch.tree_map(
            lambda shape: torch.zeros(shape, dtype=dtype, device=self.device),
            self.cache_specs(B, seq_len))
