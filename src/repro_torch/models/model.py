"""Top-level Model of the port: schema, init, prefill and decode entry points.

Functional like the JAX package's ``Model``: parameters and caches are plain
nested dicts/lists of tensors that the caller passes in. The model lives on
one device, CUDA unless the caller asks for the CPU.

A config with a ``frontend`` (pixtral-12b) takes feature payloads: the
modality encoder is a stub, as in the JAX package, and the caller supplies
its output, ``features`` [B, F, FRONTEND_DIM], which a linear projector
(``frontend_proj``) maps into the residual stream ahead of the prompt's
token embeddings. An encoder-decoder (seamless-m4t) takes them as its
encoder's input instead: ``frontend_proj``, the bidirectional encoder and
``enc_norm`` give the rows every decoder layer cross-attends to, and the
prefill writes each layer's cross keys and values into static ``xk``/``xv``
cache leaves that decode reads whole.
"""

from __future__ import annotations

import copy

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import kvcache as kvc
from repro_torch.models import schema as sch
from repro_torch.models.layers import (
    cross_entropy,
    embed_lookup,
    embed_schema,
    lm_head,
    pad_vocab,
    rmsnorm,
    rmsnorm_schema,
)
from repro_torch.models.transformer import (
    REMAT_POLICIES,
    encoder_apply,
    encoder_schema,
    layer_groups,
    stack_apply_decode,
    stack_apply_decode_paged,
    stack_apply_full,
    stack_schema,
)

FRONTEND_DIM = 1024  # stubbed ViT / speech-encoder feature width


class Model:
    """Attention stacks (GQA or MLA, dense or MoE FFNs, with or without a
    feature frontend), Mamba-2 (SSM) stacks, hybrids of the two (jamba)
    and the encoder-decoder (seamless-m4t).

    ``device`` defaults to CUDA; with no CUDA device the constructor raises
    unless ``device="cpu"`` is given. Every tensor method expects its
    inputs on :attr:`device`.

    ``remat`` and ``remat_policy`` (JAX's ``Model`` fields) set what a
    training pass (:meth:`loss`) saves for the backward: with ``remat``
    each layer is rematerialised under the policy (``"full"``, ``"dots"``
    or ``"none"``, see :func:`repro_torch.models.transformer.remat_call`);
    without it everything is saved.
    """

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                 device="cuda", remat: bool = False,
                 remat_policy: str = "full"):
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r} not in "
                             f"{REMAT_POLICIES}")
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.remat = remat
        self.remat_policy = remat_policy
        self.groups = layer_groups(cfg)
        self._schema = self.schema()

    def on(self, device) -> "Model":
        """This model (config, dtype, remat) on ``device``: itself where it
        already lives there, else a shallow copy whose :attr:`device` --
        where :meth:`init` and :meth:`init_cache` allocate -- is
        ``device``. A placed stage (the disaggregated tier's prefill or
        decode side, a cluster replica) runs the model on its slice's
        device this way."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        out = copy.copy(self)
        out.device = dev
        return out

    @property
    def attention_only(self) -> bool:
        """True when every layer is attention: only then does right-padding
        (bucketed and suffix prefill) leave the caches exact -- pad tokens
        would flow through an SSM layer's conv window and state."""
        return all(kind == "attn" for g in self.groups for (kind, _) in g.sigs)

    def _require_attention_only(self, what: str):
        """Refuse the serving engine's padded and packed prefills where
        they would be wrong: an SSM layer's state, or an encoder-decoder
        (its decoder needs the encoder's rows, which they do not take)."""
        if self.cfg.is_encdec:
            raise ValueError(f"{what} takes no encoder input: "
                             f"{self.cfg.name} is an encoder-decoder")
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
        s = {
            "embed": embed_schema(pad_vocab(cfg.vocab_size), cfg.d_model),
            "final_norm": rmsnorm_schema(cfg.d_model),
            "decoder": stack_schema(cfg),
        }
        if cfg.is_encdec:
            s["encoder"] = encoder_schema(cfg)
            s["enc_norm"] = rmsnorm_schema(cfg.d_model)
        if cfg.frontend:
            s["frontend_proj"] = sch.ParamSpec((FRONTEND_DIM, cfg.d_model),
                                                ("frontend", "embed"))
        return s

    def init(self, generator: torch.Generator) -> dict:
        """Seeded weights drawn on the model's device from ``generator``
        (which must live on that device)."""
        return sch.init_params(generator, self._schema, self.dtype, self.device)

    def param_specs(self) -> dict:
        """The parameters as shape-only meta tensors (the dry-run's)."""
        return sch.meta_params(self._schema, self.dtype)

    def param_pspecs(self, rules: dict) -> dict:
        """One partition spec a parameter leaf under ``rules`` (JAX's
        ``Model.param_pspecs``, in the port's one-entry-a-layer layout)."""
        return sch.partition_specs(self._schema, rules)

    # ------------------------------------------------------------------ #
    # Forward passes
    # ------------------------------------------------------------------ #
    def _embed_inputs(self, params, tokens, features=None, shard_ctx=None):
        """Token embeddings [B, S, d], with ``features`` [B, F,
        FRONTEND_DIM] (any float dtype) projected and prepended: cast to
        the model's dtype BEFORE ``frontend_proj`` (the JAX model's
        rounding order), giving [B, F + S, d]. Vocab-parallel under a
        context that shards ``vocab`` (:func:`layers.embed_lookup`)."""
        x = embed_lookup(params["embed"], tokens, shard_ctx).to(self.dtype)
        if features is None:
            return x
        if not self.cfg.frontend:
            raise ValueError(f"{self.cfg.name} has no frontend to take "
                             "feature payloads")
        proj = features.to(self.dtype) @ params["frontend_proj"]
        return torch.cat([proj, x], dim=1).to(self.dtype)

    @property
    def _remat(self):
        """The policy a training pass saves each layer under (None: all)."""
        return self.remat_policy if self.remat else None

    def _encode(self, params, features, remat=None):
        """An encoder-decoder's encoder: ``features`` [B, F, FRONTEND_DIM]
        cast to the model's dtype, ``frontend_proj``, the bidirectional
        stack (each layer saved as ``remat``) and ``enc_norm`` -> [B, F, d]
        (JAX's ``_encode``)."""
        x = features.to(self.dtype) @ params["frontend_proj"]
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        x = encoder_apply(params["encoder"], self.cfg, x, pos, remat=remat)
        return rmsnorm(x, params["enc_norm"], self.cfg.norm_eps)

    def backbone(self, params, tokens, features=None, want_cache=True,
                 shard_ctx=None):
        """Embed (``features`` first, see :meth:`_embed_inputs`) + decoder
        stack + final norm over [B, S] tokens. Returns (x [B,F+S,d], aux,
        caches); aux is the MoE layers' summed load-balance loss. An
        encoder-decoder encodes ``features`` (required) instead, and its
        decoder over the tokens alone cross-attends to them: x [B,S,d],
        the caches with each layer's xk/xv [B,F,Hkv,hd].

        ``want_cache=False`` is the training pass (JAX's ``backbone(...,
        want_cache=False)``): caches None, each layer under the model's
        remat policy. ``shard_ctx`` (serving) makes the embedding
        vocab-parallel; the layers run whole on the mesh's first device."""
        enc_out = None
        remat = None if want_cache else self._remat
        if self.cfg.is_encdec:
            if features is None:
                raise ValueError(f"{self.cfg.name} is an encoder-decoder: "
                                 "its encoder needs features")
            enc_out = self._encode(params, features, remat)
            x = embed_lookup(params["embed"], tokens, shard_ctx).to(
                self.dtype)
        else:
            x = self._embed_inputs(params, tokens, features, shard_ctx)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        x, aux, caches = stack_apply_full(
            params["decoder"], self.cfg, x, pos, groups=self.groups,
            enc_out=enc_out, want_cache=want_cache, remat=remat)
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        return x, aux, caches

    def forward(self, params, tokens, features=None, *, shard_ctx=None):
        """Full-sequence logits [B, F+S, vocab_padded], the MoE aux loss and
        the caches (the JAX model's ``forward``)."""
        x, aux, caches = self.backbone(params, tokens, features,
                                       shard_ctx=shard_ctx)
        logits = lm_head(params["embed"], x, self.cfg.vocab_size)
        if shard_ctx is not None:
            logits = shard_ctx.constrain(logits, "batch", None, "vocab")
        return logits, aux, caches

    def loss(self, params, batch):
        """The training loss of JAX's ``Model.loss``: ``batch`` is a dict of
        tensors on :attr:`device` -- ``tokens`` [B, S], ``labels`` [B, S],
        optionally ``features`` [B, F, FRONTEND_DIM] (a model with a
        frontend; an encoder-decoder's encoder input) and ``loss_mask``
        [B, S]. The mean (or masked mean) fp32 token NLL over the labels --
        a VLM's over the text suffix only -- plus ``router_aux_weight``
        times the MoE layers' load-balance loss. A full pass that keeps no
        caches, each layer under the model's remat policy."""
        labels = batch["labels"]
        features = batch.get("features") if self.cfg.frontend else None
        aux_w = self.cfg.moe.router_aux_weight if self.cfg.moe else 0.0
        x, aux, _ = self.backbone(params, batch["tokens"], features,
                                  want_cache=False)
        if features is not None and not self.cfg.is_encdec:
            x = x[:, -labels.shape[1]:]  # VLM: loss only over the text suffix
        logits = lm_head(params["embed"], x, self.cfg.vocab_size)
        return cross_entropy(logits, labels, batch.get("loss_mask")) \
            + aux_w * aux

    def prefill(self, params, tokens, features=None, *, shard_ctx=None):
        """tokens [B, S] (after ``features`` [B, F, FRONTEND_DIM], if any)
        -> (last_logits [B,V], caches, lengths [B] = F + S); the LM head
        runs on the last position only. An encoder-decoder's ``features``
        feed its encoder: lengths = S, and the caches' xk/xv hold the F
        encoder rows (grow the ring leaves with
        :func:`repro_torch.models.kvcache.grow_cache` before decoding).
        ``shard_ctx`` as :meth:`backbone`; the caches come back whole
        (``sharding.partition.place_for_ctx`` lays them out for a sharded
        decode)."""
        x, _, caches = self.backbone(params, tokens, features,
                                     shard_ctx=shard_ctx)
        B, S = x.shape[:2]
        logits = lm_head(params["embed"], x[:, -1:], self.cfg.vocab_size)
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        return logits[:, 0], caches, lengths

    def prefill_bucketed(self, params, tokens, lengths, *, shard_ctx=None):
        """Padded-bucket prefill: tokens [B, L] right-padded, lengths [B]
        real. Causal attention hides trailing pad from real positions, so
        only the LM-head gather differs from :meth:`prefill`: logits are
        read at each row's last real position. Pad positions write garbage
        KV that decode never reads (valid_len masks it and the next real
        token overwrites slot ``lengths % W``). Attention-only stacks; raises
        ValueError for others. Returns (last_logits [B,V], caches, lengths
        int32)."""
        self._require_attention_only("prefill_bucketed")
        x, _, caches = self.backbone(params, tokens, shard_ctx=shard_ctx)
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
        x, _, caches = stack_apply_full(
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
        x, _, caches = stack_apply_full(
            params["decoder"], self.cfg, x, positions, groups=self.groups,
            segment_ids=segment_ids,
            segment_starts=ops.segment_run_starts(segment_ids))
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        x_last = x[0, last_idx.to(torch.int64)][None]  # [1, N, d]
        logits = lm_head(params["embed"], x_last, self.cfg.vocab_size)
        return logits[0], caches

    def decode_step(self, params, caches, tokens, lengths, *,
                    shard_ctx=None):
        """tokens [B,1], lengths [B] int32 -> (logits [B,V], caches,
        lengths+1). The caches are ring-written in place and returned.

        With ``shard_ctx`` (the JAX model's ``decode_step(...,
        shard_ctx)``): the embedding vocab-parallel and, where the rules
        shard ``kv_seq``, each attention layer's write and attention per
        sequence shard -- its caches laid out by
        ``sharding.partition.place_for_ctx`` -- merged by the max/sum rule;
        the logits come back whole on the mesh's first device."""
        x = embed_lookup(params["embed"], tokens, shard_ctx).to(self.dtype)
        x = stack_apply_decode(params["decoder"], self.cfg, x, caches, lengths,
                               groups=self.groups, shard_ctx=shard_ctx)
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
        (an SSM layer's shapes do not depend on ``seq_len``); an
        encoder-decoder's xk/xv get ``seq_len // 8`` encoder rows, as the
        JAX model's ``cache_specs`` gives them."""
        W = self._seq_budget(seq_len)
        enc_len = seq_len // 8 if self.cfg.is_encdec else 0
        return {
            f"g{gi}": [
                {f"l{j}": kvc.layer_cache_shapes(self.cfg, sig, B, W, enc_len)
                 for j, sig in enumerate(g.sigs)}
                for _ in range(g.count)
            ]
            for gi, g in enumerate(self.groups)
        }

    def cache_pspecs(self, rules: dict) -> dict:
        """One partition spec a cache leaf under ``rules`` (JAX's
        ``Model.cache_pspecs``): the sequence dim on ``kv_seq`` when the
        rules shard it (decode), the heads then local."""
        kv_sharded = rules.get("kv_seq") is not None

        def one(sig):
            axes = kvc.cache_logical_axes(self.cfg, sig, kv_sharded)
            return {k: sch.spec(rules, ax) for k, ax in axes.items()}

        return {f"g{gi}": [{f"l{j}": one(sig) for j, sig in enumerate(g.sigs)}
                           for _ in range(g.count)]
                for gi, g in enumerate(self.groups)}

    def input_specs(self, shape) -> dict:
        """Shape-only meta tensors of one step's inputs at ``shape``'s
        global size (JAX's ``Model.input_specs``): train ``tokens`` and
        ``labels`` (and ``features`` for a frontend: an encoder-decoder's
        source half, a VLM's image share); prefill ``tokens`` (and
        ``features``); decode one token a row, ``lengths`` and the caches
        of ``seq_len`` slots."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def tok(*s):
            return torch.empty(s, dtype=torch.int32, device="meta")

        def feat(*s):
            return torch.empty(s, dtype=self.dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            if cfg.is_encdec:
                s_src = S // 2
            elif cfg.frontend:
                s_src = int(S * cfg.frontend_tokens_fraction)
            else:
                s_src = 0
            out = {"tokens": tok(B, S - s_src)}
            if s_src:
                out["features"] = feat(B, s_src, FRONTEND_DIM)
            if shape.kind == "train":
                out["labels"] = tok(B, S - s_src)
            return out
        caches = {
            gname: [{lname: {k: torch.empty(s, device="meta",
                                            dtype=kvc.leaf_dtype(k, self.dtype))
                             for k, s in shapes.items()}
                     for lname, shapes in block.items()} for block in group]
            for gname, group in self.cache_specs(B, S).items()}
        return {"tokens": tok(B, 1), "lengths": tok(B), "caches": caches}

    def init_cache(self, B: int, seq_len: int, dtype=None) -> dict:
        """Zeroed caches on the model's device, each leaf in ``dtype``
        (default: the model's) except the SSM state, which is fp32."""
        dtype = dtype or self.dtype
        return {
            gname: [{lname: kvc.init_layer_cache(shapes, dtype, self.device)
                     for lname, shapes in block.items()} for block in group]
            for gname, group in self.cache_specs(B, seq_len).items()
        }
