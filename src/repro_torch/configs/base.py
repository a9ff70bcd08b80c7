"""Model configuration schema (a copy of the JAX package's ``configs/base.py``).

Every architecture module in this package instantiates a
:class:`ModelConfig` with the published hyper-parameters (source cited in
each file). ``reduced()`` derives the CPU-test variant (<=2 layers,
d_model<=512, <=4 experts) from the same family.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block hyper-parameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256  # SSD chunk length

    def n_heads(self, d_model: int) -> int:
        return (d_model * self.expand) // self.head_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden width
    n_shared_experts: int = 0
    # Layer l uses MoE iff l >= first_dense and (l - first_dense) % every == 0.
    every: int = 1
    first_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    # 0 = full attention. The long_500k sliding-window *variant* for
    # dense-family archs sets this at dry-run time.
    sliding_window: int = 0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): layer i is attention iff i % attn_every == attn_offset,
    # else an SSM block. attn_every=0 => pure attention stack.
    attn_every: int = 0
    attn_offset: int = 3
    # encoder-decoder (seamless): 0 => decoder-only.
    encoder_layers: int = 0
    # multimodal frontend stub: "" | "vision" | "audio".
    frontend: str = ""
    frontend_tokens_fraction: float = 0.5  # fraction of seq that is embeddings
    source: str = ""  # citation

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "ssm" and self.ssm is None:
            object.__setattr__(self, "ssm", SSMConfig())

    # -- derived helpers ------------------------------------------------ #
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for decoder layer ``i``."""
        if self.family == "ssm":
            return "ssm"
        if self.attn_every > 0:  # hybrid
            return "attn" if i % self.attn_every == self.attn_offset else "ssm"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        m = self.moe
        if m is None:
            return False
        return i >= m.first_dense and (i - m.first_dense) % m.every == 0

    def n_attn_layers(self) -> int:
        return sum(1 for i in range(self.n_layers) if self.layer_kind(i) == "attn")

    # -- parameter count (for MODEL_FLOPS = 6*N*D roofline term) --------- #
    def param_count(self, active_only: bool = False) -> int:
        """Total (or MoE-active) parameter count, embeddings included."""
        d = self.d_model
        n = 0
        # embeddings (+ output head unless tied)
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        layers = self.n_layers + self.encoder_layers
        for i in range(self.n_layers):
            n += self._layer_params(i, active_only, cross=self.is_encdec)
        for i in range(self.encoder_layers):
            n += self._layer_params(i, active_only, cross=False, force_dense=True)
        n += d  # final norm
        return n

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.mla is not None:
            m = self.mla
            q_in = m.q_lora_rank or d
            n = 0
            if m.q_lora_rank:
                n += d * m.q_lora_rank
            n += q_in * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
            n += d * (m.kv_lora_rank + m.qk_rope_dim)
            n += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            n += self.n_heads * m.v_head_dim * d
            return n
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        return q + kv + o

    def _ssm_params(self) -> int:
        s = self.ssm or SSMConfig()
        d = self.d_model
        d_in = d * s.expand
        nh = s.n_heads(d)
        n = d * (2 * d_in + nh)  # in_proj for x, z and dt
        n += s.d_conv * (d_in + 2 * s.d_state)  # depthwise conv (x;B;C)
        n += d * 2 * s.d_state  # B, C projections (1 group)
        n += nh * 2  # A_log, D
        n += d_in * d  # out_proj
        return n

    def _ffn_params(self, i: int, active_only: bool) -> int:
        d = self.d_model
        if self.layer_is_moe(i):
            m = self.moe
            per_expert = 3 * d * m.d_ff
            routed = m.top_k if active_only else m.n_experts
            return routed * per_expert + m.n_shared_experts * per_expert + d * m.n_experts
        return 3 * d * self.d_ff  # SwiGLU

    def _layer_params(self, i: int, active_only: bool, cross: bool, force_dense: bool = False) -> int:
        d = self.d_model
        n = 2 * d  # norms
        if force_dense or self.layer_kind(i) == "attn":
            n += self._attn_params()
            if cross:
                n += self._attn_params() + d
        else:
            n += self._ssm_params()
        if not (self.family == "ssm"):
            n += self._ffn_params(i, active_only) if not force_dense else 3 * d * self.d_ff
        return n

    # -- smoke-test variant ---------------------------------------------- #
    def reduced(self) -> "ModelConfig":
        """<=2 layers, d_model<=512, <=4 experts: same family, CPU-sized."""
        changes: dict = dict(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=256,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            d_ff=512,
            vocab_size=512,
            head_dim=64,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2), d_ff=256,
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                first_dense=min(self.moe.first_dense, 1),
            )
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                kv_lora_rank=64, q_lora_rank=96, qk_nope_dim=32, qk_rope_dim=16,
                v_head_dim=32,
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk=32)
        if self.attn_every > 0:  # keep the hybrid interleave visible in 2 layers
            changes["attn_every"] = 2
            changes["attn_offset"] = 1
        if self.encoder_layers:
            changes["encoder_layers"] = 2
        return dataclasses.replace(self, **changes)
