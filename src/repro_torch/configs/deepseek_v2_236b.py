"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.

[arXiv:2405.04434] 60L d_model=5120 128H d_ff(expert)=1536 vocab=102400.
First layer keeps a dense SwiGLU FFN (width 12288, per the paper); layers
1..59 are MoE with 160 routed experts (top-6) + 2 shared experts.
MLA: compressed KV latent of 512 + decoupled RoPE key of 64 per token — the
natively "small-payload" cache for the serving-transfer study.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,  # MLA is effectively MHA over decompressed heads
    head_dim=128,
    d_ff=12288,  # dense FFN width (first layer)
    vocab_size=102400,
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff=1536, n_shared_experts=2,
                  every=1, first_dense=1),
    source="arXiv:2405.04434",
)
