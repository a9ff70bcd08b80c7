"""pixtral-12b [vlm] — Pixtral-ViT frontend + Mistral-Nemo decoder backbone.

[hf:mistralai/Pixtral-12B-2409] 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072. The vision encoder is a stub:
``input_specs`` supplies precomputed patch embeddings; this config is the
language decoder that consumes them.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,  # Nemo-style: n_heads*head_dim (4096) != d_model
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_tokens_fraction=0.5,
    source="hf:mistralai/Pixtral-12B-2409",
)
