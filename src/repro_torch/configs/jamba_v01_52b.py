"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Each block of 8 layers has one attention layer (offset 3, matching the paper's
a:m = 1:7 ratio); MoE replaces the MLP on every other layer (e=16, top-2).
Adaptation note: Jamba uses Mamba-1 blocks; the JAX package and this port use
the Mamba-2 SSD formulation throughout so the hybrid shares the chunked-scan
kernel (d_state 16 over 8192 / 64 = 128 SSD heads).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    attn_every=8,
    attn_offset=3,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, every=2, first_dense=1),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64),
    source="arXiv:2403.19887",
)
