"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060] 24L d_model=768 vocab=50280 ssm_state=128.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    source="arXiv:2405.21060",
)
