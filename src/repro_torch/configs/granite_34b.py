"""granite-34b [dense] — llama-arch, code, MQA (kv=1). [arXiv:2405.04324]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=10_000.0,
    source="arXiv:2405.04324",
)
