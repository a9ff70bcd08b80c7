"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.

[arXiv:2308.11596] 24L d_model=1024 16H d_ff=8192 vocab=256206.
24 encoder + 24 decoder layers. The speech frontend (mel-spectrogram +
conformer feature extractor) is a stub, as in the JAX package: the caller
supplies precomputed frame embeddings feeding the encoder.

long_500k is skipped for this arch (enc-dec: a 500k-token decode target is
meaningless for speech translation).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    rope_theta=10_000.0,
    frontend="audio",
    frontend_tokens_fraction=1.0,  # encoder input is all frame embeddings
    source="arXiv:2308.11596",
)
