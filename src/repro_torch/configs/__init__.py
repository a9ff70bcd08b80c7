"""Architecture registry of the port: the configurations it can serve so far."""

from __future__ import annotations

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from repro_torch.configs.granite_34b import CONFIG as GRANITE_34B
from repro_torch.configs.llama3_8b import CONFIG as LLAMA3_8B
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M
from repro_torch.configs.qwen3_32b import CONFIG as QWEN3_32B
from repro_torch.configs.starcoder2_3b import CONFIG as STARCODER2_3B

ARCHITECTURES: dict[str, ModelConfig] = {
    c.name: c for c in (LLAMA3_8B, STARCODER2_3B, QWEN3_32B, GRANITE_34B,
                        MAMBA2_130M)}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise KeyError(
            f"unknown architecture {name!r}; options: {sorted(ARCHITECTURES)}"
        ) from None


__all__ = [
    "ARCHITECTURES",
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "get_config",
]
