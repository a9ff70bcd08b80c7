"""Architecture registry of the port: the configurations it can serve so far."""

from __future__ import annotations

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from repro_torch.configs.llama3_8b import CONFIG as LLAMA3_8B

ARCHITECTURES: dict[str, ModelConfig] = {c.name: c for c in (LLAMA3_8B,)}


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
