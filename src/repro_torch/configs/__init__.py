"""Architecture registry of the port: the configurations it can serve so far,
and the four input shapes."""

from __future__ import annotations

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from repro_torch.configs.deepseek_v2_236b import CONFIG as DEEPSEEK_V2_236B
from repro_torch.configs.granite_34b import CONFIG as GRANITE_34B
from repro_torch.configs.grok1_314b import CONFIG as GROK1_314B
from repro_torch.configs.jamba_v01_52b import CONFIG as JAMBA_V01_52B
from repro_torch.configs.llama3_8b import CONFIG as LLAMA3_8B
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M
from repro_torch.configs.pixtral_12b import CONFIG as PIXTRAL_12B
from repro_torch.configs.qwen3_32b import CONFIG as QWEN3_32B
from repro_torch.configs.seamless_m4t_large_v2 import (
    CONFIG as SEAMLESS_M4T_LARGE_V2,
)
from repro_torch.configs.shapes import SHAPES, InputShape, get_shape
from repro_torch.configs.starcoder2_3b import CONFIG as STARCODER2_3B

ARCHITECTURES: dict[str, ModelConfig] = {
    c.name: c for c in (LLAMA3_8B, STARCODER2_3B, QWEN3_32B, GRANITE_34B,
                        MAMBA2_130M, GROK1_314B, PIXTRAL_12B,
                        DEEPSEEK_V2_236B, JAMBA_V01_52B,
                        SEAMLESS_M4T_LARGE_V2)}


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
    "InputShape",
    "SHAPES",
    "get_config",
    "get_shape",
]
