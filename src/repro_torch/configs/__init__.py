"""Config registry: ``get_config("<arch-id>")`` for every assigned arch (a
copy of the JAX package's registry; nothing is downloaded)."""
from __future__ import annotations

from repro_torch.configs.base import INPUT_SHAPES, LONG_CONTEXT_WINDOW, ModelConfig, ShapeConfig

from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen15
from repro_torch.configs.llama3_405b import CONFIG as _llama3
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3moe
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6

REGISTRY = {
    c.name: c
    for c in (
        _qwen15, _llama3, _qwen3moe, _qwen3, _zamba2, _arctic, _rwkv6,
    )
}

ARCH_IDS = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


__all__ = [
    "REGISTRY", "ARCH_IDS", "get_config", "get_shape",
    "INPUT_SHAPES", "LONG_CONTEXT_WINDOW", "ModelConfig", "ShapeConfig",
]
