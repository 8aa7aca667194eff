"""Architecture and input-shape registry: ``get_config("<arch-id>")`` and
``get_shape("<shape-id>")``, as in ``repro/configs/__init__.py``. The
``-smoke`` suffix gives the reduced variant (``ModelConfig.reduced``).

All ten of the reference's architectures are registered: dense, MoE
(``qwen3-moe-30b-a3b``; ``deepseek-v3-671b`` with MLA and MTP), ssm
(``rwkv6-7b``), hybrid (``hymba-1.5b``), enc-dec
(``seamless-m4t-large-v2``) and VLM (``llama-3.2-vision-90b``); an unknown
id raises ``KeyError``, as the reference's.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (FedZOConfig, INPUT_SHAPES, MLAConfig,
                                      ModelConfig, ShapeConfig)

_ARCH_MODULES = {
    "qwen3-4b": "qwen3_4b",
    "qwen1.5-32b": "qwen15_32b",
    "gemma-2b": "gemma_2b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "rwkv6-7b": "rwkv6_7b",
    "hymba-1.5b": "hymba_1_5b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llama-3.2-vision-90b": "llama32_vision_90b",
}

ARCH_IDS = tuple(_ARCH_MODULES)
SHAPE_IDS = tuple(INPUT_SHAPES)


def get_config(arch: str) -> ModelConfig:
    if arch.endswith("-smoke"):
        return get_config(arch[: -len("-smoke")]).reduced()
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_shape(shape: str) -> ShapeConfig:
    if shape not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {shape!r}; choose from {SHAPE_IDS}")
    return INPUT_SHAPES[shape]


__all__ = ["FedZOConfig", "MLAConfig", "ModelConfig", "ShapeConfig", "INPUT_SHAPES",
           "ARCH_IDS", "SHAPE_IDS", "get_config", "get_shape"]
