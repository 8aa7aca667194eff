"""Architecture registry: ``get_config("<arch-id>")``, as in
``repro/configs/__init__.py``. The ``-smoke`` suffix gives the reduced
variant (``ModelConfig.reduced``).

Only the dense architectures the port runs are registered; any other id
raises ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import FedZOConfig, ModelConfig

_ARCH_MODULES = {
    "qwen2-0.5b": "qwen2_0_5b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch.endswith("-smoke"):
        return get_config(arch[: -len("-smoke")]).reduced()
    if arch not in _ARCH_MODULES:
        raise NotImplementedError(f"arch {arch!r} is not ported; the port "
                                  f"has {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


__all__ = ["FedZOConfig", "ModelConfig", "ARCH_IDS", "get_config"]
