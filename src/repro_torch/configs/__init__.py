"""Config registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

The port knows the architectures whose families it implements: today the
dense GQA LM ``qwen3-8b``. Every other architecture of ``repro.configs``
raises ``NotImplementedError`` until its family is ported (ROADMAP Queue 1,
item 15); an unknown name raises ``KeyError``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import HybridConfig, MLAConfig, ModelConfig, MoEConfig, SSMConfig

# every architecture of the reference's registry, ported or not
ARCH_IDS: List[str] = [
    "rwkv6-1.6b",
    "phi-3-vision-4.2b",
    "phi3-medium-14b",
    "starcoder2-3b",
    "qwen3-8b",
    "minitron-8b",
    "deepseek-v2-236b",
    "mixtral-8x7b",
    "whisper-base",
    "zamba2-7b",
    "paper-mnist-cnn",
]

_MODULES: Dict[str, str] = {"qwen3-8b": "qwen3_8b"}


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch}'; known: {sorted(ARCH_IDS)}")
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch '{arch}' is not ported yet (ROADMAP Queue 1, item 15); "
            f"ported: {sorted(_MODULES)}"
        )
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


__all__ = [
    "ARCH_IDS",
    "get_config",
    "get_reduced",
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "HybridConfig",
]
