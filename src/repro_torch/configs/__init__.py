"""Config registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

The port knows the architectures whose families it implements: the dense
GQA LMs ``qwen3-8b``, ``phi3-medium-14b``, ``minitron-8b`` and
``starcoder2-3b`` (LayerNorm, GELU MLP), the mixture of experts with a
sliding window ``mixtral-8x7b``, MLA with a mixture of shared and routed
experts ``deepseek-v2-236b``, the vision stub ``phi-3-vision-4.2b``, the
recurrent RWKV6 ``rwkv6-1.6b``, the Mamba2 / shared-attention hybrid
``zamba2-7b``, and the paper's MNIST CNN (``paper-mnist-cnn``, metadata
only). The encoder-decoder ``whisper-base`` raises ``NotImplementedError``
until its family is ported (ROADMAP Queue 1, item 15); an unknown name
raises ``KeyError``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    HybridConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    TrainConfig,
)

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

_MODULES: Dict[str, str] = {
    "phi3-medium-14b": "phi3_medium_14b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-8b": "qwen3_8b",
    "minitron-8b": "minitron_8b",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "zamba2-7b": "zamba2_7b",
    "paper-mnist-cnn": "paper_mnist",
}


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
    "TrainConfig",
]
