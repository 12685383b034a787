"""Config registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

The port knows the architectures whose families it implements: the dense
GQA LMs ``qwen3-8b``, ``phi3-medium-14b``, ``minitron-8b`` and
``starcoder2-3b`` (LayerNorm, GELU MLP), the mixture of experts with a
sliding window ``mixtral-8x7b``, MLA with a mixture of shared and routed
experts ``deepseek-v2-236b``, the vision stub ``phi-3-vision-4.2b``, the
recurrent RWKV6 ``rwkv6-1.6b``, the Mamba2 / shared-attention hybrid
``zamba2-7b``, the encoder-decoder ``whisper-base`` (its audio frontend a
stub of precomputed frames, as in the reference), and the paper's MNIST
CNN (``paper-mnist-cnn``, metadata only): every architecture of the
reference's registry. An unknown name raises ``KeyError``. ``GRID_ARCHS``
and the shape grid (``ALL_SHAPES``) are the reference's.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES_BY_NAME,
    TRAIN_4K,
    HybridConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
    SSMConfig,
    TrainConfig,
)

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
    "whisper-base": "whisper_base",
    "zamba2-7b": "zamba2_7b",
    "paper-mnist-cnn": "paper_mnist",
}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch '{arch}'; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


GRID_ARCHS = [a for a in ARCH_IDS if a != "paper-mnist-cnn"]

__all__ = [
    "ARCH_IDS",
    "GRID_ARCHS",
    "get_config",
    "get_reduced",
    "ALL_SHAPES",
    "SHAPES_BY_NAME",
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "HybridConfig",
    "TrainConfig",
    "ShapeSpec",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
]
