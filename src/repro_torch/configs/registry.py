"""Architecture registry: ``--arch <id>`` resolution for the LM launcher.

All ten of the reference's archs. An unknown name raises ``KeyError``
listing them.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0p5b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "llama-3.2-vision-90b": "repro_torch.configs.llama32_vision_90b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()
