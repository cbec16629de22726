"""Architecture configs of the port (counterpart of ``repro.configs``).

``get_config(name)`` returns the full-size :class:`~.base.ModelConfig`;
``get_smoke_config(name)`` the reduced same-family config the CPU tests
use.  Every architecture of the reference is here; ``ARCH_IDS`` lists the
reference's ten assigned ones in its order (``train100m`` is extra, as in
the reference).
"""

from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeSpec, shapes_for

ARCH_IDS = (
    "minicpm-2b",
    "qwen2.5-3b",
    "deepseek-67b",
    "qwen1.5-32b",
    "mamba2-1.3b",
    "deepseek-v2-lite-16b",
    "olmoe-1b-7b",
    "zamba2-7b",
    "whisper-medium",
    "qwen2-vl-2b",
)

_MODULES = {
    "minicpm-2b": "minicpm_2b",
    "qwen2.5-3b": "qwen2_5_3b",
    "deepseek-67b": "deepseek_67b",
    "qwen1.5-32b": "qwen1_5_32b",
    "mamba2-1.3b": "mamba2_1_3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "zamba2-7b": "zamba2_7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "whisper-medium": "whisper_medium",
    "train100m": "train100m",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"{__name__}.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["ARCH_IDS", "ModelConfig", "ShapeSpec", "SHAPES", "shapes_for", "get_config",
           "get_smoke_config"]
