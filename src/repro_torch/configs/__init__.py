"""Architecture configs of the port (counterpart of ``repro.configs``).

``get_config(name)`` returns the full-size :class:`~.base.ModelConfig`;
``get_smoke_config(name)`` the reduced same-family config the CPU tests
use.  Every architecture of the reference is here except Whisper, whose
name raises and names the slice that brings it.
"""

from __future__ import annotations

import importlib

from .base import ModelConfig

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
    "train100m": "train100m",
}

# Known architectures the port does not build yet, and the slice that will.
_LATER_SLICES = {
    "whisper-medium": "the Whisper slice (ROADMAP A.15)",
}


def _module(name: str):
    if name in _LATER_SLICES:
        raise NotImplementedError(f"arch {name!r} is not ported yet; it comes with {_LATER_SLICES[name]}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(set(_MODULES) | set(_LATER_SLICES))}")
    return importlib.import_module(f"{__name__}.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["ModelConfig", "get_config", "get_smoke_config"]
