"""Config registry: ``get_config(arch_id)`` / ``list_archs()`` /
``get_shape(name)``.

Holds the reference's ten LM configs, each a copy of the JAX package's
(each file cites its source), and its four input shapes.
"""
from __future__ import annotations

from .base import ArchConfig, InputShape, INPUT_SHAPES  # noqa: F401
from . import (deepseek_v2_lite_16b, gemma2_9b, granite_moe_1b_a400m,
               internlm2_1_8b, internvl2_1b, mamba2_1_3b, minitron_8b,
               musicgen_large, qwen1_5_4b, zamba2_2_7b)

_REGISTRY: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        minitron_8b, deepseek_v2_lite_16b, musicgen_large, mamba2_1_3b,
        zamba2_2_7b, granite_moe_1b_a400m, internvl2_1b, qwen1_5_4b,
        gemma2_9b, internlm2_1_8b)
}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
