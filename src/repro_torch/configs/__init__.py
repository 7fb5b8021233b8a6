"""Config registry: ``get_config(arch_id)`` / ``list_archs()``.

Holds the LM configs the port can run, each a copy of the JAX package's.
The reference's two multimodal configs (``internvl2-1b``,
``musicgen-large``) need modality prefixes, ROADMAP queue 1 item 22.
"""
from __future__ import annotations

from .base import ArchConfig  # noqa: F401
from . import (deepseek_v2_lite_16b, gemma2_9b, granite_moe_1b_a400m,
               internlm2_1_8b, mamba2_1_3b, minitron_8b, qwen1_5_4b,
               zamba2_2_7b)

_REGISTRY: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        minitron_8b, deepseek_v2_lite_16b, mamba2_1_3b, zamba2_2_7b,
        granite_moe_1b_a400m, qwen1_5_4b, gemma2_9b, internlm2_1_8b)
}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_REGISTRY)} (the multimodal configs "
                       f"internvl2-1b and musicgen-large are ROADMAP queue 1 "
                       f"item 22)")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
