"""Config registry: ``get_config(arch_id)`` / ``list_archs()``.

Holds only what the port can run; the JAX package's other nine LM configs
are ROADMAP queue 1 item 23.
"""
from __future__ import annotations

from .base import ArchConfig  # noqa: F401
from . import zamba2_2_7b

_REGISTRY: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (zamba2_2_7b,)
}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_REGISTRY)} (the other configs are ROADMAP "
                       f"queue 1 item 23)")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
