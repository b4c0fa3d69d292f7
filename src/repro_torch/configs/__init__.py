"""Architecture registry of the port: ``get_config("<arch-id>")``.

``base.py`` is a copy of :mod:`repro.configs.base` (the port imports
nothing of ``repro``).  Only the dense GQA family runs in the port so far,
so the registry holds the configurations whose every block the port can
execute; later slices add the other families' files beside these.
"""
from __future__ import annotations

from . import qwen2_0_5b
from .base import ArchConfig, AttnKind, BlockKind, Segment  # noqa: F401

REGISTRY: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (qwen2_0_5b,)
}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


ALL_ARCHS = tuple(sorted(REGISTRY))
