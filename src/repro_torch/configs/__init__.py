"""Architecture registry, the port of ``src/repro/configs/__init__.py``:
``get_bundle(arch_id)`` -> ArchBundle."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchBundle

_ARCHS = (
    "olmoe-1b-7b", "moonshot-v1-16b-a3b", "qwen2.5-32b", "phi3-medium-14b",
    "gemma2-27b",
    "gat-cora", "equiformer-v2", "schnet", "nequip",
    "wide-deep",
)


def list_archs() -> tuple[str, ...]:
    return _ARCHS


def get_bundle(arch_id: str, smoke: bool = False) -> ArchBundle:
    key = arch_id.replace(".", "_").replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.bundle(smoke=smoke)
