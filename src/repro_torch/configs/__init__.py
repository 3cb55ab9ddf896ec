"""Architecture registry of the port: ``get_config(arch_id)``.

Only the architectures the port serves so far are registered; the others
join as their model families are ported (see ROADMAP.md).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "gemma2-2b": "gemma2_2b",
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-370m": "mamba2_370m",
    "yi-9b": "yi_9b",
}

ARCHS = sorted(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return get_config(arch).reduced()
