"""Architecture registry of the port: ``get_config(arch_id)``.

The four served assigned architectures (yi-9b, gemma2-2b, mamba2-370m,
hymba-1.5b) and the paper's evaluation models (``paper_models``:
llama-30b and llama2-70b are served; opt-30b and opt-66b are planning
profiles only).  The other assigned architectures join as their model
families are ported (ROADMAP.md Queue A item 5).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "gemma2-2b": "gemma2_2b",
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-370m": "mamba2_370m",
    "yi-9b": "yi_9b",
    "opt-30b": "paper_models",
    "opt-66b": "paper_models",
    "llama-30b": "paper_models",
    "llama2-70b": "paper_models",
}

ARCHS = sorted(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIGS[arch] if hasattr(mod, "CONFIGS") else mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return get_config(arch).reduced()
