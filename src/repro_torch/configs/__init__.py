"""Architecture registry of the port: ``get_config(arch_id)``.

All fourteen of the JAX package's architectures, with its lists: the ten
assigned architectures (exact public configs) and the paper's own
evaluation models (``paper_models``: OPT-30B/66B, Llama-30B, Llama2-70B).
Every one is served by ``models.model`` and ``serving.engine``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ASSIGNED_ARCHS = [
    "olmoe-1b-7b",
    "granite-moe-3b-a800m",
    "starcoder2-3b",
    "gemma2-2b",
    "qwen1.5-110b",
    "yi-9b",
    "mamba2-370m",
    "hymba-1.5b",
    "chameleon-34b",
    "musicgen-medium",
]

PAPER_ARCHS = ["opt-30b", "opt-66b", "llama-30b", "llama2-70b"]

ALL_ARCHS = ASSIGNED_ARCHS + PAPER_ARCHS

_MODULES = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "starcoder2-3b": "starcoder2_3b",
    "gemma2-2b": "gemma2_2b",
    "qwen1.5-110b": "qwen1_5_110b",
    "yi-9b": "yi_9b",
    "mamba2-370m": "mamba2_370m",
    "hymba-1.5b": "hymba_1_5b",
    "chameleon-34b": "chameleon_34b",
    "musicgen-medium": "musicgen_medium",
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
