"""Architectures the port runs, the JAX package's ten:
``get_config(arch)`` / ``get_smoke(arch)``.

Each module holds ``CONFIG`` (the published full-size config) and
``SMOKE`` (a reduced same-family config for CPU tests), copied verbatim
from the JAX package's ``repro.configs``."""
from __future__ import annotations

import importlib

_MODULES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "mixtral-8x7b": "mixtral_8x7b",
    "xlstm-350m": "xlstm_350m",
    "qwen1.5-4b": "qwen1_5_4b",
    "granite-8b": "granite_8b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "smollm-360m": "smollm_360m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _mod(arch).CONFIG


def get_smoke(arch: str):
    return _mod(arch).SMOKE
