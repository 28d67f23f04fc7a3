"""Architecture registry of the port: the dense and vlm configurations its
serving path runs so far.  ``get_config`` takes the canonical id
(``paper-llama2-7b``) or the module name (``paper_llama2_7b``)."""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

_ARCH_MODULES = {
    "yi-9b": "yi_9b",
    "qwen2-1.5b": "qwen2_1p5b",
    "granite-3-8b": "granite_3_8b",
    "gemma-2b": "gemma_2b",
    "paligemma-3b": "paligemma_3b",
    "paper-llama2-7b": "paper_llama2_7b",
    "paper-mistral-7b": "paper_mistral_7b",
}


def get_config(arch: str) -> ModelConfig:
    key = arch
    if key not in _ARCH_MODULES:
        rev = {v: k for k, v in _ARCH_MODULES.items()}
        if arch not in rev:
            raise KeyError(f"unknown arch {arch!r}; known: "
                           f"{sorted(_ARCH_MODULES)}")
        key = rev[arch]
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[key]}")
    return mod.CONFIG
