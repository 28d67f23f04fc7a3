"""Architecture registry of the port, one module per architecture (copies
of the reference's).  ``get_config`` takes the canonical id
(``llama4-scout-17b-a16e``) or the module name (``llama4_scout_17b_a16e``)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

# canonical id -> module name
_ARCH_MODULES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "hubert-xlarge": "hubert_xlarge",
    "hymba-1.5b": "hymba_1p5b",
    "yi-9b": "yi_9b",
    "qwen2-1.5b": "qwen2_1p5b",
    "granite-3-8b": "granite_3_8b",
    "gemma-2b": "gemma_2b",
    "paligemma-3b": "paligemma_3b",
    "rwkv6-7b": "rwkv6_7b",
    # the paper's own evaluation models
    "paper-llama2-7b": "paper_llama2_7b",
    "paper-mistral-7b": "paper_mistral_7b",
}

ASSIGNED_ARCHS: List[str] = [
    "llama4-scout-17b-a16e",
    "qwen3-moe-235b-a22b",
    "hubert-xlarge",
    "hymba-1.5b",
    "yi-9b",
    "qwen2-1.5b",
    "granite-3-8b",
    "gemma-2b",
    "paligemma-3b",
    "rwkv6-7b",
]

PAPER_ARCHS: List[str] = ["paper-llama2-7b", "paper-mistral-7b"]


def get_config(arch: str) -> ModelConfig:
    key = arch.replace("_", "-") if arch in _ARCH_MODULES else arch
    if key not in _ARCH_MODULES:
        rev = {v: k for k, v in _ARCH_MODULES.items()}
        if arch not in rev:
            raise KeyError(f"unknown arch {arch!r}; known: "
                           f"{sorted(_ARCH_MODULES)}")
        key = rev[arch]
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[key]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ASSIGNED_ARCHS + PAPER_ARCHS}
