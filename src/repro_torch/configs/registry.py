"""Architecture registry: ``get_config(arch_id)`` for the architectures
the port supports so far (the reference registers ten)."""
from __future__ import annotations

import importlib

from repro_torch.nn.transformer import ModelConfig

_MODULES = {"qwen2.5-3b": "qwen2_5_3b", "olmoe-1b-7b": "olmoe_1b_7b",
            "gemma2-27b": "gemma2_27b"}
ARCH_IDS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet (ported: {ARCH_IDS})")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch_id]}").CONFIG
