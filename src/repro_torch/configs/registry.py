"""Architecture registry: ``get_config(arch_id)`` for the reference's
ten architectures."""
from __future__ import annotations

import importlib

from repro_torch.nn.transformer import ModelConfig

_MODULES = {
    "gemma2-27b": "gemma2_27b",
    "qwen2.5-3b": "qwen2_5_3b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "gemma-7b": "gemma_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "dbrx-132b": "dbrx_132b",
    "internvl2-76b": "internvl2_76b",
    "whisper-large-v3": "whisper_large_v3",
    "xlstm-350m": "xlstm_350m",
    "recurrentgemma-2b": "recurrentgemma_2b",
}
ARCH_IDS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id == "paper-mlp":
        raise ValueError("paper-mlp uses repro_torch.nn.mlp_paper, not "
                         "ModelConfig")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r} (known: {ARCH_IDS})")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch_id]}").CONFIG
