"""Architecture registry: ``get_config(arch_id)`` for the reference's
ten architectures, plus the shape cells (train_4k / prefill_32k /
decode_32k / long_500k) with the per-arch skip rule
(``LONG_CONTEXT_ARCHS``); ``launch/shapes.py`` gives each cell's inputs."""
from __future__ import annotations

import importlib
from dataclasses import dataclass

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


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    step: str           # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# long_500k runs only for sub-quadratic archs (quadratic attention
# at 500k positions would neither fit nor finish)
LONG_CONTEXT_ARCHS = {"xlstm-350m", "recurrentgemma-2b", "h2o-danube-3-4b",
                      "gemma2-27b"}


def cells_for(arch_id: str) -> list[str]:
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_id in LONG_CONTEXT_ARCHS:
        cells.append("long_500k")
    return cells


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in cells_for(a)]
