"""Architecture configs of the port: ``get_config(name)`` and ``ARCH_IDS``.

The same ten names as ``repro.configs``.  The port carries the config
modules of the architectures whose mixers it has ported: ``qwen2_1_5b``
(global attention + dense SwiGLU).  The other nine come with their
mixers (ROADMAP.md queue 1, slice 3); asking for one raises
``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

__all__ = ["ARCH_IDS", "PORTED", "get_config"]

ARCH_IDS = [
    "qwen2_1_5b",
    "gemma2_27b",
    "gemma3_12b",
    "phi4_mini_3_8b",
    "deepseek_v2_lite_16b",
    "deepseek_v3_671b",
    "qwen2_vl_2b",
    "whisper_small",
    "xlstm_350m",
    "recurrentgemma_2b",
]

#: the configs whose every mixer the port runs
PORTED = ("qwen2_1_5b",)


def get_config(name: str) -> ModelConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    if key not in PORTED:
        raise NotImplementedError(
            f"{key} needs mixers the port has not ported yet (ROADMAP.md "
            "queue 1, slice 3: the mixers with rg_lru, mlstm_chunkwise, "
            "moe_combine, gather_rows and MLA)")
    mod = importlib.import_module(f".{key}", __package__)
    return mod.CONFIG
