"""Architecture configs of the port: ``get_config(name)`` and ``ARCH_IDS``.

The same ten names as ``repro.configs``.  The port carries the config
modules of the architectures whose mixers it has ported: ``qwen2_1_5b``
and ``phi4_mini_3_8b`` (global attention + dense SwiGLU),
``gemma2_27b`` (local/global alternation, attention and final logit
softcaps), ``gemma3_12b`` (5 local : 1 global, QK norm),
``recurrentgemma_2b`` (RG-LRU + local attention), ``xlstm_350m`` (mLSTM
+ sLSTM) and ``deepseek_v2_lite_16b`` (MLA + MoE).  Each module is the
reference's, unchanged.  The other three (``deepseek_v3_671b``,
``qwen2_vl_2b``, ``whisper_small``) come in later slices (ROADMAP.md
queue 1); asking for one raises ``NotImplementedError``.
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
PORTED = ("qwen2_1_5b", "gemma2_27b", "gemma3_12b", "phi4_mini_3_8b",
          "recurrentgemma_2b", "xlstm_350m", "deepseek_v2_lite_16b")


def get_config(name: str) -> ModelConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    if key not in PORTED:
        raise NotImplementedError(
            f"{key} is not among the port's configs yet (ROADMAP.md queue "
            "1)")
    mod = importlib.import_module(f".{key}", __package__)
    return mod.CONFIG
