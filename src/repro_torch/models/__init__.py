"""Model zoo of the port: the blocks the ported configs need (global and
sliding-window GQA attention, DeepSeek's MLA, the MoE FFN with capacity
dispatch, the RG-LRU block, the mLSTM and sLSTM blocks, SwiGLU and
GeGLU, RMS norm, RoPE)."""
from . import (attention, config, layers, moe, parallel, rglru, ssm,
               transformer, zoo)
from .config import LayerSlot, ModelConfig
from .parallel import Parallel

__all__ = ["attention", "config", "layers", "moe", "parallel", "rglru",
           "ssm", "transformer", "zoo", "LayerSlot", "ModelConfig",
           "Parallel"]
