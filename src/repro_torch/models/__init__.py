"""Model zoo of the port: the blocks the ported configs need (global and
sliding-window GQA attention, SwiGLU, RMS norm, RoPE)."""
from . import attention, config, layers, parallel, transformer, zoo
from .config import LayerSlot, ModelConfig
from .parallel import Parallel

__all__ = ["attention", "config", "layers", "parallel", "transformer",
           "zoo", "LayerSlot", "ModelConfig", "Parallel"]
