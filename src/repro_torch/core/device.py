"""Where the port's entry points put their tensors by default."""
from __future__ import annotations

import torch

__all__ = ["default_device"]


def default_device(device=None) -> torch.device:
    """``device``, or the CUDA card when none is given; with no card the
    caller must ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port's entry points default to the CUDA device and "
                "none is available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)
