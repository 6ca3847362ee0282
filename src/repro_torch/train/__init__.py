"""Training loop of the port: the train-step builder (one card)."""
from .step import build_train_step

__all__ = ["build_train_step"]
