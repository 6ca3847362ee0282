"""Optimizers of the port: AdamW (``optim/adamw.py``).  The compressed
all-reduce (``repro.optim.compress``) needs a team collective over a
mesh axis and waits for the distributed slice (ROADMAP.md queue 1)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, cosine_lr,
                    global_norm)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm"]
