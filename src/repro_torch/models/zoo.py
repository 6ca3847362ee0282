"""Public model API: config → params and step functions.

The port of ``repro.models.zoo``'s ``init_params``, ``prefill_fn`` and
``decode_fn``.  Parameters draw from a ``torch.Generator`` seeded with
``seed`` on ``device`` (``cuda`` unless the caller asks for the CPU);
they need not equal ``jax.random``'s — the tests carry the JAX
package's parameters across through ``core.interop.params_from_numpy``.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .parallel import Parallel
from . import transformer as T

__all__ = ["init_params", "decode_fn", "prefill_fn", "default_device"]


def default_device(device=None) -> torch.device:
    """``device``, or the CUDA card when none is given; with no card the
    caller must ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port's models default to the CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None):
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return T.init_params(gen, cfg)


def decode_fn(cfg: ModelConfig, par: Parallel, *, impl=None):
    def fn(params, state, token_ids):
        return T.decode_step(params, cfg, par, state, token_ids, impl=impl)
    return fn


def prefill_fn(cfg: ModelConfig, par: Parallel, s_cache: int, *, impl=None):
    def fn(params, batch):
        return T.prefill_forward(params, cfg, par, batch, s_cache, impl=impl)
    return fn
