"""Public model API: config → params and step functions.

The port of ``repro.models.zoo``'s ``init_params``, ``train_loss_fn``,
``prefill_fn`` and ``decode_fn``.  Parameters draw from a ``torch.Generator`` seeded with
``seed`` on ``device`` (``cuda`` unless the caller asks for the CPU);
they need not equal ``jax.random``'s — the tests carry the JAX
package's parameters across through ``core.interop.params_from_numpy``.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from ..core.device import default_device
from .parallel import Parallel
from . import transformer as T

__all__ = ["init_params", "train_loss_fn", "decode_fn", "prefill_fn",
           "default_device"]


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None):
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return T.init_params(gen, cfg)


def train_loss_fn(cfg: ModelConfig, par: Parallel, *, impl=None):
    def fn(params, batch):
        return T.train_loss(params, cfg, par, batch, impl=impl)
    return fn


def decode_fn(cfg: ModelConfig, par: Parallel, *, impl=None):
    def fn(params, state, token_ids):
        return T.decode_step(params, cfg, par, state, token_ids, impl=impl)
    return fn


def prefill_fn(cfg: ModelConfig, par: Parallel, s_cache: int, *, impl=None):
    def fn(params, batch):
        return T.prefill_forward(params, cfg, par, batch, s_cache, impl=impl)
    return fn
