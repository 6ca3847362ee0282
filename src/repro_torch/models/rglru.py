"""Griffin / RecurrentGemma recurrent block: causal conv + RG-LRU.

The port of ``repro.models.rglru``.  The sequence path runs the RG-LRU
scan through ``kernels.ops.rg_lru_scan`` (the hand-written kernel on the
card); decode is a single-step update whose state (LRU hidden + conv
tail) is a fixed-schema dict — a relocatable entry for the serving
balancer.  State dicts keep their keys in sorted order (``conv_tail``,
``h``), the order ``jax.tree_util`` flattens them in.

The causal convolution stays an explicit sum of ``W`` shifted products
in the input dtype and in the reference's order: ``conv1d`` would run
f32 convolutions through cuDNN, in TF32 by default on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import dense, dense_init

__all__ = ["rglru_block_init", "rglru_block", "rglru_block_step",
           "rglru_empty_state"]

_C = 8.0  # Griffin's fixed recurrence sharpness


def rglru_block_init(gen, cfg: ModelConfig, dtype):
    d = cfg.d_model
    rec = cfg.rec_dim or d
    dev = gen.device
    # Λ so that a^c spans (0.9, 0.999) as in Griffin (inverse softplus)
    lam = torch.log(torch.expm1(
        -torch.log(torch.linspace(0.9, 0.999, rec, dtype=torch.float32,
                                  device=dev)) / _C))
    return {
        "w_gate": dense_init(gen, d, rec, dtype),
        "w_x": dense_init(gen, d, rec, dtype),
        "conv": (torch.randn((cfg.conv_width, rec), generator=gen,
                             device=dev, dtype=torch.float32)
                 / math.sqrt(cfg.conv_width)).to(dtype),
        "conv_b": torch.zeros((rec,), dtype=dtype, device=dev),
        "w_rg": dense_init(gen, rec, rec, dtype, bias=True),  # recurrence gate
        "w_ig": dense_init(gen, rec, rec, dtype, bias=True),  # input gate
        "lam": lam,
        "w_out": dense_init(gen, rec, d, dtype),
    }


def _causal_conv(w, b, x, tail=None):
    """Depthwise causal conv. x: (B, S, rec); tail: (B, W-1, rec) carried
    inputs from previous steps (decode) or None (zeros)."""
    W = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[-1]))
    xp = torch.cat([tail, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return out + b, xp[:, -(W - 1):, :]


def _gates(p, u):
    r = torch.sigmoid(dense(p["w_rg"], u).float())
    i = torch.sigmoid(dense(p["w_ig"], u).float())
    # softplus(Λ) in Λ's dtype (cast_params casts it with every float
    # leaf), then promoted against the f32 gate, as in the reference
    log_a = -_C * F.softplus(p["lam"]) * r              # (B, S, rec)
    return torch.exp(log_a), i


def rglru_block(p, cfg: ModelConfig, x, *, impl=None, return_state=False):
    """x: (B, S, d) → (B, S, d) [, final {conv_tail, h} state]."""
    gate = F.gelu(dense(p["w_gate"], x), approximate="tanh")
    u_raw = dense(p["w_x"], x)
    u, tail = _causal_conv(p["conv"], p["conv_b"], u_raw)
    a, i = _gates(p, u)
    h, h_last = ops.rg_lru_scan(i * u.float(), a, impl=impl)
    out = dense(p["w_out"], h.to(x.dtype) * gate)
    if return_state:
        return out, {"conv_tail": tail.float(), "h": h_last}
    return out


def rglru_empty_state(cfg: ModelConfig, batch: int, *, device, lead=()):
    """Zero state; ``lead`` prepends axes (the stacked scan periods)."""
    rec = cfg.rec_dim or cfg.d_model
    return {
        "conv_tail": torch.zeros(lead + (batch, cfg.conv_width - 1, rec),
                                 dtype=torch.float32, device=device),
        "h": torch.zeros(lead + (batch, rec), dtype=torch.float32,
                         device=device),
    }


def rglru_block_step(p, cfg: ModelConfig, x, state):
    """x: (B, 1, d).  Returns (out, new state); ``state`` is not
    written."""
    gate = F.gelu(dense(p["w_gate"], x), approximate="tanh")
    u = dense(p["w_x"], x)
    u, tail = _causal_conv(p["conv"], p["conv_b"], u,
                           state["conv_tail"].to(u.dtype))
    a, i = _gates(p, u)
    b = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0)) * (i * u.float())
    h = a[:, 0] * state["h"] + b[:, 0]
    out = dense(p["w_out"], h[:, None, :].to(x.dtype) * gate)
    return out, {"conv_tail": tail.float(), "h": h}
