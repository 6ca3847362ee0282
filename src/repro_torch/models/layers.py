"""Shared building blocks: norms, RoPE, the SwiGLU and GeGLU MLPs,
embeddings.

The port of ``repro.models.layers`` for the slice's configs.  Parameters
are plain nested dicts of tensors with the reference's layout (a dense
weight is ``(d_in, d_out)``, so ``y = x @ w + b`` on both sides and the
weight converter is a copy).  ``init_*`` draw from an explicit
``torch.Generator`` on the caller's device; they need not equal
``jax.random``'s draws (tests carry the JAX package's weights across
with ``core.interop.params_from_numpy``).

``mrope`` waits for the config that uses it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "dense", "rmsnorm_init", "rmsnorm", "embed_init",
           "rope", "swiglu_init", "swiglu", "geglu_init", "geglu"]


def _normal(gen: torch.Generator, shape, dtype, scale: float):
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, *, bias: bool = False,
               scale: float | None = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(gen, (d_in, d_out), dtype, scale)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype, device):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    """Gemma-style ``(1 + scale)`` RMS norm; f32 inside, ``x.dtype``
    out (as the reference)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def embed_init(gen, vocab: int, d: int, dtype):
    return {"table": _normal(gen, (vocab, d), dtype, 0.02)}


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding over the last dim of x: (B, S, H, D_head);
    positions: (B, S) int.  Angles and the rotation in f32."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_init(gen, d: int, d_ff: int, dtype):
    return {
        "wi": dense_init(gen, d, d_ff, dtype),
        "wg": dense_init(gen, d, d_ff, dtype),
        "wo": dense_init(gen, d_ff, d, dtype, scale=1.0 / math.sqrt(d_ff)),
    }


def swiglu(p, x):
    return dense(p["wo"], F.silu(dense(p["wg"], x)) * dense(p["wi"], x))


def geglu_init(gen, d: int, d_ff: int, dtype):
    return swiglu_init(gen, d, d_ff, dtype)


def geglu(p, x):
    """GeGLU with the tanh approximation of GELU (as the reference's
    ``jax.nn.gelu(approximate=True)``)."""
    return dense(p["wo"], F.gelu(dense(p["wg"], x), approximate="tanh")
                 * dense(p["wi"], x))
