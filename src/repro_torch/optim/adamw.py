"""AdamW with global-norm clipping: the port of ``repro.optim.adamw``.

The update is a plain elementwise pass in f32 with decoupled weight
decay on matrices only, as the reference computes it; it is no TPU
kernel, so it stays torch ops.  Moments are kept in f32, bf16 or as
blockwise int8 (bitsandbytes-style, ``v`` stored in sqrt-space).  The
reference donates the parameters and the optimizer state to its jitted
step; here :func:`adamw_update` writes the new values into the same
tensors and returns the same trees.

``opt_partition_specs`` (ZeRO-1 sharding specs) needs a mesh and waits
for the distributed slice (ROADMAP.md queue 1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_lr"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # "float32" | "bfloat16" | "int8" (blockwise-quantized moments)
    moments_dtype: str = "float32"
    q_block: int = 256


_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# blockwise int8 moment quantization
# ---------------------------------------------------------------------------
def _q8_encode(x: torch.Tensor, block: int) -> dict:
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()[:, 0]}


def _q8_decode(enc: dict, shape, block: int) -> torch.Tensor:
    vals = enc["q"].float() * enc["scale"][:, None]
    return vals.reshape(-1)[:math.prod(shape)].reshape(shape)


def _walk(ref, *others):
    """(leaf of ``ref``, the leaves at its place in ``others``), matched
    by dict key and sequence index, whatever order each dict keeps (the
    JAX package's trees come back with sorted keys): an int8 moment's
    ``{"q", "scale"}`` pair lands where its parameter is."""
    if isinstance(ref, dict):
        for k in ref:
            yield from _walk(ref[k], *(o[k] for o in others))
    elif isinstance(ref, (tuple, list)):
        for i, x in enumerate(ref):
            yield from _walk(x, *(o[i] for o in others))
    elif ref is not None:
        yield (ref, *others)


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; ``step``
    an int or an integer tensor.  Returns an f32 scalar tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def adamw_init(params, cfg: AdamWConfig | None = None) -> dict:
    """Zero moments shaped like ``params`` (in ``cfg.moments_dtype``, or
    int8-encoded) and a step count of 0, on the parameters' device."""
    cfg = cfg or AdamWConfig()
    leaves = pytree.tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    if cfg.moments_dtype == "int8":
        def zeros(p):
            return _q8_encode(torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), cfg.q_block)
    else:
        mdt = _MOMENT_DTYPES[cfg.moments_dtype]

        def zeros(p):
            return torch.zeros(p.shape, dtype=mdt, device=p.device)
    return {"m": pytree.tree_map(zeros, params),
            "v": pytree.tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in pytree.tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig, lr=None):
    """One AdamW step.  Writes the new parameters and moments into the
    tensors of ``params`` and ``state`` and returns ``(params, state,
    {"grad_norm", "lr"})``."""
    count = state["count"] + 1
    if lr is None:
        lr = cosine_lr(cfg, count)
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    q8 = cfg.moments_dtype == "int8"

    for g, m, v, p in _walk(grads, state["m"], state["v"], params):
        if q8:
            mf = _q8_decode(m, p.shape, cfg.q_block)
            vf = _q8_decode(v, p.shape, cfg.q_block) ** 2  # sqrt-space
        else:
            mf, vf = m.float(), v.float()
        g = g.float() * scale
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
        step = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        if q8:
            for enc, new in ((m, _q8_encode(mf, cfg.q_block)),
                             (v, _q8_encode(torch.sqrt(vf), cfg.q_block))):
                enc["q"].copy_(new["q"])
                enc["scale"].copy_(new["scale"])
        else:
            m.copy_(mf)
            v.copy_(vf)
    state = {"m": state["m"], "v": state["v"], "count": count}
    return params, state, {"grad_norm": gn, "lr": lr}
