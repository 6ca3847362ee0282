"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The port of ``repro.models.ssm``.  The mLSTM sequence path runs through
``kernels.ops.mlstm`` (the chunkwise kernel on the card); the sLSTM has
true recurrent weight connections and no parallel form, so its sequence
path is a loop over the steps in plain PyTorch, as the reference's is a
``lax.scan`` with no kernel.  Both expose single-step functions for
decode, whose carried states are fixed-schema dicts — relocatable
collection entries for the serving balancer — with their keys in sorted
order (``C, m, n`` and ``c, h, m, n``), the order ``jax.tree_util``
flattens them in.

The sLSTM loop applies the four input projections to the whole sequence
at once (they do not depend on the carried state) and the four
block-diagonal recurrent products as one ``einsum`` per step; each step
then computes what the reference's ``_slstm_cell`` computes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import dense, dense_init, geglu, geglu_init, rmsnorm, rmsnorm_init

__all__ = ["mlstm_block_init", "mlstm_block", "mlstm_block_step",
           "slstm_block_init", "slstm_block", "slstm_block_step",
           "mlstm_empty_state", "slstm_empty_state"]

_GATES = ("i", "f", "z", "o")


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------
def _mlstm_dims(cfg: ModelConfig, d: int):
    H = cfg.rec_heads or 4
    inner = int(cfg.proj_factor * d)
    return H, inner, inner // H


def mlstm_block_init(gen, cfg: ModelConfig, dtype):
    d = cfg.d_model
    H, inner, _ = _mlstm_dims(cfg, d)
    return {
        "w_up": dense_init(gen, d, 2 * inner, dtype),
        "w_down": dense_init(gen, inner, d, dtype),
        "wq": dense_init(gen, inner, inner, dtype),
        "wk": dense_init(gen, inner, inner, dtype),
        "wv": dense_init(gen, inner, inner, dtype),
        "w_igate": dense_init(gen, inner, H, dtype, bias=True),
        "w_fgate": dense_init(gen, inner, H, dtype, bias=True),
        "out_norm": rmsnorm_init(inner, dtype, gen.device),
    }


def _split_heads(x, H):
    B, S, inner = x.shape
    return x.reshape(B, S, H, inner // H).transpose(1, 2) \
            .reshape(B * H, S, inner // H)


def _merge_heads(x, B, H):
    BH, S, hd = x.shape
    return x.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd)


def mlstm_block(p, cfg: ModelConfig, x, *, impl=None, return_state=False):
    """x: (B, S, d) → (B, S, d) [, final mLSTM state for decode]."""
    B, S, d = x.shape
    H, inner, _ = _mlstm_dims(cfg, d)
    up = dense(p["w_up"], x)
    xin, zgate = up[..., :inner], up[..., inner:]
    q = _split_heads(dense(p["wq"], xin), H)
    k = _split_heads(dense(p["wk"], xin), H)
    v = _split_heads(dense(p["wv"], xin), H)
    ig = dense(p["w_igate"], xin)   # (B, S, H) pre-activations
    fg = dense(p["w_fgate"], xin)
    ig = ig.transpose(1, 2).reshape(B * H, S)
    fg = fg.transpose(1, 2).reshape(B * H, S)
    h, (C, n, m) = ops.mlstm(q, k, v, ig, fg, impl=impl, return_state=True)
    h = _merge_heads(h, B, H)
    h = rmsnorm(p["out_norm"], h, cfg.norm_eps)
    out = dense(p["w_down"], h * F.silu(zgate))
    if return_state:
        return out, {"C": C, "m": m, "n": n}
    return out


def mlstm_empty_state(cfg: ModelConfig, batch: int, *, device, lead=()):
    """Zero state (m = -inf); ``lead`` prepends axes (the stacked scan
    periods).  The leading state axis is batch * heads."""
    H, _, hd = _mlstm_dims(cfg, cfg.d_model)
    bh = batch * H
    return {
        "C": torch.zeros(lead + (bh, hd, hd), dtype=torch.float32,
                         device=device),
        "m": torch.full(lead + (bh,), float("-inf"), dtype=torch.float32,
                        device=device),
        "n": torch.zeros(lead + (bh, hd), dtype=torch.float32,
                         device=device),
    }


def mlstm_block_step(p, cfg: ModelConfig, x, state):
    """Single-token decode. x: (B, 1, d); state from mlstm_empty_state.
    Returns (out, new state); ``state`` is not written."""
    B, _, d = x.shape
    H, inner, hd = _mlstm_dims(cfg, d)
    up = dense(p["w_up"], x)
    xin, zgate = up[..., :inner], up[..., inner:]
    q = dense(p["wq"], xin).reshape(B * H, hd).float() / math.sqrt(hd)
    k = dense(p["wk"], xin).reshape(B * H, hd).float() / math.sqrt(hd)
    v = dense(p["wv"], xin).reshape(B * H, hd).float()
    ig = dense(p["w_igate"], xin).reshape(B * H).float()
    fg = dense(p["w_fgate"], xin).reshape(B * H).float()

    C, n, m = state["C"], state["n"], state["m"]
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + m, ig)
    fdec = torch.exp(logf + m - m_new)
    fdec = torch.where(torch.isfinite(fdec), fdec, torch.zeros_like(fdec))
    iamp = torch.exp(ig - m_new)
    C = fdec[:, None, None] * C + iamp[:, None, None] * (
        k[:, :, None] * v[:, None, :])
    n = fdec[:, None] * n + iamp[:, None] * k
    denom = torch.clamp(torch.abs(torch.sum(n * q, dim=-1)), min=1.0)
    h = torch.einsum("bkv,bk->bv", C, q) / denom[:, None]
    h = h.reshape(B, 1, inner).to(x.dtype)
    h = rmsnorm(p["out_norm"], h, cfg.norm_eps)
    out = dense(p["w_down"], h * F.silu(zgate))
    return out, {"C": C, "m": m_new, "n": n}


# ---------------------------------------------------------------------------
# sLSTM block (scalar memory, true recurrent connections)
# ---------------------------------------------------------------------------
def slstm_block_init(gen, cfg: ModelConfig, dtype):
    d = cfg.d_model
    H = cfg.rec_heads or 4
    hd = d // H
    p = {"in_norm": rmsnorm_init(d, dtype, gen.device)}
    for g in _GATES:
        p[f"w_{g}"] = dense_init(gen, d, d, dtype, bias=True)
    for g in _GATES:
        # recurrent block-diagonal weights: (H, hd, hd)
        p[f"r_{g}"] = (torch.randn((H, hd, hd), generator=gen,
                                   device=gen.device, dtype=torch.float32)
                       / math.sqrt(hd)).to(dtype)
    dff = max(-(-int(d * 4 / 3) // 256) * 256, 8) if d >= 256 \
        else max(int(d * 4 / 3), 8)
    p["ffn"] = geglu_init(gen, d, dff, dtype)
    p["ffn_norm"] = rmsnorm_init(d, dtype, gen.device)
    return p


def slstm_empty_state(cfg: ModelConfig, batch: int, *, device, lead=()):
    d = cfg.d_model
    z = lambda: torch.zeros(lead + (batch, d), dtype=torch.float32,  # noqa: E731
                            device=device)
    return {"c": z(), "h": z(),
            "m": torch.full(lead + (batch, d), float("-inf"),
                            dtype=torch.float32, device=device),
            "n": z()}


def _recurrent_weights(p):
    """(4, H, hd, hd) f32: r_i, r_f, r_z, r_o stacked."""
    return torch.stack([p[f"r_{g}"].float() for g in _GATES])


def _slstm_cell(pre, R, cfg: ModelConfig, state):
    """One sLSTM step.  ``pre``: the four input projections of this step
    (each (B, d), f32); ``R``: :func:`_recurrent_weights`."""
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    B, d = h.shape
    H = R.shape[1]
    hh = h.reshape(B, H, d // H).float()
    rec = torch.einsum("bhd,ghde->gbhe", hh, R).reshape(4, B, d)
    it = pre[0] + rec[0]
    ft = pre[1] + rec[1]
    zt = torch.tanh(pre[2] + rec[2])
    ot = torch.sigmoid(pre[3] + rec[3])
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    fdec = torch.exp(logf + m - m_new)
    fdec = torch.where(torch.isfinite(fdec), fdec, torch.zeros_like(fdec))
    iamp = torch.exp(it - m_new)
    c = fdec * c + iamp * zt
    n = fdec * n + iamp
    h_new = ot * c / torch.clamp(n, min=1.0)
    return {"c": c, "h": h_new, "m": m_new, "n": n}


def _input_projections(p, xn):
    """The four gate pre-activations of every step: (4, ..., d) f32."""
    return torch.stack([dense(p[f"w_{g}"], xn).float() for g in _GATES])


def slstm_block(p, cfg: ModelConfig, x, *, return_state=False):
    """x: (B, S, d) → (B, S, d), one step at a time."""
    B, S, d = x.shape
    xn = rmsnorm(p["in_norm"], x, cfg.norm_eps)
    pre = _input_projections(p, xn)                     # (4, B, S, d)
    R = _recurrent_weights(p)
    state = slstm_empty_state(cfg, B, device=x.device)
    hs = torch.empty((B, S, d), dtype=torch.float32, device=x.device)
    for t in range(S):
        state = _slstm_cell(pre[:, :, t], R, cfg, state)
        hs[:, t] = state["h"]
    y = x + hs.to(x.dtype)
    out = y + geglu(p["ffn"], rmsnorm(p["ffn_norm"], y, cfg.norm_eps))
    if return_state:
        return out, state
    return out


def slstm_block_step(p, cfg: ModelConfig, x, state):
    """x: (B, 1, d).  Returns (out, new state); ``state`` is not
    written."""
    xn = rmsnorm(p["in_norm"], x, cfg.norm_eps)[:, 0]
    new = _slstm_cell(_input_projections(p, xn), _recurrent_weights(p),
                      cfg, state)
    y = x + new["h"][:, None, :].to(x.dtype)
    out = y + geglu(p["ffn"], rmsnorm(p["ffn_norm"], y, cfg.norm_eps))
    return out, new
