"""GQA attention: the prefill path and the decode-with-cache path.

The port of ``repro.models.attention``.  ``attn_forward`` (train /
prefill) goes through ``kernels.ops.attention`` — the hand-written flash
kernel on the card — as the reference goes through its Pallas kernel;
``attn_attend_cache`` (one query against the cache) stays plain tensor
ops, as the reference computes it outside any kernel.
``seq_parallel_decode_attention`` needs a sequence-sharded cache and
waits for the distributed slice.
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops
from .config import ModelConfig
from .layers import dense, dense_init, rmsnorm, rmsnorm_init, rope

__all__ = ["attn_init", "attn_forward", "attn_decode",
           "attn_decode_project", "attn_attend_cache",
           "seq_parallel_decode_attention"]


def attn_init(gen, cfg: ModelConfig, dtype):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, bias=cfg.qkv_bias),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype,
                         bias=cfg.qkv_bias),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype,
                         bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, gen.device)
        p["k_norm"] = rmsnorm_init(hd, dtype, gen.device)
    return p


def _project_qkv(p, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE comes with qwen2-vl (ROADMAP.md "
                                  "queue 1, slice 4)")
    pos = positions if positions.dim() == 2 else positions[0]
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def attn_forward(p, cfg: ModelConfig, x, positions, *, causal=True,
                 window=None, kv_override=None, impl=None, par=None):
    """Full-sequence attention (train / prefill).  Returns (out, (k, v))
    so prefill can seed the cache."""
    if kv_override is not None:
        raise NotImplementedError("cross-attention comes with whisper "
                                  "(ROADMAP.md queue 1, slice 4)")
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(p, cfg, x, positions)
    # (B, S, H, D) -> (B, H, S, D) as strided views: the kernel reads
    # them in place
    out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        softcap=cfg.attn_softcap, impl=impl)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * hd)
    return dense(p["wo"], out), (k, v)


def attn_decode_project(p, cfg: ModelConfig, x, positions):
    """Decode-side QKV projection; the caller writes k/v into the cache
    *before* attending (write-then-attend)."""
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    return q, k_new[:, 0], v_new[:, 0]


def attn_attend_cache(p, cfg: ModelConfig, q, cache_k, cache_v, cache_pos,
                      cur, *, window=None):
    """Attend a single query against the (already updated) cache.

    ``cache_pos`` (B, S_cache) holds the global position stored in each
    cache slot, or -1 for empty.  q: (B, 1, Hq, hd); cur: (B, 1) current
    position (included in the mask).
    """
    B = q.shape[0]
    hd = cfg.resolved_head_dim
    valid = (cache_pos >= 0) & (cache_pos <= cur)            # (B, S_cache)
    if window is not None:
        valid &= cache_pos > (cur - window)
    group = cfg.n_heads // cfg.n_kv_heads
    qh = q.reshape(B, cfg.n_kv_heads, group, hd).float()
    kf = cache_k.float()                                     # (B, S, Hkv, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qh, kf) / math.sqrt(hd)
    if cfg.attn_softcap > 0:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    vmask = valid[:, None, None, :]
    s = s.masked_fill(~vmask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    pr = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    pr = pr.masked_fill(~vmask, 0.0)
    denom = pr.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bkgs,bskd->bkgd", pr / denom, cache_v.float())
    out = out.reshape(B, 1, cfg.n_heads * hd).to(cache_k.dtype)
    return dense(p["wo"], out)


def attn_decode(p, cfg: ModelConfig, x, positions, cache_k, cache_v,
                cache_pos, *, window=None):
    """Single-call decode (project → write → attend), out of place."""
    B = x.shape[0]
    q, k_new, v_new = attn_decode_project(p, cfg, x, positions)
    cur = positions.reshape(B, 1)
    size = cache_k.shape[1]
    slot = (cur[:, 0] % size).long()
    bidx = torch.arange(B, device=x.device)
    ck = cache_k.index_put((bidx, slot), k_new.to(cache_k.dtype))
    cv = cache_v.index_put((bidx, slot), v_new.to(cache_v.dtype))
    cp = cache_pos.index_put((bidx, slot), cur[:, 0].to(cache_pos.dtype))
    out = attn_attend_cache(p, cfg, q, ck, cv, cp, cur, window=window)
    return out, k_new, v_new


def seq_parallel_decode_attention(*args, **kwargs):
    """Flash-decoding over a sequence-sharded KV cache: needs a mesh
    axis to shard the cache over."""
    raise NotImplementedError(
        "seq_parallel_decode_attention needs a sequence-sharded cache: it "
        "waits for the distributed slice (ROADMAP.md queue 1)")
