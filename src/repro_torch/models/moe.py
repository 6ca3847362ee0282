"""Mixture-of-Experts with capacity dispatch, and DeepSeek's Multi-head
Latent Attention (MLA).

The port of ``repro.models.moe``.  The token → expert dispatch is a
collective relocation specialized to a fixed schema: the router is the
key → destination rule, the expert-capacity buffers are the relocation's
per-destination buffers (``core/relocation._pack_slots`` /
``_pack_by_dest``), and the weighted combine is the accumulator's
'accept'.  ``moe_forward_dense`` runs both halves on one device; under
the ``fused`` backend they go through the port's kernels
(``ops.gather_rows`` builds the buffers from a source table,
``ops.moe_combine`` takes the expert outputs back to token order), under
``composite`` through the reference's own lines (``repeat`` +
``_pack_by_dest`` + a masked gather + an einsum).  The two compute the
same function: the buffers are equal bit for bit.  The expert products
are batched ``torch.bmm`` calls, plain products as XLA computed them
outside any kernel.

``mla_forward`` (prefill) materializes per-head K/V from the latent and
attends through ``ops.attention`` (the flash kernel, at head dim
``qk_nope + qk_rope``; V is padded to it and sliced back);
``mla_attend_cache`` (decode) is the absorbed form against the latent
cache in plain tensor ops, as the reference computes it outside any
kernel.  ``expert_all_to_all`` / ``expert_replicated`` shard experts
over a mesh axis and wait for the distributed slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.relocation import _pack_by_dest, _pack_slots
from ..kernels import ops
from .config import ModelConfig
from .layers import (_normal, dense, dense_init, rmsnorm, rmsnorm_init, rope,
                     swiglu, swiglu_init)

__all__ = ["router_init", "route", "moe_init", "moe_forward_dense",
           "expert_all_to_all", "expert_replicated", "mla_init",
           "mla_forward", "mla_decode", "mla_decode_project",
           "mla_attend_cache"]


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------
def router_init(gen, d: int, n_experts: int, dtype):
    """Router weights, drawn and kept in f32 whatever ``dtype`` is (as
    the reference's)."""
    return {"w": dense_init(gen, d, n_experts, torch.float32)}


def route(p, x, top_k: int, *, n_experts: int):
    """Top-k softmax router (DeepSeek style: softmax over all experts,
    the selected weights renormalized).

    x: (T, d) → (weights (T, k) f32, idx (T, k) int32, aux metrics)."""
    logits = x.float() @ p["w"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    # aux load-balance loss (Switch/GShard form) + router z-loss
    me = probs.mean(dim=0)                                        # (E,)
    ce = F.one_hot(top_i, n_experts).float().sum(dim=1).mean(dim=0)
    aux = n_experts * (me * ce).sum() / top_k
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return top_p, top_i.to(torch.int32), {"aux": aux, "z": z}


# ---------------------------------------------------------------------------
# Experts
# ---------------------------------------------------------------------------
def moe_init(gen, cfg: ModelConfig, dtype):
    d, dff, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    p = {"router": router_init(gen, d, E, dtype),
         "experts": {
             "wi": _normal(gen, (E, d, dff), dtype, 1.0 / math.sqrt(d)),
             "wg": _normal(gen, (E, d, dff), dtype, 1.0 / math.sqrt(d)),
             "wo": _normal(gen, (E, dff, d), dtype, 1.0 / math.sqrt(dff)),
         }}
    if cfg.n_shared_experts:
        p["shared"] = swiglu_init(gen, d, dff * cfg.n_shared_experts, dtype)
    return p


def _expert_ffn(bank, x):
    """Batched expert SwiGLU: x (E, C, d) → (E, C, d)."""
    h = F.silu(torch.bmm(x, bank["wg"])) * torch.bmm(x, bank["wi"])
    return torch.bmm(h, bank["wo"])


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Rows per expert buffer.  The floor ``min(T, 64)`` makes small
    batches (decode) drop-free: an expert receives at most T rows (a
    token's top-k experts are distinct)."""
    return max(int(cfg.capacity_factor * n_tokens * cfg.top_k
                   / cfg.n_experts), min(n_tokens, 64))


def moe_dispatch(xt, idx, n_experts: int, cap: int, *, impl=None):
    """Pack the (token, k) rows into expert-capacity buffers.

    xt: (T, d); idx: (T, K) expert ids.  Returns (buf (E, cap, d),
    slot (T·K,) int64: the flat buffer position of each (token, k) row,
    -1 where it overflowed its expert's capacity).  ``fused`` computes
    the slots with ``_pack_by_dest``'s index arithmetic, inverts them
    into a source table (token index, or T for an empty slot, which
    reads an appended zero row) and gathers the buffer with
    ``ops.gather_rows``; ``composite`` packs the repeated rows with
    ``_pack_by_dest`` itself, as the reference does."""
    T, d = xt.shape
    K = idx.shape[1]
    if ops.resolve_backend(impl, xt.device) == "composite":
        rows = xt.repeat_interleave(K, dim=0)
        buf, _, slot = _pack_by_dest(rows[None], idx.reshape(1, T * K),
                                     n_experts, cap)
        return buf[0], slot[0]
    src, slot = dispatch_tables(idx, n_experts, cap)
    xpad = torch.cat([xt, xt.new_zeros((1, d))])
    buf = ops.gather_rows(xpad, src, impl="fused")
    return buf.view(n_experts, cap, d), slot


def dispatch_tables(idx, n_experts: int, cap: int):
    """The fused dispatch's tables for idx (T, K): (src (E·cap,) int32,
    the token each buffer row reads — T for an empty row, which reads
    the zero row appended to the tokens; slot (T·K,) int64, each (token,
    k) row's buffer position or -1)."""
    T, K = idx.shape
    flat = n_experts * cap
    slot, keep = _pack_slots(idx.reshape(1, T * K), n_experts, cap)
    slot, keep = slot[0], keep[0]
    # a scatter, not a boolean index, so the host never waits on the
    # card; dropped rows (slot == flat) land in a dump entry cut off
    src = torch.full((flat + 1,), T, dtype=torch.int32, device=idx.device)
    token = torch.arange(T * K, device=idx.device) // K
    src.scatter_(0, slot, token.to(torch.int32))
    return src[:flat], torch.where(keep, slot, torch.full_like(slot, -1))


def moe_combine(yf, slot, w, *, impl=None):
    """Expert outputs in slot order, yf (E·cap, d), back to token order:
    ``out[t] = sum_k w[t, k] * yf[slot[t, k]]`` in f32, a dropped row
    (slot -1) contributing 0; the result in ``yf.dtype``."""
    T, K = w.shape
    slot = slot.view(T, K)
    if ops.resolve_backend(impl, yf.device) == "composite":
        ok = slot >= 0
        safe = torch.where(ok, slot, torch.zeros_like(slot))
        back = torch.where(ok[..., None], yf[safe], yf.new_zeros(()))
        return torch.einsum("tk,tkd->td", w.float(),
                            back.float()).to(yf.dtype)
    return ops.moe_combine(yf, slot.to(torch.int32), w, impl="fused")


def moe_forward_dense(p, cfg: ModelConfig, x, *, impl=None):
    """Single-device MoE: capacity dispatch without a mesh.
    x: (B, S, d) → (out (B, S, d), aux metrics)."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    w, idx, aux = route(p["router"], xt, K, n_experts=E)
    cap = moe_capacity(cfg, T)
    buf, slot = moe_dispatch(xt, idx, E, cap, impl=impl)
    y = _expert_ffn(p["experts"], buf.to(x.dtype))                # (E, cap, d)
    out = moe_combine(y.reshape(E * cap, d), slot, w, impl=impl)
    if "shared" in p:
        out = out + swiglu(p["shared"], xt)
    return out.reshape(B, S, d), aux


def expert_all_to_all(*args, **kwargs):
    """Expert-parallel MoE inside a mesh: needs a model axis to shard the
    experts over."""
    raise NotImplementedError(
        "expert_all_to_all needs a mesh axis: it waits for the distributed "
        "slice (ROADMAP.md queue 1)")


def expert_replicated(*args, **kwargs):
    """Decode-mode expert parallelism over a mesh axis."""
    raise NotImplementedError(
        "expert_replicated needs a mesh axis: it waits for the distributed "
        "slice (ROADMAP.md queue 1)")


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek V2/V3)
# ---------------------------------------------------------------------------
def mla_init(gen, cfg: ModelConfig, dtype):
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    p = {
        "w_dkv": dense_init(gen, d, r, dtype),            # down: latent kv
        "w_krope": dense_init(gen, d, dr, dtype),         # shared rope key
        "kv_norm": rmsnorm_init(r, dtype, gen.device),
        "w_uk": dense_init(gen, r, H * dn, dtype),        # up: keys
        "w_uv": dense_init(gen, r, H * dv, dtype),        # up: values
        "wo": dense_init(gen, H * dv, d, dtype),
    }
    if cfg.q_lora_rank:
        p["w_dq"] = dense_init(gen, d, cfg.q_lora_rank, dtype)
        p["q_norm"] = rmsnorm_init(cfg.q_lora_rank, dtype, gen.device)
        p["w_uq"] = dense_init(gen, cfg.q_lora_rank, H * (dn + dr), dtype)
    else:
        p["w_q"] = dense_init(gen, d, H * (dn + dr), dtype)
    return p


def _pos2(positions):
    return positions if positions.dim() == 2 else positions[0]


def _mla_q(p, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        cq = rmsnorm(p["q_norm"], dense(p["w_dq"], x), cfg.norm_eps)
        q = dense(p["w_uq"], cq)
    else:
        q = dense(p["w_q"], x)
    q = q.reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, rope(q_rope, _pos2(positions), cfg.rope_theta)


def mla_forward(p, cfg: ModelConfig, x, positions, *, impl=None):
    """MLA prefill: materializes per-head K/V from the latent.  Returns
    (out, (c_kv (B, S, r), k_rope (B, S, dr))) — the compressed cache
    entries."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv = rmsnorm(p["kv_norm"], dense(p["w_dkv"], x), cfg.norm_eps)
    k_rope = rope(dense(p["w_krope"], x).reshape(B, S, 1, dr),
                  _pos2(positions), cfg.rope_theta)               # (B,S,1,dr)
    k_nope = dense(p["w_uk"], c_kv).reshape(B, S, H, dn)
    v = dense(p["w_uv"], c_kv).reshape(B, S, H, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)                 # (B,S,H,dn+dr)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    # pad v to the q/k head dim for the shared attention kernel, slice
    # after
    if dv < dn + dr:
        v = F.pad(v, (0, dn + dr - dv))
    out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True,
                        sm_scale=1.0 / math.sqrt(dn + dr), impl=impl)
    out = out.transpose(1, 2)[..., :dv].reshape(B, S, H * dv)
    return dense(p["wo"], out), (c_kv, k_rope[:, :, 0, :])


def mla_decode_project(p, cfg: ModelConfig, x, positions):
    """MLA decode projections: latent cache rows + absorbed queries.
    Returns ((q_nope, q_rope), c_new (B, r), kr_new (B, dr))."""
    B = x.shape[0]
    dr = cfg.qk_rope_dim
    q_pair = _mla_q(p, cfg, x, positions)
    c_new = rmsnorm(p["kv_norm"], dense(p["w_dkv"], x), cfg.norm_eps)
    kr_new = rope(dense(p["w_krope"], x).reshape(B, 1, 1, dr),
                  _pos2(positions), cfg.rope_theta)[:, 0, 0]
    return q_pair, c_new[:, 0], kr_new


def mla_attend_cache(p, cfg: ModelConfig, q_pair, cache_ckv, cache_krope,
                     cache_pos, cur):
    """Absorbed-form MLA attention against the (already updated) latent
    cache, which holds only c_kv (r) + k_rope (dr) per token.  ``cur``
    (B, 1): the current position (included in the mask)."""
    q_nope, q_rope = q_pair
    B = q_nope.shape[0]
    H, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    # absorb W_uk into q: q_abs (B, 1, H, r)
    w_uk = p["w_uk"]["w"].float().reshape(r, H, dn)
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_uk)
    valid = (cache_pos >= 0) & (cache_pos <= cur)
    ckv = cache_ckv.float()
    krp = cache_krope.float()
    s = (torch.einsum("bshr,btr->bhst", q_abs, ckv)[:, :, 0]
         + torch.einsum("bshd,btd->bhst", q_rope.float(), krp)[:, :, 0]) \
        / math.sqrt(dn + dr)
    vmask = valid[:, None, :]
    s = s.masked_fill(~vmask, float("-inf"))
    mx = s.amax(dim=-1, keepdim=True)
    pr = torch.exp(s - torch.where(torch.isfinite(mx), mx,
                                   torch.zeros_like(mx)))
    pr = pr.masked_fill(~vmask, 0.0)
    pr = pr / pr.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    ctx = torch.einsum("bht,btr->bhr", pr, ckv)
    w_uv = p["w_uv"]["w"].float().reshape(r, H, dv)
    out = torch.einsum("bhr,rhv->bhv", ctx, w_uv)
    out = out.reshape(B, 1, H * dv).to(cache_ckv.dtype)
    return dense(p["wo"], out)


def mla_decode(p, cfg: ModelConfig, x, positions, cache_ckv, cache_krope,
               cache_pos):
    """Single-call MLA decode (project → write → attend), out of place.
    Returns (out, c_new, kr_new)."""
    B = x.shape[0]
    q_pair, c_new, kr_new = mla_decode_project(p, cfg, x, positions)
    cur = positions.reshape(B, 1)
    slot = (cur[:, 0] % cache_ckv.shape[1]).long()
    bidx = torch.arange(B, device=x.device)
    ckv = cache_ckv.index_put((bidx, slot), c_new.to(cache_ckv.dtype))
    krp = cache_krope.index_put((bidx, slot), kr_new.to(cache_krope.dtype))
    cp = cache_pos.index_put((bidx, slot), cur[:, 0].to(cache_pos.dtype))
    out = mla_attend_cache(p, cfg, q_pair, ckv, krp, cp, cur)
    return out, c_new, kr_new
