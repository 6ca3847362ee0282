"""Composable decoder LM: the port of ``repro.models.transformer`` for
``attn_global`` / ``attn_local`` mixers with dense SwiGLU FFNs.

The parameter and decode-state pytrees keep the reference's layout —
dicts and tuples, ``prefix`` (unstacked) + ``scan`` (one stacked dict
per pattern slot, leading axis = pattern period) + ``suffix`` — so the
relocation engine ships the same ``SeqKV`` payload and the tests compare
the two packages leaf by leaf.  Decode-state dicts are built with their
keys in sorted order: ``jax.tree_util`` flattens dicts by sorted key,
``torch.utils._pytree`` by insertion order, and the row codec lays the
leaves out in flatten order.  ``jax.lax.scan`` over the stacked
periods becomes a Python loop over ``params["scan"][j][i]`` views.

Other mixers (``mla``, ``rec``, ``mlstm``, ``slstm``), MoE FFNs and
cross-attention raise ``NotImplementedError`` (ROADMAP.md queue 1, slice
3); ``train_loss`` / ``lm_loss`` wait for the training slice.

Two departures from a line-by-line copy, neither of which changes a
result:

* ``cast_params`` casts the f32 master parameters to the compute dtype;
  under ``jit`` the reference pays nothing for doing that on every call,
  eagerly it would re-read and re-write every weight per decode step.
  Here a tensor that already has the compute dtype is passed through
  as it is, so a caller that casts once (``DecodeEngine``) pays once.
* the reference's functional write-then-attend (``.at[].set``) is one
  clone of the incoming decode state per step, then in-place writes into
  the clone: the caller's state (a ``SeqKV`` an in-flight migration
  window may be reading) is never written.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils import _pytree as pytree

from .attention import (attn_attend_cache, attn_decode_project, attn_forward,
                        attn_init)
from .config import LayerSlot, ModelConfig
from .layers import (dense_init, embed_init, rmsnorm, rmsnorm_init, swiglu,
                     swiglu_init)
from .parallel import Parallel, constrain

__all__ = ["init_params", "decode_step", "prefill", "prefill_forward",
           "init_decode_state", "cast_params"]

_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}

_SLICE3 = "ROADMAP.md queue 1, slice 3"


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPE[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def _check_supported(cfg: ModelConfig) -> None:
    for slot in cfg.layer_slots():
        if slot.mixer not in ("attn_global", "attn_local"):
            raise NotImplementedError(
                f"mixer {slot.mixer!r} is not ported yet ({_SLICE3})")
        if slot.ffn != "dense":
            raise NotImplementedError(
                f"ffn {slot.ffn!r} is not ported yet ({_SLICE3})")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"encoder-decoder configs ({_SLICE3})")
    if cfg.mtp_depth:
        raise NotImplementedError(f"multi-token prediction ({_SLICE3})")


def cast_params(params, cfg: ModelConfig):
    """f32 master params → compute dtype (mixed precision).  Leaves that
    already have the compute dtype pass through uncopied."""
    cd = _torch_dtype(cfg.dtype)

    def cast(a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.to(cd)
        return a

    return pytree.tree_map(cast, params)


# ---------------------------------------------------------------------------
# Block init / forward
# ---------------------------------------------------------------------------
def _block_init(gen, cfg: ModelConfig, slot: LayerSlot, dtype):
    p: dict[str, Any] = {
        "norm1": rmsnorm_init(cfg.d_model, dtype, gen.device),
        "mixer": attn_init(gen, cfg, dtype),
        "norm2": rmsnorm_init(cfg.d_model, dtype, gen.device),
        "ffn": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype),
    }
    return p


def _zero_aux(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"aux": z, "z": z}


def _block_forward(p, cfg: ModelConfig, slot: LayerSlot, par: Parallel, x,
                   positions, *, impl=None, causal=True):
    """Full-sequence block application. Returns (x, aux, cache_entry)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    window = cfg.window if slot.mixer == "attn_local" else None
    y, cache = attn_forward(p["mixer"], cfg, h, positions, causal=causal,
                            window=window, impl=impl, par=par)
    x = x + y
    x = x + swiglu(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x, _zero_aux(x.device), cache


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------
def _layer_plan(cfg: ModelConfig):
    """(prefix_slots, n_periods, suffix_slots) honoring first_dense."""
    slots = cfg.layer_slots()
    period = len(cfg.pattern)
    n_prefix = cfg.first_dense_layers
    rest = len(slots) - n_prefix
    n_periods = rest // period
    return (slots[:n_prefix], n_periods,
            slots[n_prefix + n_periods * period:])


def _stack(trees):
    return pytree.tree_map(lambda *a: torch.stack(a), *trees)


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random parameters (in ``cfg.param_dtype``) on ``gen.device``."""
    _check_supported(cfg)
    dtype = _torch_dtype(cfg.param_dtype)
    prefix_slots, n_periods, suffix_slots = _layer_plan(cfg)
    p: dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_padded, dtype)
    p["prefix"] = tuple(_block_init(gen, cfg, s, dtype)
                        for s in prefix_slots)
    p["scan"] = tuple(
        _stack([_block_init(gen, cfg, slot, dtype)
                for _ in range(n_periods)])
        for slot in cfg.pattern) if n_periods else ()
    p["suffix"] = tuple(_block_init(gen, cfg, s, dtype)
                        for s in suffix_slots)
    return p


# ---------------------------------------------------------------------------
# Forward trunk
# ---------------------------------------------------------------------------
def _positions_for(cfg: ModelConfig, batch) -> torch.Tensor:
    if cfg.mrope_sections:
        raise NotImplementedError(f"M-RoPE positions ({_SLICE3})")
    tokens = batch["tokens"]
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device)[None].expand(B, S)


def _embed(params, cfg: ModelConfig, tokens):
    h = params["embed"]["table"][tokens.long()]
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h.to(_torch_dtype(cfg.dtype))


def _period(params_scan, i: int):
    """Period ``i`` of the stacked scan params: views, no copy."""
    return pytree.tree_map(lambda a: a[i], params_scan)


def _trunk(params, cfg: ModelConfig, par: Parallel, h, positions, *,
           impl=None, collect_caches=False):
    """prefix → scanned periods → suffix.

    Returns (h, aux_sum, z_sum[, caches]) — caches mirror the decode
    state layout when collect_caches=True (prefill)."""
    prefix_slots, n_periods, suffix_slots = _layer_plan(cfg)
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = {"prefix": [], "scan": (), "suffix": []}

    for p_blk, slot in zip(params["prefix"], prefix_slots):
        h, aux, c = _block_forward(p_blk, cfg, slot, par, h, positions,
                                   impl=impl)
        aux_sum = aux_sum + aux["aux"]
        z_sum = z_sum + aux["z"]
        caches["prefix"].append(c)

    if n_periods:
        percall = []
        for i in range(n_periods):
            stacked = _period(params["scan"], i)
            cs = []
            for j, slot in enumerate(cfg.pattern):
                h, aux, c = _block_forward(stacked[j], cfg, slot, par, h,
                                           positions, impl=impl)
                aux_sum = aux_sum + aux["aux"]
                z_sum = z_sum + aux["z"]
                cs.append(c)
            h = constrain(par, h)
            if collect_caches:
                percall.append(tuple(cs))
        if collect_caches:
            caches["scan"] = _stack(percall)

    for p_blk, slot in zip(params["suffix"], suffix_slots):
        h, aux, c = _block_forward(p_blk, cfg, slot, par, h, positions,
                                   impl=impl)
        aux_sum = aux_sum + aux["aux"]
        z_sum = z_sum + aux["z"]
        caches["suffix"].append(c)

    if collect_caches:
        return h, aux_sum, z_sum, caches
    return h, aux_sum, z_sum


def _head_table(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"]["table"]              # (V, d)
    return params["head"]["w"].T                      # (V, d)


def _logits(params, cfg: ModelConfig, h):
    """(B, d) final hidden → (B, V) f32 logits."""
    table = _head_table(params, cfg)
    logits = h.float() @ table.float().T
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


# ---------------------------------------------------------------------------
# Serving: decode with caches
# ---------------------------------------------------------------------------
def _slot_cache_shape(cfg: ModelConfig, slot: LayerSlot, batch: int,
                      s_cache: int, device, lead: tuple = ()):
    hd = cfg.resolved_head_dim
    if slot.mixer not in ("attn_global", "attn_local"):
        raise NotImplementedError(
            f"mixer {slot.mixer!r} is not ported yet ({_SLICE3})")
    size = s_cache if slot.mixer == "attn_global" else min(
        s_cache, cfg.window or s_cache)
    dt = _torch_dtype(cfg.dtype)
    return {
        "k": torch.zeros(lead + (batch, size, cfg.n_kv_heads, hd),
                         dtype=dt, device=device),
        "pos": torch.full(lead + (batch, size), -1, dtype=torch.int32,
                          device=device),
        "v": torch.zeros(lead + (batch, size, cfg.n_kv_heads, hd),
                         dtype=dt, device=device),
    }


def init_decode_state(cfg: ModelConfig, batch: int, s_cache: int, *,
                      device="cpu"):
    """Empty decode state (zeros; cache positions -1) on ``device``."""
    _check_supported(cfg)
    prefix_slots, n_periods, suffix_slots = _layer_plan(cfg)
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "prefix": tuple(_slot_cache_shape(cfg, s, batch, s_cache, device)
                        for s in prefix_slots),
        "scan": tuple(
            _slot_cache_shape(cfg, slot, batch, s_cache, device,
                              (n_periods,))
            for slot in cfg.pattern) if n_periods else (),
        "suffix": tuple(_slot_cache_shape(cfg, s, batch, s_cache, device)
                        for s in suffix_slots),
    }


def _block_decode(p, cfg: ModelConfig, slot: LayerSlot, par: Parallel, x,
                  positions, cache):
    """One-token decode through a block.  ``cache`` is owned by the
    caller's fresh clone of the state: the new row is written into it in
    place, then attended (write-then-attend).  Returns (x, cache)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    window = cfg.window if slot.mixer == "attn_local" else None
    q, k_new, v_new = attn_decode_project(p["mixer"], cfg, h, positions)
    size = cache["k"].shape[1]
    wslot = (positions[:, 0] % size).long()
    bidx = torch.arange(x.shape[0], device=x.device)
    cache["k"].index_put_((bidx, wslot), k_new.to(cache["k"].dtype))
    cache["v"].index_put_((bidx, wslot), v_new.to(cache["v"].dtype))
    cache["pos"].index_put_((bidx, wslot),
                            positions[:, 0].to(cache["pos"].dtype))
    y = attn_attend_cache(p["mixer"], cfg, q, cache["k"], cache["v"],
                          cache["pos"], positions, window=window)
    x = x + y
    x = x + swiglu(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x, cache


def decode_step(params, cfg: ModelConfig, par: Parallel, state, token_ids,
                *, impl=None):
    """serve_step: one new token per sequence against the cache.

    token_ids: (B, 1) int32.  Returns (new_state, logits (B, V) f32);
    ``state`` itself is left as it was."""
    params = cast_params(params, cfg)
    prefix_slots, n_periods, suffix_slots = _layer_plan(cfg)
    B = token_ids.shape[0]
    positions = state["pos"].reshape(B, 1)
    h = _embed(params, cfg, token_ids)
    new = {k: pytree.tree_map(torch.clone, state[k])
           for k in ("prefix", "scan", "suffix")}

    for p_blk, slot, cache in zip(params["prefix"], prefix_slots,
                                  new["prefix"]):
        h, _ = _block_decode(p_blk, cfg, slot, par, h, positions, cache)

    for i in range(n_periods):
        stacked_p = _period(params["scan"], i)
        stacked_c = _period(new["scan"], i)       # views into the clone
        for j, slot in enumerate(cfg.pattern):
            h, _ = _block_decode(stacked_p[j], cfg, slot, par, h,
                                 positions, stacked_c[j])

    for p_blk, slot, cache in zip(params["suffix"], suffix_slots,
                                  new["suffix"]):
        h, _ = _block_decode(p_blk, cfg, slot, par, h, positions, cache)

    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    # keys in the reference's (sorted) flatten order: the tree codec
    # concatenates leaves in this order
    new_state = {"pos": state["pos"] + 1, "prefix": new["prefix"],
                 "scan": new["scan"], "suffix": new["suffix"]}
    return new_state, _logits(params, cfg, h[:, 0])


# ---------------------------------------------------------------------------
# Parallel prefill
# ---------------------------------------------------------------------------
def _fill_attn_cache(cfg: ModelConfig, slot: LayerSlot, kv, positions,
                     s_cache: int):
    """Turn prefill (k, v) of shape (B, S, Hkv, hd) into a decode cache
    ({k, v, pos} sized s_cache — or a ring of `window` for local
    layers)."""
    k, v = kv
    B, S = k.shape[0], k.shape[1]
    size = s_cache if slot.mixer != "attn_local" else min(
        s_cache, cfg.window or s_cache)
    pos = (positions if positions.dim() == 2 else positions[0]).to(
        torch.int32)
    if S <= size:
        pad = size - S
        ck = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        cv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        cp = torch.nn.functional.pad(pos, (0, pad), value=-1)
        return {"k": ck, "pos": cp, "v": cv}
    # ring scatter of the last `size` rows
    tail_k, tail_v, tail_p = k[:, -size:], v[:, -size:], pos[:, -size:]
    slots = (tail_p % size).long()                             # (B, size)
    bidx = torch.arange(B, device=k.device)[:, None].expand_as(slots)
    ck = k.new_zeros((B, size) + tuple(k.shape[2:]))
    cv = v.new_zeros((B, size) + tuple(v.shape[2:]))
    cp = torch.full((B, size), -1, dtype=torch.int32, device=k.device)
    ck[bidx, slots] = tail_k
    cv[bidx, slots] = tail_v
    cp[bidx, slots] = tail_p
    return {"k": ck, "pos": cp, "v": cv}


def _cache_to_state(cfg: ModelConfig, slot: LayerSlot, c, positions,
                    s_cache: int, stacked: bool):
    if not stacked:
        return _fill_attn_cache(cfg, slot, c, positions, s_cache)
    k, v = c                                 # (n_periods, B, S, Hkv, hd)
    return _stack([_fill_attn_cache(cfg, slot, (k[i], v[i]), positions,
                                    s_cache) for i in range(k.shape[0])])


def prefill_forward(params, cfg: ModelConfig, par: Parallel, batch,
                    s_cache: int, *, impl=None):
    """Parallel prefill: full forward through the flash kernel, returns
    (decode_state, last_logits (B, V) f32)."""
    params = cast_params(params, cfg)
    tokens = batch["tokens"]
    positions = _positions_for(cfg, batch)
    h = constrain(par, _embed(params, cfg, tokens))
    h, _, _, caches = _trunk(params, cfg, par, h, positions, impl=impl,
                             collect_caches=True)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    last = _logits(params, cfg, h[:, -1])

    prefix_slots, n_periods, suffix_slots = _layer_plan(cfg)
    state = {
        "pos": positions[:, -1].to(torch.int32) + 1,
        "prefix": tuple(
            _cache_to_state(cfg, slot, c, positions, s_cache, False)
            for slot, c in zip(prefix_slots, caches["prefix"])),
        "scan": tuple(
            _cache_to_state(cfg, slot, c, positions, s_cache, True)
            for slot, c in zip(cfg.pattern, caches["scan"]))
        if n_periods else (),
        "suffix": tuple(
            _cache_to_state(cfg, slot, c, positions, s_cache, False)
            for slot, c in zip(suffix_slots, caches["suffix"])),
    }
    return state, last


# ---------------------------------------------------------------------------
# Sequential prefill (oracle for tests; exercises decode_step exactly)
# ---------------------------------------------------------------------------
def prefill(params, cfg: ModelConfig, par: Parallel, tokens, s_cache: int,
            *, impl=None):
    """Sequential prefill through ``decode_step``, one token at a time.
    Returns (state, logits (B, S, V))."""
    params = cast_params(params, cfg)
    B, S = tokens.shape
    state = init_decode_state(cfg, B, s_cache, device=tokens.device)
    logits = []
    for t in range(S):
        state, lg = decode_step(params, cfg, par, state, tokens[:, t:t + 1],
                                impl=impl)
        logits.append(lg)
    return state, torch.stack(logits, dim=1)
