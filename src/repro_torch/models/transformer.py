"""Composable decoder LM: the port of ``repro.models.transformer`` for
``attn_global`` / ``attn_local`` / ``mla`` / ``rec`` (RG-LRU) /
``mlstm`` / ``slstm`` mixers with dense SwiGLU FFNs, MoE FFNs or none.

The parameter and decode-state pytrees keep the reference's layout —
dicts and tuples, ``prefix`` (unstacked) + ``scan`` (one stacked dict
per pattern slot, leading axis = pattern period) + ``suffix`` — so the
relocation engine ships the same ``SeqKV`` payload and the tests compare
the two packages leaf by leaf.  Decode-state dicts are built with their
keys in sorted order: ``jax.tree_util`` flattens dicts by sorted key,
``torch.utils._pytree`` by insertion order, and the row codec lays the
leaves out in flatten order.  ``jax.lax.scan`` over the stacked
periods becomes a Python loop over ``params["scan"][j][i]`` views.

Encoder-decoder configs, M-RoPE and multi-token prediction raise
``NotImplementedError`` (ROADMAP.md queue 1); MoE runs without a mesh
only (``moe_forward_dense``).  ``train_loss`` / ``lm_loss`` are the
reference's ``mesh=None`` branch: the vocab loss in ``cfg.loss_chunk``
chunks, each under non-reentrant ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint``), and ``cfg.remat`` puts each scanned
period under checkpointing (``"full"``) or saves only the outputs of
its matrix products with no batch dims (``"dots"``, a selective
checkpoint policy).  Autograd differentiates through the flash
kernel's :class:`~repro_torch.kernels.flash_attention.FlashAttention`;
the recurrent and MoE kernels have no backward yet and raise under
autograd on the card.

Two departures from a line-by-line copy, neither of which changes a
result:

* ``cast_params`` casts the f32 master parameters to the compute dtype;
  under ``jit`` the reference pays nothing for doing that on every call,
  eagerly it would re-read and re-write every weight per decode step.
  Here a tensor that already has the compute dtype is passed through
  as it is, so a caller that casts once (``DecodeEngine``) pays once.
* the reference's functional write-then-attend (``.at[].set``) is one
  clone of the incoming decode state per step, then in-place writes into
  the clone (a recurrent block's new state is copied into its slot of
  the clone): the caller's state (a ``SeqKV`` an in-flight migration
  window may be reading) is never written.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree
from torch.utils import checkpoint as ckpt

from .attention import (attn_attend_cache, attn_decode_project, attn_forward,
                        attn_init)
from .config import LayerSlot, ModelConfig
from ..core.device import default_device
from .layers import (dense_init, embed_init, rmsnorm, rmsnorm_init, swiglu,
                     swiglu_init)
from .moe import (mla_attend_cache, mla_decode_project, mla_forward,
                  mla_init, moe_forward_dense, moe_init)
from .parallel import Parallel, constrain
from .rglru import (rglru_block, rglru_block_init, rglru_block_step,
                    rglru_empty_state)
from .ssm import (mlstm_block, mlstm_block_init, mlstm_block_step,
                  mlstm_empty_state, slstm_block, slstm_block_init,
                  slstm_block_step, slstm_empty_state)

__all__ = ["init_params", "decode_step", "prefill", "prefill_forward",
           "init_decode_state", "cast_params", "lm_loss", "train_loss"]

_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}

_NEXT = "ROADMAP.md queue 1"
_ATTN = ("attn_global", "attn_local")
_MIXERS = _ATTN + ("mla", "rec", "mlstm", "slstm")


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPE[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def _check_supported(cfg: ModelConfig) -> None:
    for slot in cfg.layer_slots():
        if slot.mixer not in _MIXERS:
            raise NotImplementedError(
                f"mixer {slot.mixer!r} is not ported yet ({_NEXT})")
        if slot.ffn not in ("dense", "moe", "none"):
            raise NotImplementedError(
                f"ffn {slot.ffn!r} is not ported yet ({_NEXT})")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"encoder-decoder configs ({_NEXT})")
    if cfg.mrope_sections:
        raise NotImplementedError(f"M-RoPE positions ({_NEXT})")
    if cfg.mtp_depth:
        raise NotImplementedError(f"multi-token prediction ({_NEXT})")


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
_MIXER_INIT = {"attn_global": attn_init, "attn_local": attn_init,
               "mla": mla_init, "rec": rglru_block_init,
               "mlstm": mlstm_block_init}


def _block_init(gen, cfg: ModelConfig, slot: LayerSlot, dtype):
    p: dict[str, Any] = {}
    if slot.mixer == "slstm":
        p["mixer"] = slstm_block_init(gen, cfg, dtype)  # self-contained
    else:
        p["norm1"] = rmsnorm_init(cfg.d_model, dtype, gen.device)
        p["mixer"] = _MIXER_INIT[slot.mixer](gen, cfg, dtype)
    if slot.ffn == "dense":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, gen.device)
        p["ffn"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype)
    elif slot.ffn == "moe":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, gen.device)
        p["ffn"] = moe_init(gen, cfg, dtype)
        if cfg.n_shared_experts:
            p["shared_norm_alias"] = ()  # marker only; shared lives in ffn
    return p


def _zero_aux(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"aux": z, "z": z}


def _ffn(p, cfg: ModelConfig, slot: LayerSlot, x, *, impl=None):
    """x + the block's FFN; returns (x, aux metrics or None)."""
    if slot.ffn == "dense":
        x = x + swiglu(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps))
    elif slot.ffn == "moe":
        # without a mesh (``Parallel`` raises on one): the dense dispatch
        y, aux = moe_forward_dense(p["ffn"], cfg,
                                   rmsnorm(p["norm2"], x, cfg.norm_eps),
                                   impl=impl)
        return x + y, aux
    return x, None


def _block_forward(p, cfg: ModelConfig, slot: LayerSlot, par: Parallel, x,
                   positions, *, impl=None, causal=True):
    """Full-sequence block application. Returns (x, aux, cache_entry):
    (k, v) for attention, (c_kv, k_rope) for MLA, the final recurrent
    state otherwise."""
    if slot.mixer == "slstm":
        x, cache = slstm_block(p["mixer"], cfg, x, return_state=True)
    else:
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        if slot.mixer in _ATTN:
            window = cfg.window if slot.mixer == "attn_local" else None
            y, cache = attn_forward(p["mixer"], cfg, h, positions,
                                    causal=causal, window=window, impl=impl,
                                    par=par)
        elif slot.mixer == "mla":
            y, cache = mla_forward(p["mixer"], cfg, h, positions, impl=impl)
        elif slot.mixer == "rec":
            y, cache = rglru_block(p["mixer"], cfg, h, impl=impl,
                                   return_state=True)
        else:
            y, cache = mlstm_block(p["mixer"], cfg, h, impl=impl,
                                   return_state=True)
        x = x + y
    x, aux = _ffn(p, cfg, slot, x, impl=impl)
    return x, aux if aux is not None else _zero_aux(x.device), cache


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


def _stacked_init(gen, cfg: ModelConfig, slot: LayerSlot, dtype,
                  n_periods: int):
    """``_stack`` of ``n_periods`` block inits, drawn period by period in
    the same order, but written into the stacked leaves as they come: the
    peak is the stack plus one period, not two stacks."""
    leaves, spec = pytree.tree_flatten(_block_init(gen, cfg, slot, dtype))
    out = [torch.empty((n_periods,) + tuple(a.shape), dtype=a.dtype,
                       device=a.device) for a in leaves]
    for i in range(n_periods):
        if i:
            leaves = pytree.tree_leaves(_block_init(gen, cfg, slot, dtype))
        for o, a in zip(out, leaves):
            o[i].copy_(a)
        del leaves
    return pytree.tree_unflatten(out, spec)


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random parameters (in ``cfg.param_dtype``) on ``gen.device``.
    Every leaf is drawn in f32 and then cast, so ``param_dtype =
    cfg.dtype`` gives the values ``cast_params`` makes of the f32 draw,
    without holding the f32 masters."""
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
    p["scan"] = tuple(_stacked_init(gen, cfg, slot, dtype, n_periods)
                      for slot in cfg.pattern) if n_periods else ()
    p["suffix"] = tuple(_block_init(gen, cfg, s, dtype)
                        for s in suffix_slots)
    return p


# ---------------------------------------------------------------------------
# Forward trunk
# ---------------------------------------------------------------------------
def _positions_for(cfg: ModelConfig, batch) -> torch.Tensor:
    if cfg.mrope_sections:
        raise NotImplementedError(f"M-RoPE positions ({_NEXT})")
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
        def period_fn(stacked, h, a_s, z_s):
            cs = []
            for j, slot in enumerate(cfg.pattern):
                h, aux, c = _block_forward(stacked[j], cfg, slot, par, h,
                                           positions, impl=impl)
                a_s = a_s + aux["aux"]
                z_s = z_s + aux["z"]
                cs.append(c)
            return constrain(par, h), a_s, z_s, tuple(cs)

        remat = _remat(cfg)
        percall = []
        for i in range(n_periods):
            stacked = _period(params["scan"], i)
            if remat is None:
                h, aux_sum, z_sum, cs = period_fn(stacked, h, aux_sum,
                                                  z_sum)
            else:
                h, aux_sum, z_sum, cs = remat(period_fn, stacked, h,
                                              aux_sum, z_sum)
            if collect_caches:
                percall.append(cs)
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


# the matrix products with no batch dims: what ``remat="dots"`` saves,
# as ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig):
    """``cfg.remat`` as a wrapper ``fn, *args -> fn(*args)`` of one
    scanned period, or None for ``"none"``."""
    if cfg.remat == "none":
        return None
    if cfg.remat in ("full", "full_cse"):
        return functools.partial(ckpt.checkpoint, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            ckpt.checkpoint, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat {cfg.remat!r} not in none | full | dots")


def _head_table(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"]["table"]              # (V, d)
    return params["head"]["w"].T                      # (V, d)


def _chunk_loss(cfg: ModelConfig, table, hc, lc, mc):
    """Summed masked cross-entropy of one chunk, logits in f32."""
    logits = hc.float() @ table.float().T
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return torch.sum((lse - ll) * mc)


def lm_loss(params, cfg: ModelConfig, par: Parallel, h, labels, mask=None):
    """Chunked cross-entropy (the reference's ``mesh=None`` branch).

    h: (B, S, d); labels: (B, S) int; mask: (B, S) or None.  The vocab
    logits of each ``cfg.loss_chunk`` positions live only inside that
    chunk's checkpoint (recomputed in the backward), as under the
    reference's ``jax.checkpoint``."""
    table = _head_table(params, cfg)
    B, S, d = h.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    chunk = cfg.loss_chunk if cfg.loss_chunk else S
    n_chunks = max(S // chunk, 1)
    chunk = S // n_chunks
    if n_chunks * chunk != S:
        raise ValueError(f"sequence length {S} is not a multiple of "
                         f"{n_chunks} loss chunks")
    mask = mask.float()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + ckpt.checkpoint(
            _chunk_loss, cfg, table, h[:, sl], labels[:, sl], mask[:, sl],
            use_reentrant=False)
    return total / torch.clamp(torch.sum(mask), min=1.0)


def train_loss(params, cfg: ModelConfig, par: Parallel, batch, *,
               impl=None):
    """Next-token LM loss (+ MoE aux).  Returns (loss, metrics) with the
    reference's metric names.  ``batch``: ``tokens`` (B, S) int on the
    parameters' device, optional ``labels`` (default: the next token, 0
    last) and ``mask``."""
    _check_supported(cfg)           # encoder-decoder and MTP raise
    params = cast_params(params, cfg)
    tokens = batch["tokens"]
    labels = batch.get("labels")
    if labels is None:
        labels = F.pad(tokens[:, 1:], (0, 1))
    positions = _positions_for(cfg, batch)
    h = constrain(par, _embed(params, cfg, tokens))
    h, aux_sum, z_sum = _trunk(params, cfg, par, h, positions, impl=impl)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    loss = lm_loss(params, cfg, par, h, labels, batch.get("mask"))
    metrics = {"lm_loss": loss, "moe_aux": aux_sum, "router_z": z_sum}
    loss = loss + cfg.router_aux_weight * aux_sum \
        + cfg.router_z_weight * z_sum
    metrics["loss"] = loss
    return loss, metrics


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
_EMPTY_STATE = {"rec": rglru_empty_state, "mlstm": mlstm_empty_state,
                "slstm": slstm_empty_state}


def _slot_cache_shape(cfg: ModelConfig, slot: LayerSlot, batch: int,
                      s_cache: int, device, lead: tuple = ()):
    if slot.mixer in _EMPTY_STATE:
        return _EMPTY_STATE[slot.mixer](cfg, batch, device=device, lead=lead)
    dt = _torch_dtype(cfg.dtype)
    if slot.mixer == "mla":
        return {
            "ckv": torch.zeros(lead + (batch, s_cache, cfg.kv_lora_rank),
                               dtype=dt, device=device),
            "krope": torch.zeros(lead + (batch, s_cache, cfg.qk_rope_dim),
                                 dtype=dt, device=device),
            "pos": torch.full(lead + (batch, s_cache), -1,
                              dtype=torch.int32, device=device),
        }
    hd = cfg.resolved_head_dim
    size = s_cache if slot.mixer == "attn_global" else min(
        s_cache, cfg.window or s_cache)
    return {
        "k": torch.zeros(lead + (batch, size, cfg.n_kv_heads, hd),
                         dtype=dt, device=device),
        "pos": torch.full(lead + (batch, size), -1, dtype=torch.int32,
                          device=device),
        "v": torch.zeros(lead + (batch, size, cfg.n_kv_heads, hd),
                         dtype=dt, device=device),
    }


def init_decode_state(cfg: ModelConfig, batch: int, s_cache: int, *,
                      device=None):
    """Empty decode state (zeros; cache positions -1; stabilizers -inf)
    on ``device`` — the CUDA card unless the caller asks for another (with
    no card and no ``device`` it raises)."""
    _check_supported(cfg)
    device = default_device(device)
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


def _write(cache, new) -> None:
    """Copy a recurrent block's new state into its slot of the clone."""
    for name, t in new.items():
        cache[name].copy_(t)


def _block_decode(p, cfg: ModelConfig, slot: LayerSlot, par: Parallel, x,
                  positions, cache, *, impl=None):
    """One-token decode through a block.  ``cache`` is owned by the
    caller's fresh clone of the state: an attention block writes the new
    row into it in place, then attends (write-then-attend); a recurrent
    block's new state is copied into it.  Returns (x, cache)."""
    if slot.mixer == "slstm":
        x, new = slstm_block_step(p["mixer"], cfg, x, cache)
        _write(cache, new)
        return x, cache
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if slot.mixer in ("rec", "mlstm"):
        step = rglru_block_step if slot.mixer == "rec" else mlstm_block_step
        y, new = step(p["mixer"], cfg, h, cache)
        _write(cache, new)
        return _ffn(p, cfg, slot, x + y, impl=impl)[0], cache
    bidx = torch.arange(x.shape[0], device=x.device)
    if slot.mixer == "mla":
        q_pair, ckv_new, kr_new = mla_decode_project(p["mixer"], cfg, h,
                                                     positions)
        wslot = (positions[:, 0] % cache["ckv"].shape[1]).long()
        cache["ckv"].index_put_((bidx, wslot),
                                ckv_new.to(cache["ckv"].dtype))
        cache["krope"].index_put_((bidx, wslot),
                                  kr_new.to(cache["krope"].dtype))
        cache["pos"].index_put_((bidx, wslot),
                                positions[:, 0].to(cache["pos"].dtype))
        y = mla_attend_cache(p["mixer"], cfg, q_pair, cache["ckv"],
                             cache["krope"], cache["pos"], positions)
        return _ffn(p, cfg, slot, x + y, impl=impl)[0], cache
    window = cfg.window if slot.mixer == "attn_local" else None
    q, k_new, v_new = attn_decode_project(p["mixer"], cfg, h, positions)
    size = cache["k"].shape[1]
    wslot = (positions[:, 0] % size).long()
    cache["k"].index_put_((bidx, wslot), k_new.to(cache["k"].dtype))
    cache["v"].index_put_((bidx, wslot), v_new.to(cache["v"].dtype))
    cache["pos"].index_put_((bidx, wslot),
                            positions[:, 0].to(cache["pos"].dtype))
    y = attn_attend_cache(p["mixer"], cfg, q, cache["k"], cache["v"],
                          cache["pos"], positions, window=window)
    return _ffn(p, cfg, slot, x + y, impl=impl)[0], cache


def decode_step(params, cfg: ModelConfig, par: Parallel, state, token_ids,
                *, impl=None):
    """serve_step: one new token per sequence against the cache.

    token_ids: (B, 1) int32.  Returns (new_state, logits (B, V) f32);
    ``state`` itself is left as it was.  ``impl`` picks the MoE
    dispatch's backend (``fused`` or ``composite``)."""
    params = cast_params(params, cfg)
    prefix_slots, n_periods, suffix_slots = _layer_plan(cfg)
    B = token_ids.shape[0]
    positions = state["pos"].reshape(B, 1)
    h = _embed(params, cfg, token_ids)
    new = {k: pytree.tree_map(torch.clone, state[k])
           for k in ("prefix", "scan", "suffix")}

    for p_blk, slot, cache in zip(params["prefix"], prefix_slots,
                                  new["prefix"]):
        h, _ = _block_decode(p_blk, cfg, slot, par, h, positions, cache,
                             impl=impl)

    for i in range(n_periods):
        stacked_p = _period(params["scan"], i)
        stacked_c = _period(new["scan"], i)       # views into the clone
        for j, slot in enumerate(cfg.pattern):
            h, _ = _block_decode(stacked_p[j], cfg, slot, par, h,
                                 positions, stacked_c[j], impl=impl)

    for p_blk, slot, cache in zip(params["suffix"], suffix_slots,
                                  new["suffix"]):
        h, _ = _block_decode(p_blk, cfg, slot, par, h, positions, cache,
                             impl=impl)

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


def _fill_mla_cache(cfg: ModelConfig, kv, positions, s_cache: int):
    """Prefill (c_kv (B, S, r), k_rope (B, S, dr)) → the latent decode
    cache ({ckv, krope, pos} sized s_cache; a prompt longer than the
    cache keeps its last s_cache rows, as the reference does)."""
    ckv, krope = kv
    pos = (positions if positions.dim() == 2 else positions[0]).to(
        torch.int32)
    S = ckv.shape[1]
    if S > s_cache:
        ckv, krope, pos = (ckv[:, -s_cache:], krope[:, -s_cache:],
                           pos[:, -s_cache:])
        S = s_cache
    pad = s_cache - S
    return {"ckv": torch.nn.functional.pad(ckv, (0, 0, 0, pad)),
            "krope": torch.nn.functional.pad(krope, (0, 0, 0, pad)),
            "pos": torch.nn.functional.pad(pos, (0, pad), value=-1)}


def _cache_to_state(cfg: ModelConfig, slot: LayerSlot, c, positions,
                    s_cache: int, stacked: bool):
    if slot.mixer not in _ATTN + ("mla",):
        return c  # recurrent states pass through (already final)

    def fill(kv):
        if slot.mixer == "mla":
            return _fill_mla_cache(cfg, kv, positions, s_cache)
        return _fill_attn_cache(cfg, slot, kv, positions, s_cache)

    if not stacked:
        return fill(c)
    a, b = c                             # (n_periods, B, S, ...) each
    return _stack([fill((a[i], b[i])) for i in range(a.shape[0])])


def prefill_forward(params, cfg: ModelConfig, par: Parallel, batch,
                    s_cache: int, *, impl=None):
    """Parallel prefill: full forward through the flash, RG-LRU, mLSTM
    and MoE dispatch kernels, returns (decode_state, last_logits (B, V)
    f32)."""
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
