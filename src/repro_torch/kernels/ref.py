"""Plain PyTorch versions of the port's kernels.

The port of ``repro.kernels.ref``: ``attention_ref`` and ``flash_ref``
(what ``csrc/flash_attention.cu`` computes, up to the order of f32
sums) and ``flash_bwd_ref``, its gradient (what
``csrc/flash_attention_bwd.cu`` computes), the recurrences ``rg_lru_ref`` and ``mlstm_ref`` (what
``csrc/rg_lru.cu`` and ``csrc/mlstm.cu`` compute, step by step where the
kernels fuse or chunk), the MoE dispatch's ``gather_rows_ref`` and
``moe_combine_ref`` (what ``csrc/moe_dispatch.cu`` computes: the gather
bit for bit, the combine up to the order of its f32 sum) and the
relocation codec's ``reloc_*_ref`` (what ``csrc/reloc_codec.cu``
computes, bit for bit), with ordinary tensor ops.  The CPU tests hold the port against
the JAX oracles through these, and ``chip_smoke.py`` holds each kernel
against them on the card.  Nothing on the card's main path calls them:
the kernel wrappers take them only for tensors that lie on the CPU.

The gathers walk the slot table in steps of about 128 MiB of index
temporaries, so the main path's ~67 M-slot send buffers fit beside the
kernel's own output on one card.
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "flash_ref", "flash_bwd_ref", "rg_lru_ref",
           "mlstm_ref", "gather_rows_ref", "moe_combine_ref",
           "reloc_encode_pack_ref", "reloc_pack_rows_ref",
           "reloc_decode_rows_ref"]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _mask(rows, cols, *, causal, window, kv_len=None):
    """Keep-mask of (query row, key column) pairs: top-left causal
    (``cols <= rows``), a window keeping keys in ``(i - window, i]``."""
    keep = torch.ones(rows.shape[0], cols.shape[1], dtype=torch.bool,
                      device=rows.device)
    if kv_len is not None:
        keep &= cols < kv_len
    if causal:
        keep &= cols <= rows
    if window is not None:
        keep &= cols > rows - window
    return keep


def attention_ref(q, k, v, *, causal=True, window=None, softcap=0.0,
                  sm_scale=None):
    """Dense softmax attention with GQA / causal / window / softcap;
    a fully masked row gives 0."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    group = Hq // Hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Skv, device=q.device)[None, :]
    keep = _mask(rows, cols, causal=causal, window=window)
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)            # fully masked rows → 0
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def flash_ref(q, k, v, *, causal=True, window=None, softcap=0.0,
              sm_scale=None, block_q=128, return_lse=False):
    """Blocked attention in plain PyTorch — the ``composite`` path of
    ``ops.attention`` and the plain version of the flash kernel.

    Never materializes the full Sq x Skv scores: a loop over q-blocks
    computes (block_q x k_span) scores, where k_span is the whole kv
    length for global attention but only ``window + block_q`` keys for
    a causal sliding window.  (The JAX package's ``flash_ref`` takes the
    short span for a non-causal window too, where keys past the block
    stay in the mask; here that case spans every key, as its kernels
    and ``attention_ref`` do.)  GQA heads are grouped against their kv head (no
    repeat of K and V).  Numerics match ``attention_ref``: f32 scores
    and sums, output in ``q.dtype``.  ``return_lse`` also returns each
    row's log-sum-exp of its kept scores, (B, Hq, Sq) f32, ``-inf``
    for a row that keeps no key (what the kernel hands its backward)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    group = Hq // Hkv
    block_q = max(1, min(block_q, Sq))
    use_window = causal and window is not None and window + block_q < Skv
    k_span = (window + block_q) if use_window else Skv
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    for q0 in range(0, Sq, block_q):
        q1 = min(Sq, q0 + block_q)
        if use_window:
            col0 = min(max(q0 + block_q - k_span, 0), Skv - k_span)
        else:
            col0 = 0
        kk = kf[:, :, col0:col0 + k_span]
        vv = vf[:, :, col0:col0 + k_span]
        qb = q[:, :, q0:q1].float().reshape(B, Hkv, group, q1 - q0, D)
        s = torch.einsum("bkgqd,bksd->bkgqs", qb, kk) * sm_scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        cols = col0 + torch.arange(kk.shape[2], device=q.device)[None, :]
        keep = _mask(rows, cols, causal=causal, window=window, kv_len=Skv)
        s = s.masked_fill(~keep, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m).masked_fill(~keep, 0.0)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkgqs,bksd->bkgqd", p, vv) / l.clamp_min(1e-20)
        out[:, :, q0:q1] = o.reshape(B, Hq, q1 - q0, D).to(q.dtype)
        if return_lse:
            lse[:, :, q0:q1] = (m + torch.log(l)).reshape(B, Hq, q1 - q0)
    return (out, lse) if return_lse else out


def flash_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=None,
                  softcap=0.0, sm_scale=None, block_q=128):
    """The plain backward of :func:`flash_ref` (what
    ``csrc/flash_attention_bwd.cu`` computes, up to the order of f32
    sums), FlashAttention-2's gradient from the forward's output ``o``
    and row log-sum-exp ``lse`` (``flash_ref(..., return_lse=True)``):

      P = exp(x - lse) on kept pairs, D = rowsum(do * o),
      dx = P (do v^T - D), ds = sm_scale dx (1 - (x / softcap)^2),
      dq = ds k, dk = ds^T q, dv = P^T do

    in f32, blocked over q like ``flash_ref``.  A row with no kept key
    (``lse`` = -inf) gives zero gradient; dk and dv of a kv head sum over
    the q-heads of its group.  Returns (dq, dk, dv) in the input
    dtypes."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    group = Hq // Hkv
    block_q = max(1, min(block_q, Sq))
    kf, vf = k.float(), v.float()
    delta = (do.float() * o.float()).sum(-1)                 # (B, Hq, Sq)
    dq = torch.empty((B, Hq, Sq, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Hkv, Skv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    cols = torch.arange(Skv, device=q.device)[None, :]
    for q0 in range(0, Sq, block_q):
        q1 = min(Sq, q0 + block_q)
        n = q1 - q0
        qb = q[:, :, q0:q1].float().reshape(B, Hkv, group, n, D)
        dob = do[:, :, q0:q1].float().reshape(B, Hkv, group, n, D)
        lb = lse[:, :, q0:q1].reshape(B, Hkv, group, n, 1)
        db = delta[:, :, q0:q1].reshape(B, Hkv, group, n, 1)
        x = torch.einsum("bkgqd,bksd->bkgqs", qb, kf) * sm_scale
        if softcap > 0.0:
            t = torch.tanh(x / softcap)
            x = softcap * t
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        live = torch.isfinite(lb)
        keep = _mask(rows, cols, causal=causal, window=window) & live
        p = torch.exp(x - torch.where(live, lb, torch.zeros_like(lb)))
        p = torch.where(keep, p, torch.zeros_like(p))
        dp = torch.einsum("bkgqd,bksd->bkgqs", dob, vf)
        ds = p * (dp - db) * sm_scale
        if softcap > 0.0:
            ds = ds * (1.0 - t * t)
        dq[:, :, q0:q1] = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) \
            .reshape(B, Hq, n, D)
        dk += torch.einsum("bkgqs,bkgqd->bksd", ds, qb)
        dv += torch.einsum("bkgqs,bkgqd->bksd", p, dob)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# recurrences (rg_lru.cu, mlstm.cu)
# ---------------------------------------------------------------------------
def rg_lru_ref(x, a, h0=None):
    """RG-LRU recurrence: ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * x_t``,
    one step at a time in f32.

    x, a: (B, S, D); a in (0, 1); h0: (B, D) f32 or None (zeros).
    Returns (h_seq (B, S, D) in ``x.dtype``, h_last (B, D) f32)."""
    B, S, D = x.shape
    h = torch.zeros((B, D), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    af = a.float()
    gx = torch.sqrt(torch.clamp(1.0 - af ** 2, 0.0, 1.0)) * x.float()
    hs = torch.empty((B, S, D), dtype=torch.float32, device=x.device)
    for t in range(S):
        h = af[:, t] * h + gx[:, t]
        hs[:, t] = h
    return hs.to(x.dtype), h


def mlstm_ref(q, k, v, i_gate, f_gate, c0=None, n0=None, m0=None, *,
              scale=None):
    """Stabilized mLSTM recurrence (xLSTM eqs.), one step at a time:

      m_t = max(log σ(f_t) + m_{t-1}, i_t)
      C_t = exp(log σ(f_t) + m_{t-1} - m_t) C_{t-1} + exp(i_t - m_t) k_t v_tᵀ
      n_t = (same decays) n_{t-1} + exp(i_t - m_t) k_t
      h_t = (C_tᵀ q_t) / max(|n_t · q_t|, 1)

    q, k, v: (B, S, d), scaled here in f32 by ``1/sqrt(d)`` or, given,
    by ``scale`` (``scale=1.0`` takes q and k as already scaled); i_gate,
    f_gate: (B, S) pre-activations.  Returns (h (B, S, d) in ``q.dtype``,
    (C (B, d, d), n (B, d), m (B,)) in f32)."""
    B, S, d = q.shape
    dev = q.device
    if scale is None:
        qf = q.float() / math.sqrt(d)
        kf = k.float() / math.sqrt(d)
    else:
        qf = q.float() * scale
        kf = k.float() * scale
    vf = v.float()
    ig = i_gate.float()
    fg = f_gate.float()
    C = torch.zeros((B, d, d), dtype=torch.float32, device=dev) \
        if c0 is None else c0.float()
    n = torch.zeros((B, d), dtype=torch.float32, device=dev) \
        if n0 is None else n0.float()
    m = torch.full((B,), float("-inf"), dtype=torch.float32, device=dev) \
        if m0 is None else m0.float()
    hs = torch.empty((B, S, d), dtype=torch.float32, device=dev)
    for t in range(S):
        qt, kt, vt, it = qf[:, t], kf[:, t], vf[:, t], ig[:, t]
        logf = torch.nn.functional.logsigmoid(fg[:, t])
        m_new = torch.maximum(logf + m, it)
        fdec = torch.exp(logf + m - m_new)
        iamp = torch.exp(it - m_new)
        C = fdec[:, None, None] * C + iamp[:, None, None] * (
            kt[:, :, None] * vt[:, None, :])
        n = fdec[:, None] * n + iamp[:, None] * kt
        denom = torch.clamp(torch.abs(torch.sum(n * qt, dim=-1)), min=1.0)
        hs[:, t] = torch.einsum("bkv,bk->bv", C, qt) / denom[:, None]
        m = m_new
    return hs.to(q.dtype), (C, n, m)


# ---------------------------------------------------------------------------
# MoE dispatch (moe_dispatch.cu)
# ---------------------------------------------------------------------------
def gather_rows_ref(x, idx):
    """``out[i] = x[idx[i]]`` (the MoE dispatch); ``idx`` in [0, N),
    checked here."""
    idx = idx.long()
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= x.shape[0]):
        raise IndexError(f"gather_rows: indices outside [0, {x.shape[0]})")
    return x[idx]


def moe_combine_ref(y, slots, weights):
    """``out[t] = sum_k weights[t, k] * y[slots[t, k]]`` in f32, a slot
    < 0 contributing 0; the result in ``y.dtype``."""
    ok = slots >= 0
    gathered = y[torch.where(ok, slots, torch.zeros_like(slots)).long()]
    w = torch.where(ok, weights, torch.zeros_like(weights))
    return torch.einsum("tk,tkd->td", w.float(),
                        gathered.float()).to(y.dtype)


# ---------------------------------------------------------------------------
# relocation codec
# ---------------------------------------------------------------------------

# bytes of int64 position temporaries per gather step
_STEP_BYTES = 1 << 27


def _step(width: int) -> int:
    return max(1, _STEP_BYTES // (8 * max(int(width), 1)))


def _u8_rows(mat: torch.Tensor) -> torch.Tensor:
    """(m, k) rows of any dtype → (m, k*itemsize) uint8 wire rows."""
    m = int(mat.shape[0])
    return mat.contiguous().reshape(m, -1).view(torch.uint8).reshape(m, -1)


def reloc_encode_pack_ref(mat, idx, widths, *, pairs: int, slots: int,
                          width: int) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.reloc_codec.encode_pack`:
    slot ``s`` ← row ``clamp(idx[s], 0, m-1)`` as bytes, zero from byte
    ``min(widths[s], nb)`` on."""
    mat = torch.as_tensor(mat)
    dev = mat.device
    if mat.dim() != 2 or mat.shape[0] == 0:
        raise ValueError(f"encode_pack needs a non-empty (m, k) matrix, "
                         f"got {tuple(mat.shape)}")
    u8 = _u8_rows(mat)
    m, nb = int(u8.shape[0]), int(u8.shape[1])
    if width < nb:
        raise ValueError(f"slot width {width} < row bytes {nb}")
    if width > nb:
        padded = u8.new_zeros((m, width))
        padded[:, :nb] = u8
        u8 = padded
    idx = torch.as_tensor(idx).to(dev, torch.int64).clamp(0, m - 1)
    wid = torch.as_tensor(widths).to(dev, torch.int64)
    n = pairs * slots
    out = torch.empty((n, width), dtype=torch.uint8, device=dev)
    span = torch.arange(width, device=dev)
    step = _step(width)
    for s0 in range(0, n, step):
        s1 = min(n, s0 + step)
        rows = u8[idx[s0:s1]]
        out[s0:s1] = rows.masked_fill_(span[None, :] >= wid[s0:s1, None], 0)
    return out.reshape(pairs, slots, width)


def reloc_pack_rows_ref(flat_src, offsets, widths, *, pairs: int,
                        slots: int, width: int) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.reloc_codec.pack_rows`:
    slot ``s`` ← ``arena[clamp(off[s] + j, 0, A-1)]`` for ``j <
    widths[s]``, zero past it."""
    arena = torch.as_tensor(flat_src)
    if arena.dtype != torch.uint8 or arena.dim() != 1:
        raise ValueError("pack_rows needs a 1-D uint8 arena")
    dev = arena.device
    last = int(arena.shape[0]) - 1
    off = torch.as_tensor(offsets).to(dev, torch.int64)
    wid = torch.as_tensor(widths).to(dev, torch.int64)
    n = pairs * slots
    out = torch.empty((n, width), dtype=torch.uint8, device=dev)
    span = torch.arange(width, device=dev)
    step = _step(width)
    for s0 in range(0, n, step):
        s1 = min(n, s0 + step)
        pos = (off[s0:s1, None] + span[None, :]).clamp_(0, last)
        rows = arena[pos]
        out[s0:s1] = rows.masked_fill_(span[None, :] >= wid[s0:s1, None], 0)
    return out.reshape(pairs, slots, width)


def reloc_decode_rows_ref(rows, *, nbytes: int, dtype) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.reloc_codec.decode_rows`:
    the first ``nbytes`` of each row, bitcast to ``dtype``, in a fresh
    tensor."""
    rows = torch.as_tensor(rows)
    m = int(rows.shape[0])
    isz = dtype.itemsize
    if nbytes % isz:
        raise ValueError(f"{nbytes} bytes is not a whole number of "
                         f"{dtype} elements")
    u8 = rows[:, :nbytes].to(torch.uint8).clone(
        memory_format=torch.contiguous_format)
    return u8.view(dtype).reshape(m, nbytes // isz)
