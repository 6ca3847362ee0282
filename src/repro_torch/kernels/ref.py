"""Plain PyTorch versions of the port's kernels.

The port of ``repro.kernels.ref``: ``attention_ref`` and ``flash_ref``
(what ``csrc/flash_attention.cu`` computes, up to the order of f32
sums) and the relocation codec's ``reloc_*_ref`` (what
``csrc/reloc_codec.cu`` computes, bit for bit), with ordinary tensor
ops.  The CPU tests hold the port against
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

__all__ = ["attention_ref", "flash_ref", "reloc_encode_pack_ref",
           "reloc_pack_rows_ref", "reloc_decode_rows_ref"]


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
              sm_scale=None, block_q=128):
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
    and sums, output in ``q.dtype``."""
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
    return out


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
