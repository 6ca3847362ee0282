"""Kernel entry points with backend dispatch.

The port of ``repro.kernels.ops``: attention, the RG-LRU scan, the
chunkwise mLSTM, the MoE dispatch and combine and the relocation codec.
Each op resolves to (a) the hand-written CUDA kernel
(``kernels/flash_attention.py``, ``kernels/rg_lru.py``,
``kernels/mlstm.py``, ``kernels/moe_dispatch.py``,
``kernels/reloc_codec.py``) under the ``fused``
backend, or (b) the plain PyTorch version (``kernels/ref.py``) under
``composite``.
``auto`` resolves per call to ``fused`` when the tensors lie on a CUDA
device and to ``composite`` otherwise — as the JAX ``auto`` picks Pallas on a TPU and XLA elsewhere.
Under ``fused`` a CPU tensor computes the kernel's plain version (the
CPU parity vehicle); a CUDA tensor launches the kernel or raises.

Autograd: the flash kernel has a hand-written backward
(``kernels/flash_attention.py``'s ``FlashAttention``); the other model
kernels have none yet and raise under autograd on a CUDA tensor, where
``composite`` (their plain versions) trains instead.

Select with ``repro_torch.kernels.ops.set_backend("auto"|"fused"|
"composite")`` or per call via ``impl=``; the
``REPRO_TORCH_KERNEL_BACKEND`` environment variable seeds the initial
backend.
"""
from __future__ import annotations

import os

import torch

from . import moe_dispatch as _moe
from . import ref
from . import reloc_codec as _rc
from .flash_attention import flash_attention as _flash
from .mlstm import mlstm_chunkwise as _mlstm
from .rg_lru import rg_lru as _rg_lru

__all__ = ["set_backend", "get_backend", "resolve_backend", "attention",
           "rg_lru_scan", "mlstm", "gather_rows", "moe_combine",
           "reloc_encode_pack", "reloc_pack_rows", "reloc_decode_rows"]

_VALID = ("auto", "fused", "composite")
_BACKEND = os.environ.get("REPRO_TORCH_KERNEL_BACKEND", "auto")
if _BACKEND not in _VALID:          # typo'd env var must fail loudly at
    raise ValueError(               # import, not as silent auto fallback
        f"REPRO_TORCH_KERNEL_BACKEND={_BACKEND!r} not in {_VALID}")


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


def resolve_backend(impl: str | None = None, device=None) -> str:
    """The backend a call on ``device`` would dispatch to right now
    (``auto`` resolved) — what :class:`~repro_torch.core.transport.
    DeviceTransport` consults once per window to pick the fused or
    composite codec path, and what lands in
    ``TransportStats.codec_backend``."""
    b = impl or _BACKEND
    if b not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}, got {b!r}")
    if b == "auto":
        dev = torch.device(device) if device is not None \
            else torch.device("cpu")
        b = "fused" if dev.type == "cuda" else "composite"
    return b


def attention(q, k, v, *, causal=True, window=None, softcap=0.0,
              sm_scale=None, impl: str | None = None):
    """Attention over (B, H, S, D) heads: the flash kernel under
    ``fused`` (its plain version for CPU tensors), ``flash_ref`` under
    ``composite``."""
    if resolve_backend(impl, q.device) == "composite":
        return ref.flash_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, sm_scale=sm_scale)
    return _flash(q, k, v, causal=causal, window=window, softcap=softcap,
                  sm_scale=sm_scale)


def rg_lru_scan(x, a, h0=None, *, impl: str | None = None):
    """RG-LRU scan over (B, S, D): the kernel under ``fused`` (its plain
    version for CPU tensors), ``rg_lru_ref`` under ``composite``.
    Returns (h_seq in ``x.dtype``, h_last f32)."""
    if resolve_backend(impl, x.device) == "composite":
        return ref.rg_lru_ref(x, a, h0)
    return _rg_lru(x, a, h0)


def mlstm(q, k, v, i_gate, f_gate, *, impl: str | None = None,
          return_state: bool = False):
    """mLSTM over (BH, S, d): the chunkwise kernel under ``fused`` (its
    plain version for CPU tensors), the sequential ``mlstm_ref`` under
    ``composite``.  Returns h [, (C, n, m)]."""
    if resolve_backend(impl, q.device) == "composite":
        h, state = ref.mlstm_ref(q, k, v, i_gate, f_gate)
    else:
        h, state = _mlstm(q, k, v, i_gate, f_gate)
    return (h, state) if return_state else h


def gather_rows(x, idx, *, impl: str | None = None):
    """``out[i] = x[idx[i]]`` over (N, D) rows, idx (M,) int32 in [0, N):
    the kernel under ``fused`` (its plain version for CPU tensors),
    ``gather_rows_ref`` under ``composite``."""
    if resolve_backend(impl, x.device) == "composite":
        return ref.gather_rows_ref(x, idx)
    return _moe.gather_rows(x, idx)


def moe_combine(y, slots, weights, *, impl: str | None = None):
    """``out[t] = sum_k weights[t, k] * y[slots[t, k]]`` (slot < 0
    skipped; f32 accumulation, ``y.dtype`` out): the kernel under
    ``fused`` (its plain version for CPU tensors), ``moe_combine_ref``
    under ``composite``."""
    if resolve_backend(impl, y.device) == "composite":
        return ref.moe_combine_ref(y, slots, weights)
    return _moe.moe_combine(y, slots, weights)


def reloc_encode_pack(mat, idx, widths, *, pairs, slots, width,
                      impl: str | None = None):
    """Fused encode+pack: collection chunk rows → all_to_all buffer
    (byte view, destination permutation, padding in one kernel)."""
    mat = torch.as_tensor(mat)
    if resolve_backend(impl, mat.device) == "composite":
        return ref.reloc_encode_pack_ref(mat, idx, widths, pairs=pairs,
                                         slots=slots, width=width)
    return _rc.encode_pack(mat, idx, widths, pairs=pairs, slots=slots,
                           width=width)


def reloc_pack_rows(flat_src, offsets, widths, *, pairs, slots, width,
                    impl: str | None = None):
    """Pack pre-encoded ragged byte rows into the all_to_all buffer."""
    flat_src = torch.as_tensor(flat_src)
    if resolve_backend(impl, flat_src.device) == "composite":
        return ref.reloc_pack_rows_ref(flat_src, offsets, widths,
                                       pairs=pairs, slots=slots,
                                       width=width)
    return _rc.pack_rows(flat_src, offsets, widths, pairs=pairs,
                         slots=slots, width=width)


def reloc_decode_rows(rows, *, nbytes, dtype, impl: str | None = None):
    """Fused unpack+decode: delivered wire rows → typed chunk rows
    (class padding trimmed, manifest dtype applied)."""
    rows = torch.as_tensor(rows)
    if resolve_backend(impl, rows.device) == "composite":
        return ref.reloc_decode_rows_ref(rows, nbytes=nbytes, dtype=dtype)
    return _rc.decode_rows(rows, nbytes=nbytes, dtype=dtype)
