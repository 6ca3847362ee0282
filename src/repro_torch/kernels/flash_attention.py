"""Flash attention for Hopper: tiled online-softmax attention.

The PyTorch/CUDA port of ``repro.kernels.flash_attention``.  The kernel
is CUDA C++ (``csrc/flash_attention.cu``) behind a plain C interface,
built and loaded like the relocation codec (``kernels/cuda_build.py``).
A wrapper given CUDA tensors launches it on the current stream or
raises; given CPU tensors it computes the plain version
(:func:`repro_torch.kernels.ref.flash_ref`), the CPU parity vehicle.
Each launch adds one to ``launch_counts["flash_attention"]``.

Supports GQA (``Hq % Hkv == 0``), causal masking (top-left), a sliding
window (keys in ``(i - window, i]``), logit soft-capping and
``sm_scale``; head dims 64, 128 and 256; float32, bfloat16 and float16.
The kernel picks its path from the inputs: tensor-core tiles for
bfloat16/float16 at head dims 64 and 128 with 16-byte aligned rows, f32
FMA tiles otherwise.  Views with a unit last stride are read in place.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import ref
from .cuda_build import CudaLibrary, counted

__all__ = ["flash_attention", "KERNELS", "LIBRARY", "SOURCE",
           "attention_flops"]

#: kernel name → the TPU kernel (file:line) it replaces
KERNELS = {"flash_attention": "src/repro/kernels/flash_attention.py:34"}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128, 256)


def _bind(lib) -> None:
    P, L, F, I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                  ctypes.c_int)
    lib.flash_attention_fwd.argtypes = [P, P, P, P, I] + [L] * 15 \
        + [F, I, L, F, P]
    lib.flash_attention_fwd.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_attention.cu", "flash_attention", _bind,
                      KERNELS)
SOURCE = LIBRARY.source


def attention_flops(B: int, Hq: int, Sq: int, Skv: int, D: int, *,
                    causal: bool, window: int | None) -> int:
    """Operations of one call: two products of ``2 * D`` operations for
    every (query, key) pair the mask keeps, for every batch and head."""
    i = torch.arange(Sq, dtype=torch.int64)
    hi = torch.minimum(i + 1, torch.tensor(Skv)) if causal \
        else torch.full_like(i, Skv)
    lo = (i - window + 1).clamp(min=0) if window else torch.zeros_like(i)
    pairs = int((hi - lo).clamp(min=0).sum())
    return 4 * B * Hq * D * pairs


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, softcap: float = 0.0,
                    sm_scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with ``Hq % Hkv == 0``.
    Returns (B, Hq, Sq, D) in ``q.dtype``."""
    if q.device.type == "cpu":
        return ref.flash_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {q.device} are not "
                         "supported")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention needs 4-D q, k, v")
    B, Hq, Sq, D = (int(x) for x in q.shape)
    Bk, Hkv, Skv, Dk = (int(x) for x in k.shape)
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         "kernel takes one of float32, bfloat16, float16")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    # strided views are read in place; only the head dim must be unit
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out
    if Skv == 0 or (window is not None and window <= 0):
        return out.zero_()           # every key masked: rows give 0
    rc = LIBRARY.lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], B, Hq, Hkv, Sq, Skv, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(sm_scale), int(bool(causal)),
        int(window) if window is not None else 0, float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    counted("flash_attention")
    return out
