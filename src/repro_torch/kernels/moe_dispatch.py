"""MoE dispatch and combine for Hopper: row gather and weighted combine.

The PyTorch/CUDA port of ``repro.kernels.moe_dispatch``: ``gather_rows``
(``out[i] = x[idx[i]]``, packing token rows into expert-capacity
buffers) and ``moe_combine`` (``out[t] = sum_k w[t, k] * y[slots[t, k]]``
in f32, slot < 0 skipped: the weighted return of expert outputs to
token order).  The kernels are CUDA C++ (``csrc/moe_dispatch.cu``: a
warp per gathered row, a block per combined token, 16-byte vectors
where the rows allow it) behind a plain C interface, built and loaded
like the other kernels (``kernels/cuda_build.py``).  A wrapper given
CUDA tensors launches its kernel on the current stream or raises; given
CPU tensors it computes the plain version (:func:`repro_torch.kernels.
ref.gather_rows_ref`, :func:`~repro_torch.kernels.ref.moe_combine_ref`),
the CPU parity vehicle.  Each launch adds one to
``launch_counts["gather_rows"]`` or ``launch_counts["moe_combine"]``.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .cuda_build import CudaLibrary, counted, cuda_stream, refuse_grad

__all__ = ["gather_rows", "moe_combine", "KERNELS", "LIBRARY", "SOURCE"]

#: kernel name → the TPU kernel (file:line) it replaces
KERNELS = {"gather_rows": "src/repro/kernels/moe_dispatch.py:30",
           "moe_combine": "src/repro/kernels/moe_dispatch.py:60"}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_K = 16        # csrc/moe_dispatch.cu: kMaxK


def _bind(lib) -> None:
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.moe_gather_rows.argtypes = [P, P, P, I, L, L, P]
    lib.moe_gather_rows.restype = ctypes.c_int
    lib.moe_combine.argtypes = [P, P, P, P, I, L, I, L, P]
    lib.moe_combine.restype = ctypes.c_int


LIBRARY = CudaLibrary("moe_dispatch.cu", "moe_dispatch", _bind, KERNELS)
SOURCE = LIBRARY.source


def _check_cuda(name: str, *tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev} are not supported")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors lie on different devices")


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (N, D) of an element size of 2, 4 or 8 bytes; idx: (M,) int32
    in [0, N) (the caller's to keep in range, as for the TPU kernel).
    Returns (M, D) in ``x.dtype``."""
    if x.device.type == "cpu":
        return ref.gather_rows_ref(x, idx)
    refuse_grad("gather_rows", x)
    _check_cuda("gather_rows", x, idx)
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows needs x (N, D) and idx (M,), got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    if x.element_size() not in (2, 4, 8):
        raise ValueError(f"element size {x.element_size()} of {x.dtype}: "
                         "the kernel moves 2-, 4- or 8-byte elements")
    x, idx = x.contiguous(), idx.contiguous()
    M, D = int(idx.shape[0]), int(x.shape[1])
    out = torch.empty((M, D), dtype=x.dtype, device=x.device)
    if M == 0 or D == 0:
        return out
    if x.shape[0] == 0:
        raise ValueError("gather_rows from an empty x")
    rc = LIBRARY.lib().moe_gather_rows(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.element_size(), M,
        D, cuda_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"gather_rows launch failed: CUDA error {rc}")
    counted("gather_rows")
    return out


def moe_combine(y: torch.Tensor, slots: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """y: (S, D) float32 / bfloat16 / float16 expert outputs in slot
    order; slots: (T, K) int32, < 0 for none, else in [0, S); weights:
    (T, K) float32.  Returns (T, D) in ``y.dtype``."""
    if y.device.type == "cpu":
        return ref.moe_combine_ref(y, slots, weights)
    refuse_grad("moe_combine", y, weights)
    _check_cuda("moe_combine", y, slots, weights)
    if y.dim() != 2 or slots.dim() != 2 \
            or tuple(weights.shape) != tuple(slots.shape):
        raise ValueError(f"moe_combine needs y (S, D), slots and weights "
                         f"(T, K), got {tuple(y.shape)}, "
                         f"{tuple(slots.shape)}, {tuple(weights.shape)}")
    if y.dtype not in _DTYPE_CODE:
        raise ValueError(f"y of {y.dtype}: the kernel takes float32, "
                         "bfloat16 or float16")
    if slots.dtype != torch.int32 or weights.dtype != torch.float32:
        raise ValueError(f"slots must be int32 and weights float32, got "
                         f"{slots.dtype} and {weights.dtype}")
    Tn, K = (int(n) for n in slots.shape)
    D = int(y.shape[1])
    if Tn and not 1 <= K <= MAX_K:
        raise ValueError(f"K = {K}: the kernel takes 1 to {MAX_K} slots a "
                         "token")
    y, slots, weights = y.contiguous(), slots.contiguous(), \
        weights.contiguous()
    out = torch.empty((Tn, D), dtype=y.dtype, device=y.device)
    if Tn == 0 or D == 0:
        return out
    rc = LIBRARY.lib().moe_combine(
        y.data_ptr(), slots.data_ptr(), weights.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[y.dtype], Tn, K, D, cuda_stream(y.device))
    if rc != 0:
        raise RuntimeError(f"moe_combine launch failed: CUDA error {rc}")
    counted("moe_combine")
    return out
