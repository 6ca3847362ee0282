"""MoE dispatch and combine for Hopper: row gather and weighted combine.

The PyTorch/CUDA port of ``repro.kernels.moe_dispatch``: ``gather_rows``
(``out[i] = x[idx[i]]``, packing token rows into expert-capacity
buffers) and ``moe_combine`` (``out[t] = sum_k w[t, k] * y[slots[t, k]]``
in f32, slot < 0 skipped: the weighted return of expert outputs to
token order).  The kernels are CUDA C++ (``csrc/moe_dispatch.cu``: a
warp per gathered row, 16-byte vectors where the rows allow it) behind
a plain C interface, built and loaded like the other kernels
(``kernels/cuda_build.py``).  The combine has three routes, which
:func:`combine_route` names before the launch from the dtype, shape and
alignment: ``"bulk"`` (a producer warp copies each token's rows into a
ring in shared memory with ``cp.async.bulk``; many tokens) and
``"registers"`` (each thread loads all K rows of its columns at once; a
decode batch) where 16-byte copies are legal, ``"simple"`` (a block per
token) for everything else.  All three compute the same bits.  A
wrapper given CUDA tensors launches its kernel on the current stream or
raises; given CPU tensors it computes the plain version
(:func:`repro_torch.kernels.ref.gather_rows_ref`,
:func:`~repro_torch.kernels.ref.moe_combine_ref`), the CPU parity
vehicle.  Each launch adds one to ``launch_counts["gather_rows"]`` or
``launch_counts["moe_combine"]``, and a combine to its route's
:data:`combine_route_counts`.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .cuda_build import CudaLibrary, counted, cuda_stream, refuse_grad

__all__ = ["gather_rows", "moe_combine", "combine_route",
           "combine_route_counts", "COMBINE_ROUTES", "RING_MIN_TOKENS",
           "KERNELS", "LIBRARY", "SOURCE"]

#: kernel name → the TPU kernel (file:line) it replaces
KERNELS = {"gather_rows": "src/repro/kernels/moe_dispatch.py:30",
           "moe_combine": "src/repro/kernels/moe_dispatch.py:60"}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_K = 16        # csrc/moe_dispatch.cu: kMaxK
#: the combine's routes, by their code in ``csrc/moe_dispatch.cu``
COMBINE_ROUTES = ("simple", "bulk", "registers")
#: combines launched on the card by route, so that a run can show which
#: it took
combine_route_counts: dict[str, int] = dict.fromkeys(COMBINE_ROUTES, 0)
#: fewer tokens take the register route: the bulk route runs 2 blocks an
#: SM (264 on an H100), so with fewer tokens each block holds one token
#: at a time and its ring has nothing to overlap, while the register
#: route's loads skip the mbarrier hand-off (deepseek-v2-lite's decode
#: batch of 4 tokens: 2.8 us of device time against 3.0 on an H100)
RING_MIN_TOKENS = 264


def _bind(lib) -> None:
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.moe_gather_rows.argtypes = [P, P, P, I, L, L, P]
    lib.moe_gather_rows.restype = ctypes.c_int
    lib.moe_combine.argtypes = [P, P, P, P, I, L, I, L, I, P]
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


def combine_route(y: torch.Tensor, slots: torch.Tensor) -> str:
    """The route the combine takes for expert outputs ``y`` (S, D) and
    ``slots`` (T, K): where y is contiguous in a dtype the kernel takes,
    starts 16-byte aligned and a row of D elements is a 16-byte multiple
    (the conditions of 16-byte copies, checked again by
    ``csrc/moe_dispatch.cu``), ``"bulk"`` for at least
    :data:`RING_MIN_TOKENS` tokens and ``"registers"`` for fewer; else
    ``"simple"``.  Reads no data, so it answers for CPU tensors too."""
    if y.dim() != 2 or slots.dim() != 2 or y.dtype not in _DTYPE_CODE:
        return "simple"
    if not (y.is_contiguous() and y.data_ptr() % 16 == 0
            and y.shape[1] * y.element_size() % 16 == 0):
        return "simple"
    return "bulk" if slots.shape[0] >= RING_MIN_TOKENS else "registers"


def moe_combine(y: torch.Tensor, slots: torch.Tensor,
                weights: torch.Tensor, *,
                route: str | None = None) -> torch.Tensor:
    """y: (S, D) float32 / bfloat16 / float16 expert outputs in slot
    order; slots: (T, K) int32, < 0 for none, else in [0, S); weights:
    (T, K) float32.  ``route`` (CUDA tensors only) forces one of
    :data:`COMBINE_ROUTES` instead of :func:`combine_route`'s choice, to
    hold them against each other; a chunked route on inputs it cannot
    read raises.  Returns (T, D) in ``y.dtype``."""
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
    if route is not None and route not in COMBINE_ROUTES:
        raise ValueError(f"route {route!r}: one of {COMBINE_ROUTES}")
    y, slots, weights = y.contiguous(), slots.contiguous(), \
        weights.contiguous()
    out = torch.empty((Tn, D), dtype=y.dtype, device=y.device)
    if Tn == 0 or D == 0:
        return out
    take = combine_route(y, slots)
    if route not in (None, "simple") and take == "simple":
        raise ValueError(f"moe_combine: these inputs cannot take the "
                         f"{route} route (16-byte aligned rows whose bytes "
                         "are a multiple of 16)")
    take = route or take
    rc = LIBRARY.lib().moe_combine(
        y.data_ptr(), slots.data_ptr(), weights.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[y.dtype], Tn, K, D, COMBINE_ROUTES.index(take),
        cuda_stream(y.device))
    if rc != 0:
        raise RuntimeError(f"moe_combine launch failed: CUDA error {rc}")
    counted("moe_combine")
    combine_route_counts[take] += 1
    return out
