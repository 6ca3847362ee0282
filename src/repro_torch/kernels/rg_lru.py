"""RG-LRU scan for Hopper (RecurrentGemma / Griffin recurrent block).

The PyTorch/CUDA port of ``repro.kernels.rg_lru``: the recurrence
``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * x_t`` over (B, S, D) with the
gated decay ``a_t`` precomputed by the layer (``models/rglru.py``).
The kernel is CUDA C++ (``csrc/rg_lru.cu``: one thread per channel,
sequential over S) behind a plain C interface, built and loaded like
the other kernels (``kernels/cuda_build.py``).  It has two routes, which
:func:`rg_lru_route` names before the launch from the dtype, shape and
alignment: ``"tma"`` (a 3-D tensor map streams tiles of x and a through
a ring in shared memory) where its copies are legal, ``"simple"``
(register double-buffering) for everything else.  Both compute the same
bits.  A wrapper given CUDA tensors launches it on the current stream
or raises; given CPU tensors it computes the plain version
(:func:`repro_torch.kernels.ref.rg_lru_ref`), the CPU parity vehicle.
Each launch adds one to ``launch_counts["rg_lru"]`` and to its route's
:data:`route_counts`.

The carried state ``h`` is the per-sequence entry that relocates with
its sequence when the serving balancer moves work between replicas.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .cuda_build import CudaLibrary, counted, cuda_stream, refuse_grad

__all__ = ["rg_lru", "rg_lru_route", "route_counts", "ROUTES", "KERNELS",
           "LIBRARY", "SOURCE"]

#: kernel name → the TPU kernel (file:line) it replaces
KERNELS = {"rg_lru": "src/repro/kernels/rg_lru.py:30"}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the routes, by their code in ``csrc/rg_lru.cu``
ROUTES = ("simple", "tma")
#: launches on the card by route, so that a run can show which it took
route_counts: dict[str, int] = dict.fromkeys(ROUTES, 0)


def _bind(lib) -> None:
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.rg_lru_fwd.argtypes = [P, P, P, P, P, I, L, L, L, I, P]
    lib.rg_lru_fwd.restype = ctypes.c_int


LIBRARY = CudaLibrary("rg_lru.cu", "rg_lru", _bind, KERNELS)
SOURCE = LIBRARY.source


def rg_lru_route(x: torch.Tensor, a: torch.Tensor) -> str:
    """The route the kernel takes for x and a (B, S, D) as they are given:
    ``"tma"`` where both are contiguous, share a dtype the kernel takes,
    start 16-byte aligned and a row of D elements is a 16-byte multiple
    (the tensor map's conditions, checked again by ``csrc/rg_lru.cu``);
    else ``"simple"``.  Reads no data, so it answers for CPU tensors too."""
    if x.dim() != 3 or x.dtype not in _DTYPE_CODE or a.dtype != x.dtype:
        return "simple"
    _, S, D = x.shape
    item = x.element_size()
    ok = (all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (x, a))
          and D * item % 16 == 0 and S < 2 ** 30 and D < 2 ** 31
          and S * D * item < 2 ** 40)
    return "tma" if ok else "simple"


def rg_lru(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None = None,
           *, route: str | None = None):
    """x, a: (B, S, D), one of float32 / bfloat16 / float16 (the same for
    both), a in (0, 1); h0: (B, D) float32 or None (zeros).  ``route``
    (CUDA tensors only) forces ``"simple"`` or ``"tma"`` instead of
    :func:`rg_lru_route`'s choice, to hold the two against each other;
    ``"tma"`` on inputs it cannot read raises.

    Returns (h_seq (B, S, D) in ``x.dtype``, h_last (B, D) float32)."""
    if x.device.type == "cpu":
        return ref.rg_lru_ref(x, a, h0)
    refuse_grad("rg_lru", x, a, h0)
    if x.device.type != "cuda":
        raise ValueError(f"rg_lru: tensors on {x.device} are not supported")
    if x.dim() != 3 or tuple(a.shape) != tuple(x.shape):
        raise ValueError(f"rg_lru needs x and a of one (B, S, D) shape, got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    if x.dtype not in _DTYPE_CODE or a.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {a.dtype}: the kernel takes "
                         "one of float32, bfloat16, float16 for both")
    B, S, D = (int(n) for n in x.shape)
    if h0 is not None and (tuple(h0.shape) != (B, D)
                           or h0.dtype != torch.float32):
        raise ValueError(f"h0 must be ({B}, {D}) float32, got "
                         f"{tuple(h0.shape)} {h0.dtype}")
    tensors = (x, a) if h0 is None else (x, a, h0)
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, a and h0 lie on different devices")
    if route is not None and route not in ROUTES:
        raise ValueError(f"route {route!r}: one of {ROUTES}")
    x, a = x.contiguous(), a.contiguous()
    h0 = h0.contiguous() if h0 is not None else None
    take = rg_lru_route(x, a)
    if route == "tma" and take != "tma":
        raise ValueError("rg_lru: these inputs cannot take the TMA route "
                         "(16-byte aligned, D * itemsize a multiple of 16)")
    take = route or take
    out = torch.empty((B, S, D), dtype=x.dtype, device=x.device)
    h_last = torch.empty((B, D), dtype=torch.float32, device=x.device)
    if B == 0 or D == 0:
        return out, h_last
    if S == 0:
        return out, (h0.clone() if h0 is not None else h_last.zero_())
    rc = LIBRARY.lib().rg_lru_fwd(
        x.data_ptr(), a.data_ptr(), h0.data_ptr() if h0 is not None else None,
        out.data_ptr(), h_last.data_ptr(), _DTYPE_CODE[x.dtype], B, S, D,
        ROUTES.index(take), cuda_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"rg_lru launch failed: CUDA error {rc}")
    counted("rg_lru")
    route_counts[take] += 1
    return out, h_last
