"""Flash attention for Hopper: tiled online-softmax attention.

The PyTorch/CUDA port of ``repro.kernels.flash_attention`` (the Pallas
kernel at ``src/repro/kernels/flash_attention.py:34``).  The kernel is
CUDA C++ (``csrc/flash_attention.cu``) behind a plain C interface,
built and loaded like the relocation codec (``kernels/cuda_build.py``).
A wrapper given CUDA tensors launches it on the current stream or
raises; given CPU tensors it computes the plain version
(:func:`repro_torch.kernels.ref.flash_ref`), the CPU parity vehicle.
Each launch adds one to ``launch_counts["flash_attention"]``.

Its gradient is :class:`FlashAttention`: the forward kernel also writes
each row's log-sum-exp, and the backward is hand-written too
(``csrc/flash_attention_bwd.cu``, head dims 64 and 128; its plain
version :func:`repro_torch.kernels.ref.flash_bwd_ref`), counted as
``flash_attention_bwd``.  It has two routes, which the library picks
before the launch (``flash_bwd_scratch_floats`` names the route and the
scratch the wrapper allocates; :data:`bwd_route_counts` counts the
calls of each): bfloat16/float16 views at head dim 64 or 128 whose row
starts and strides are 16-byte multiples take the tensor-core kernels (TMA +
``wgmma``, P and dS split into ``hi + lo``, dK/dV per q-head with the
group summed in a fixed order); float32 and unaligned views take
FlashAttention-2's kernels on f32 FMA tiles.

Supports GQA (``Hq % Hkv == 0``), causal masking (top-left), a sliding
window (keys ``j > i - window``, for any integer window: one <= 0 keeps
only keys after the row, or none), logit soft-capping and
``sm_scale``; head dims 64, 128, 192 (MLA's 128 + 64 query/key head)
and 256; float32, bfloat16 and float16.  Views with a unit last stride
are read in place.  The kernel picks its path from dtype, head dim and
alignment before the launch: bfloat16/float16 whose row starts and
strides are 16-byte multiples (the models' transposed ``(B, S, H, D)``
views included) run the TMA + ``wgmma`` kernel, warp-specialized with
a producer warpgroup and two consumer warpgroups of 64 query rows;
float32 and unaligned views run f32 FMA tiles.  A refused launch or a
tensor map that fails to encode raises: nothing falls back.

Bound on an H100: :func:`attention_flops` at 989 TFLOP/s (bf16/f16).
The tensor-core path splits P into an input-type ``hi + lo`` so that
P V keeps ~16 bits of P, as the reference's f32 product does; that
third product makes its floor 1.5x the bound.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import ref
from .cuda_build import CudaLibrary, counted, cuda_stream

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "FlashAttention", "bwd_route_counts",
           "KERNELS", "LIBRARY", "BWD_LIBRARY", "SOURCE", "BWD_SOURCE",
           "attention_flops"]

#: kernel name → the TPU kernel (file:line) it replaces; the backward
#: replaces the gradient ``jax.grad`` takes of that kernel's attention
KERNELS = {"flash_attention": "src/repro/kernels/flash_attention.py:34",
           "flash_attention_bwd": "src/repro/kernels/flash_attention.py:34"}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128, 192, 256)
_BWD_HEAD_DIMS = (64, 128)
#: backward calls on the card by route ("tensor_core" or "fma"), so that
#: a run can show which kernels its main path took
bwd_route_counts: dict[str, int] = {"tensor_core": 0, "fma": 0}


def _bind(lib) -> None:
    P, L, F, I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                  ctypes.c_int)
    lib.flash_attention_fwd.argtypes = [P, P, P, P, P, I] + [L] * 15 \
        + [F, I, L, F, P]
    lib.flash_attention_fwd.restype = ctypes.c_int


def _bind_bwd(lib) -> None:
    P, L, F, I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                  ctypes.c_int)
    lib.flash_attention_bwd.argtypes = [P] * 10 + [I] + [L] * 6 \
        + [P, F, I, L, F, P]
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_bwd_scratch_floats.argtypes = [P, P, I] + [L] * 6 + [P]
    lib.flash_bwd_scratch_floats.restype = L


LIBRARY = CudaLibrary("flash_attention.cu", "flash_attention", _bind,
                      {"flash_attention": KERNELS["flash_attention"]})
BWD_LIBRARY = CudaLibrary(
    "flash_attention_bwd.cu", "flash_attention_bwd", _bind_bwd,
    {"flash_attention_bwd": KERNELS["flash_attention_bwd"]})
SOURCE = LIBRARY.source
BWD_SOURCE = BWD_LIBRARY.source


def attention_flops(B: int, Hq: int, Sq: int, Skv: int, D: int, *,
                    causal: bool, window: int | None) -> int:
    """Operations of one call: two products of ``2 * D`` operations for
    every (query, key) pair the mask keeps, for every batch and head."""
    i = torch.arange(Sq, dtype=torch.int64)
    hi = torch.minimum(i + 1, torch.tensor(Skv)) if causal \
        else torch.full_like(i, Skv)
    lo = (i - window + 1).clamp(min=0) if window is not None \
        else torch.zeros_like(i)
    pairs = int((hi - lo).clamp(min=0).sum())
    return 4 * B * Hq * D * pairs


def _window(window, Sq: int, Skv: int) -> int:
    """keys j > i - window for every integer window; i - j < Sq, so no
    window is the window Sq, and a window <= -Skv keeps no key"""
    return Sq if window is None else max(min(int(window), Sq), -Skv)


def _check(q, k, v, head_dims):
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
    if D not in head_dims:
        raise ValueError(f"head dim {D} not in {head_dims}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         "kernel takes one of float32, bfloat16, float16")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")
    return B, Hq, Hkv, Sq, Skv, D


def _unit_last(*ts):
    # strided views are read in place; only the head dim must be unit
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in ts)


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: int | None = None, softcap: float = 0.0,
                        sm_scale: float | None = None,
                        with_lse: bool = False):
    """The forward kernel outside autograd: ``(out, lse)``, ``lse`` the
    (B, Hq, Sq) f32 row log-sum-exp when ``with_lse`` (else None).  On
    CPU tensors ``flash_ref``."""
    if q.device.type == "cpu":
        if with_lse:
            return ref.flash_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, sm_scale=sm_scale,
                                 return_lse=True)
        return ref.flash_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, sm_scale=sm_scale), None
    B, Hq, Hkv, Sq, Skv, D = _check(q, k, v, _HEAD_DIMS)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    q, k, v = _unit_last(q, k, v)
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if B == 0 or Sq == 0:
        return out, lse
    if Skv == 0:                     # no key: rows give 0
        return out.zero_(), None if lse is None else lse.fill_(-math.inf)
    rc = LIBRARY.lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        _DTYPE_CODE[q.dtype], B, Hq, Hkv, Sq, Skv, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(sm_scale), int(bool(causal)),
        _window(window, Sq, Skv), float(softcap or 0.0),
        cuda_stream(q.device))
    if rc < 0:
        raise RuntimeError("flash_attention: a TMA tensor map failed to "
                           f"encode (CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    counted("flash_attention")
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int | None = None, softcap: float = 0.0,
                        sm_scale: float | None = None):
    """(dq, dk, dv) of :func:`flash_attention` from its output ``out``
    and row log-sum-exp ``lse`` (B, Hq, Sq) f32, for the upstream
    gradient ``dout``: the backward kernels
    (``csrc/flash_attention_bwd.cu``) on CUDA tensors, on the current
    stream, or :func:`~repro_torch.kernels.ref.flash_bwd_ref` on CPU
    tensors.  Head dims 64 and 128; float32, bfloat16, float16.  Every
    (B, H, S, D) view with a unit last stride (the models' transposed
    (B, S, H, D) views included) is read in place through its strides;
    the gradients are laid out like q, k and v where those are dense,
    else contiguous.  The library names the route and its scratch, which
    is allocated here.  A refused launch or a tensor map that fails to
    encode raises.  Each call adds one to
    ``launch_counts["flash_attention_bwd"]`` and to its route's
    :data:`bwd_route_counts`."""
    if q.device.type == "cpu":
        return ref.flash_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                 window=window, softcap=softcap,
                                 sm_scale=sm_scale)
    if q.dim() == 4 and int(q.shape[-1]) in _HEAD_DIMS \
            and int(q.shape[-1]) not in _BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {int(q.shape[-1])} "
                         "has no backward kernel yet (ROADMAP.md queue 1, "
                         "the training slices)")
    B, Hq, Hkv, Sq, Skv, D = _check(q, k, v, _BWD_HEAD_DIMS)
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != \
            tuple(q.shape) or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} must match q")
    if tuple(lse.shape) != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {Hq}, {Sq}) float32")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    q, k, v, out, dout = _unit_last(q, k, v, out, dout)
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if B == 0 or Sq == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    views = (q, k, v, out, dout, dq, dk, dv)
    ptrs = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in views))
    strides = (ctypes.c_longlong * 24)(*(
        s for t in views for s in t.stride()[:3]))
    lib = BWD_LIBRARY.lib()
    tc = ctypes.c_int()
    scratch = torch.empty(lib.flash_bwd_scratch_floats(
        ctypes.cast(ptrs, ctypes.c_void_p),
        ctypes.cast(strides, ctypes.c_void_p), _DTYPE_CODE[q.dtype],
        B, Hq, Hkv, Sq, Skv, D, ctypes.byref(tc)),
        dtype=torch.float32, device=q.device)
    rc = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype],
        B, Hq, Hkv, Sq, Skv, D, ctypes.cast(strides, ctypes.c_void_p),
        float(sm_scale), int(bool(causal)), _window(window, Sq, Skv),
        float(softcap or 0.0), cuda_stream(q.device))
    if rc < 0:
        raise RuntimeError("flash_attention_bwd: a TMA tensor map failed to "
                           f"encode (CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{rc}")
    counted("flash_attention_bwd")
    bwd_route_counts["tensor_core" if tc.value else "fma"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its hand-written backward: the forward kernel
    also writes each row's log-sum-exp, and ``backward`` runs
    :func:`flash_attention_bwd` on what the forward saved (q, k, v, the
    output and the log-sum-exp).  Nothing falls back to the plain
    version for a CUDA tensor."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       window=window, softcap=softcap,
                                       sm_scale=sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, softcap=softcap,
                        sm_scale=sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         **ctx.mask)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, softcap: float = 0.0,
                    sm_scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with ``Hq % Hkv == 0``.
    Returns (B, Hq, Sq, D) in ``q.dtype``.  Where autograd records (grad
    enabled and an input requires grad) the call goes through
    :class:`FlashAttention`; otherwise no log-sum-exp is written and
    nothing is saved."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap,
                                    sm_scale)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               softcap=softcap, sm_scale=sm_scale)[0]
