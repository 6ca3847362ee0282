"""Chunkwise mLSTM (xLSTM matrix memory) for Hopper.

The PyTorch/CUDA port of ``repro.kernels.mlstm``: the stabilized mLSTM
recurrence over (BH, S, d) in chunks of 64 steps — within a chunk a
masked, decay-weighted attention-like product, across chunks the carried
(C, n, m) state.  The kernel is CUDA C++ (``csrc/mlstm.cu``; grid (BH,
d / 32), each block owning 32 columns of C) behind a plain C interface,
built and loaded like the other kernels (``kernels/cuda_build.py``).

As the Pallas wrapper does, q and k are scaled by ``1/sqrt(d)`` in
their own dtype before the recurrence (inside the kernel, here; the
scale, a weakly typed scalar in JAX, is rounded to that dtype first).
A wrapper given CUDA tensors launches the kernel on the current stream
or raises; given CPU tensors it computes the plain version
(:func:`repro_torch.kernels.ref.mlstm_ref`, the sequential recurrence,
which scales q and k in f32 — in bfloat16 the two differ by that one
rounding).  Each launch adds one to ``launch_counts["mlstm_chunkwise"]``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import ref
from .cuda_build import CudaLibrary, counted

__all__ = ["mlstm_chunkwise", "mlstm_flops", "KERNELS", "LIBRARY",
           "SOURCE", "CHUNK", "MAX_HEAD_DIM"]

#: kernel name → the TPU kernel (file:line) it replaces
KERNELS = {"mlstm_chunkwise": "src/repro/kernels/mlstm.py:36"}

CHUNK = 64          # steps per chunk (the Pallas wrapper's block_s)
MAX_HEAD_DIM = 1024  # C[:, 32 columns] and n must fit in shared memory

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _bind(lib) -> None:
    P, L, I, F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_float)
    lib.mlstm_chunkwise_fwd.argtypes = [P] * 9 + [I, I, L, L, L, F, P]
    lib.mlstm_chunkwise_fwd.restype = ctypes.c_int


LIBRARY = CudaLibrary("mlstm.cu", "mlstm", _bind, KERNELS)
SOURCE = LIBRARY.source


def mlstm_flops(BH: int, S: int, d: int) -> int:
    """Operations the chunkwise form needs (each counted once, whatever
    the kernel repeats): per chunk of ``L`` steps, the scores ``q kᵀ``
    (2·L²·d), ``q C`` (2·L·d²), the decay-weighted ``v`` (2·L²·d) and
    the state update ``kᵀ v`` (2·L·d²), the masked half of the L×L
    products included."""
    total = 0
    for c0 in range(0, S, CHUNK):
        L = min(CHUNK, S - c0)
        total += 4 * L * L * d + 4 * L * d * d
    return BH * total


def mlstm_chunkwise(q, k, v, i_gate, f_gate):
    """q, k, v: (BH, S, d) in one of float32 / bfloat16 / float16;
    i_gate, f_gate: (BH, S) pre-activations in that dtype or float32.

    Returns (h (BH, S, d) in ``q.dtype``, (C (BH, d, d), n (BH, d),
    m (BH,)) in float32)."""
    if q.device.type == "cpu":
        return ref.mlstm_ref(q, k, v, i_gate, f_gate)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunkwise: tensors on {q.device} are not "
                         "supported")
    if q.dim() != 3 or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"q, k, v must share one (BH, S, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, S, d = (int(n) for n in q.shape)
    if tuple(i_gate.shape) != (BH, S) or tuple(f_gate.shape) != (BH, S):
        raise ValueError(f"gates must be ({BH}, {S}), got "
                         f"{tuple(i_gate.shape)}, {tuple(f_gate.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         "kernel takes one of float32, bfloat16, float16")
    if i_gate.dtype != f_gate.dtype or i_gate.dtype not in (
            q.dtype, torch.float32):
        raise ValueError(f"gate dtypes {i_gate.dtype}, {f_gate.dtype}: "
                         f"both {q.dtype} or both float32")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if any(t.device != q.device for t in (k, v, i_gate, f_gate)):
        raise ValueError("q, k, v and the gates lie on different devices")
    q, k, v, i_gate, f_gate = (t.contiguous()
                               for t in (q, k, v, i_gate, f_gate))
    dev = q.device
    h = torch.empty((BH, S, d), dtype=q.dtype, device=dev)
    if BH == 0 or S == 0 or d == 0:      # the initial state, untouched
        return h, (torch.zeros((BH, d, d), dtype=torch.float32, device=dev),
                   torch.zeros((BH, d), dtype=torch.float32, device=dev),
                   torch.full((BH,), float("-inf"), device=dev))
    C = torch.empty((BH, d, d), dtype=torch.float32, device=dev)
    n = torch.empty((BH, d), dtype=torch.float32, device=dev)
    m = torch.empty((BH,), dtype=torch.float32, device=dev)
    gate_code = 0 if i_gate.dtype == torch.float32 \
        else _DTYPE_CODE[i_gate.dtype]
    rc = LIBRARY.lib().mlstm_chunkwise_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
        f_gate.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
        m.data_ptr(), _DTYPE_CODE[q.dtype], gate_code, BH, S, d,
        1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlstm_chunkwise launch failed: CUDA error {rc}")
    counted("mlstm_chunkwise")
    return h, (C, n, m)
