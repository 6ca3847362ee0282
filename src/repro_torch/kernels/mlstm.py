"""Chunkwise mLSTM (xLSTM matrix memory) for Hopper.

The PyTorch/CUDA port of ``repro.kernels.mlstm``: the stabilized mLSTM
recurrence over (BH, S, d) in chunks of 64 steps — within a chunk a
masked, decay-weighted attention-like product, across chunks the carried
(C, n, m) state.  The kernels are CUDA C++ (``csrc/mlstm.cu``) behind a
plain C interface, built and loaded like the other kernels
(``kernels/cuda_build.py``).  Two routes, by an explicit rule
(:func:`tensor_core_route`):

* bfloat16 / float16 with ``d % 16 == 0`` and 16-byte aligned q, k, v:
  the tensor-core route — a gate pass, an intra-chunk pass (the scores
  once per chunk on ``mma.sync``, and every operand the state pass needs
  prepared), then a state pass sequential over chunks with C in f32 and
  every f32 operand entering the tensor cores as an input-type
  ``hi + lo`` pair.  It needs :func:`scratch_floats` floats of scratch,
  allocated here with ``torch.empty``.
* float32, and 16-bit head dims the tensor cores do not tile: f32 FMA
  loops (grid (BH, d / 32), each block owning 32 columns of C).

As the Pallas wrapper does, q and k are scaled by ``1/sqrt(d)`` in
their own dtype before the recurrence (inside the kernels, here; the
scale, a weakly typed scalar in JAX, is rounded to that dtype first).
A wrapper given CUDA tensors launches the kernels on the current stream
or raises; given CPU tensors it computes the plain version
(:func:`repro_torch.kernels.ref.mlstm_ref`, the sequential recurrence,
which scales q and k in f32 — in bfloat16 the two differ by that one
rounding).  Each call adds one to ``launch_counts["mlstm_chunkwise"]``,
whichever route and however many kernels it launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import ref
from .cuda_build import CudaLibrary, counted, cuda_stream, refuse_grad

__all__ = ["mlstm_chunkwise", "mlstm_flops", "tensor_core_route",
           "scratch_floats", "KERNELS", "LIBRARY", "SOURCE", "CHUNK",
           "MAX_HEAD_DIM"]

#: kernel name → the TPU kernel (file:line) it replaces
KERNELS = {"mlstm_chunkwise": "src/repro/kernels/mlstm.py:36"}

CHUNK = 64          # steps per chunk (the Pallas wrapper's block_s)
MAX_HEAD_DIM = 1024  # C[:, 32 columns] and n must fit in shared memory
TC_HEAD_DIM = 16    # the tensor-core route tiles d in steps of 16

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _bind(lib) -> None:
    P, L, I, F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_float)
    lib.mlstm_chunkwise_fwd.argtypes = [P] * 9 + [I, I, L, L, L, F, P]
    lib.mlstm_chunkwise_tc.argtypes = [P] * 10 + [I, I, L, L, L, F, P]
    for fn in (lib.mlstm_chunkwise_fwd, lib.mlstm_chunkwise_tc):
        fn.restype = ctypes.c_int
    lib.mlstm_tc_scratch_floats.argtypes = [L, L, L]
    lib.mlstm_tc_scratch_floats.restype = L


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


def tensor_core_route(q, k, v) -> bool:
    """The explicit rule between the two routes: the tensor-core kernels
    take bfloat16 / float16 with ``d % 16 == 0`` and q, k, v starting on
    16-byte boundaries (they load 16-byte vectors); everything else
    takes the FMA kernel."""
    return (q.dtype in (torch.bfloat16, torch.float16)
            and q.shape[-1] % TC_HEAD_DIM == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def scratch_floats(BH: int, S: int, d: int) -> int:
    """Scratch of the tensor-core route, in f32 words (``csrc/mlstm.cu``:
    ``tc_scratch_floats``): six (BH, Sp) per-step arrays (b, i, m, g, u,
    W's row sums; Sp = 64 * chunks), the (BH, chunks, d) n increments and
    the (BH, chunks) carry decays, padded to 16 bytes; W's hi + lo pair
    (4096 words a chunk); then per chunk and 64-wide slice of d, the
    rounded, scaled q and the hi + lo pair of (k * u)ᵀ as the state
    pass's 64 x 72 tiles of the input type (3 x 2304 words)."""
    nc = -(-S // CHUNK)
    Sp = CHUNK * nc
    small = 6 * BH * Sp + BH * nc * d + BH * nc
    return (-(-small // 4) * 4 + BH * nc * CHUNK * CHUNK
            + BH * nc * -(-d // CHUNK) * 3 * 2304)


def mlstm_chunkwise(q, k, v, i_gate, f_gate):
    """q, k, v: (BH, S, d) in one of float32 / bfloat16 / float16;
    i_gate, f_gate: (BH, S) pre-activations in that dtype or float32.

    Returns (h (BH, S, d) in ``q.dtype``, (C (BH, d, d), n (BH, d),
    m (BH,)) in float32)."""
    if q.device.type == "cpu":
        return ref.mlstm_ref(q, k, v, i_gate, f_gate)
    refuse_grad("mlstm_chunkwise", q, k, v, i_gate, f_gate)
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
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
            f_gate.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
            m.data_ptr())
    tail = (_DTYPE_CODE[q.dtype], gate_code, BH, S, d, 1.0 / math.sqrt(d),
            cuda_stream(dev))
    if tensor_core_route(q, k, v):
        scratch = torch.empty(scratch_floats(BH, S, d), dtype=torch.float32,
                              device=dev)
        rc = LIBRARY.lib().mlstm_chunkwise_tc(*ptrs, scratch.data_ptr(),
                                              *tail)
    else:
        rc = LIBRARY.lib().mlstm_chunkwise_fwd(*ptrs, *tail)
    if rc != 0:
        raise RuntimeError(f"mlstm_chunkwise launch failed: CUDA error {rc}")
    counted("mlstm_chunkwise")
    return h, (C, n, m)
