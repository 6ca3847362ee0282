"""Relocation-codec kernels for Hopper: chunks → send buffer → chunks.

The PyTorch/CUDA port of ``repro.kernels.reloc_codec``.  The device
transport's window hot path is one kernel per row-width class:

* :func:`encode_pack` — fused *encode+pack*: reads rows straight out of
  a collection chunk matrix (any dtype), as bytes, applies the
  destination permutation (a slot → row table) and writes the
  ``(pairs, slots, width)`` per-pair slotted send buffer, padding and
  empty-slot zeroing included.
* :func:`pack_rows` — the same pack for *already-encoded* ragged byte
  rows (pytree values, pickled metadata, mixed dtypes): one gather per
  slot from a flat byte arena.
* :func:`decode_rows` — fused *unpack+decode*: a received block of wire
  rows (with a row stride) → the destination chunk matrix, the
  manifest's width and dtype applied (class padding trimmed, bytes
  viewed as the dtype).

The kernels are CUDA C++ (``csrc/reloc_codec.cu``) with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/repro_torch_kernels/<hash of source and flags>/`` and loaded
with ``ctypes`` (``kernels/cuda_build.py``).  A wrapper given a CUDA
tensor launches its kernel on the current stream or raises; given a
CPU tensor it computes the plain version (``kernels/ref.py``) — the
CPU parity vehicle, as
``pallas_interpret`` is for the JAX package.  Each launch adds one to
``launch_counts[<kernel name>]``, the registry every kernel of the port
shares.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .cuda_build import (CudaLibrary, counted, cuda_stream, launch_counts,
                         reset_launch_counts)

__all__ = ["encode_pack", "pack_rows", "decode_rows",
           "launch_counts", "reset_launch_counts", "KERNELS", "SOURCE",
           "LIBRARY"]

#: kernel name → the TPU kernel (file:line) it replaces
KERNELS = {
    "reloc_encode_pack": "src/repro/kernels/reloc_codec.py:122",
    "reloc_pack_rows": "src/repro/kernels/reloc_codec.py:201",
    "reloc_decode_rows": "src/repro/kernels/reloc_codec.py:268",
}


def _bind(lib) -> None:
    P, L = ctypes.c_void_p, ctypes.c_longlong
    lib.reloc_encode_pack.argtypes = [P, P, P, P, L, L, L, L, P]
    lib.reloc_pack_rows.argtypes = [P, P, P, P, L, L, L, P]
    lib.reloc_decode_rows.argtypes = [P, P, L, L, L, P]
    for fn in (lib.reloc_encode_pack, lib.reloc_pack_rows,
               lib.reloc_decode_rows):
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("reloc_codec.cu", "reloc_codec", _bind, KERNELS)
#: the kernels' CUDA source, relative to the repository root
SOURCE = LIBRARY.source


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _on_card(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one (plain version)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: tensors on {t.device} are not supported")


def _table(x, dtype, n: int, device, name: str) -> torch.Tensor:
    t = torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()
    if t.shape != (n,):
        raise ValueError(f"{name}: slot table of shape {tuple(t.shape)}, "
                         f"expected ({n},)")
    return t


# ---------------------------------------------------------------------------
# the three wrappers
# ---------------------------------------------------------------------------
def encode_pack(mat, idx, widths, *, pairs: int, slots: int,
                width: int) -> torch.Tensor:
    """Rows of ``mat`` (any dtype) → bucketed uint8 send buffer.

    ``mat``: (m, k) chunk rows; ``idx``: (pairs*slots,) int32 source-row
    index per buffer slot (clamped; ignored where ``widths`` is 0);
    ``widths``: (pairs*slots,) int32 — ``k*itemsize`` for live slots, 0
    for empty slots (zero-filled).  Returns ``(pairs, slots, width)``
    uint8.
    """
    if not _on_card(mat, "encode_pack"):
        return ref.reloc_encode_pack_ref(mat, idx, widths, pairs=pairs,
                                         slots=slots, width=width)
    if mat.dim() != 2 or mat.shape[0] == 0 or not mat.is_contiguous():
        raise ValueError("encode_pack needs a contiguous non-empty (m, k) "
                         f"matrix, got {tuple(mat.shape)}")
    m = int(mat.shape[0])
    nb = int(mat.shape[1]) * mat.element_size()
    if width < nb:
        raise ValueError(f"slot width {width} < row bytes {nb}")
    n = pairs * slots
    idx = _table(idx, torch.int32, n, mat.device, "encode_pack")
    widths = _table(widths, torch.int32, n, mat.device, "encode_pack")
    out = torch.empty((pairs, slots, width), dtype=torch.uint8,
                      device=mat.device)
    if n * width:
        rc = LIBRARY.lib().reloc_encode_pack(
            mat.data_ptr(), idx.data_ptr(), widths.data_ptr(),
            out.data_ptr(), n, m, nb, width, cuda_stream(mat.device))
        _check(rc, "reloc_encode_pack")
        counted("reloc_encode_pack")
    return out


def pack_rows(flat_src, offsets, widths, *, pairs: int, slots: int,
              width: int) -> torch.Tensor:
    """Pre-encoded byte rows → bucketed uint8 send buffer.

    ``flat_src``: 1-D uint8 arena holding every row's bytes back to
    back (reads past its end clamp to the last byte, so the arena
    carries ≥ ``width`` trailing zeros); ``offsets``: (pairs*slots,)
    int64 byte offset per slot; ``widths``: (pairs*slots,) int32 valid
    byte count per slot (0 → zero slot).  Returns ``(pairs, slots,
    width)`` uint8.
    """
    if not _on_card(flat_src, "pack_rows"):
        return ref.reloc_pack_rows_ref(flat_src, offsets, widths,
                                       pairs=pairs, slots=slots,
                                       width=width)
    if flat_src.dtype != torch.uint8 or flat_src.dim() != 1 \
            or flat_src.shape[0] == 0 or not flat_src.is_contiguous():
        raise ValueError("pack_rows needs a contiguous non-empty 1-D "
                         "uint8 arena")
    n = pairs * slots
    offsets = _table(offsets, torch.int64, n, flat_src.device, "pack_rows")
    widths = _table(widths, torch.int32, n, flat_src.device, "pack_rows")
    out = torch.empty((pairs, slots, width), dtype=torch.uint8,
                      device=flat_src.device)
    if n * width:
        rc = LIBRARY.lib().reloc_pack_rows(
            flat_src.data_ptr(), offsets.data_ptr(), widths.data_ptr(),
            out.data_ptr(), n, int(flat_src.shape[0]), width,
            cuda_stream(flat_src.device))
        _check(rc, "reloc_pack_rows")
        counted("reloc_pack_rows")
    return out


def decode_rows(rows, *, nbytes: int, dtype: torch.dtype) -> torch.Tensor:
    """A delivered ``(m, W)`` uint8 wire block → ``(m, k)`` typed rows.

    ``rows`` may be a strided view (row stride ≥ ``nbytes``, unit byte
    stride) — the receiver's slice of the transposed send buffer is
    read in place, never copied first.
    """
    if not _on_card(rows, "decode_rows"):
        return ref.reloc_decode_rows_ref(rows, nbytes=nbytes, dtype=dtype)
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError("decode_rows needs a 2-D uint8 block")
    m, w = int(rows.shape[0]), int(rows.shape[1])
    isz = dtype.itemsize
    if nbytes % isz or nbytes > w:
        raise ValueError(f"cannot decode {nbytes} bytes of {dtype} from "
                         f"{w}-byte rows")
    if (w > 1 and rows.stride(1) != 1) \
            or (m > 1 and rows.stride(0) < nbytes):
        raise ValueError(f"decode_rows needs unit byte stride, got strides "
                         f"{rows.stride()}")
    dev = rows.device
    out = torch.empty((m, nbytes // isz), dtype=dtype, device=dev)
    if m * nbytes:
        rc = LIBRARY.lib().reloc_decode_rows(
            rows.data_ptr(), out.data_ptr(), m, rows.stride(0), nbytes,
            cuda_stream(dev))
        _check(rc, "reloc_decode_rows")
        counted("reloc_decode_rows")
    return out
