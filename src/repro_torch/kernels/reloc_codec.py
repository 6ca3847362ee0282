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
with ``ctypes``.  A wrapper given a CUDA tensor launches its kernel on
the current stream or raises; given a CPU tensor it computes the plain
version (``kernels/ref.py``) — the CPU parity vehicle, as
``pallas_interpret`` is for the JAX package.  Each launch adds one to
``launch_counts[<kernel name>]``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import ref

__all__ = ["encode_pack", "pack_rows", "decode_rows",
           "launch_counts", "reset_launch_counts", "build", "KERNELS",
           "SOURCE"]

#: the kernels' CUDA source, relative to the repository root
SOURCE = "src/repro_torch/kernels/csrc/reloc_codec.cu"

#: kernel name → the TPU kernel (file:line) it replaces
KERNELS = {
    "reloc_encode_pack": "src/repro/kernels/reloc_codec.py:122",
    "reloc_pack_rows": "src/repro/kernels/reloc_codec.py:201",
    "reloc_decode_rows": "src/repro/kernels/reloc_codec.py:268",
}


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------
_COUNT_LOCK = threading.Lock()
launch_counts: dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in launch_counts:
            launch_counts[name] = 0


def _counted(name: str) -> None:
    # depth-2 windows launch from their background delivery thread
    with _COUNT_LOCK:
        launch_counts[name] += 1


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------
_SRC = Path(__file__).resolve().parent / "csrc" / "reloc_codec.cu"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_BUILD_LOCK = threading.Lock()
_LIB = None
#: the compiler's output of the build this process loaded (ptxas lines)
build_log = ""


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the relocation-codec kernels "
                           "are built from csrc/reloc_codec.cu at first use "
                           "and need the CUDA toolkit")
    return found


def build() -> Path:
    """Compile ``csrc/reloc_codec.cu`` (once per source and flags) and
    return the shared library's path."""
    global build_log
    src = _SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD_ROOT / key / "libreloc_codec.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"libreloc_codec.{os.getpid()}.tmp.so")
    proc = subprocess.run([_nvcc(), *_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
    build_log = proc.stderr
    os.replace(tmp, lib)
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        with _BUILD_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(str(build()))
                P, L = ctypes.c_void_p, ctypes.c_longlong
                lib.reloc_encode_pack.argtypes = [P, P, P, P, L, L, L, L, P]
                lib.reloc_pack_rows.argtypes = [P, P, P, P, L, L, L, P]
                lib.reloc_decode_rows.argtypes = [P, P, L, L, L, P]
                for fn in (lib.reloc_encode_pack, lib.reloc_pack_rows,
                           lib.reloc_decode_rows):
                    fn.restype = ctypes.c_int
                _LIB = lib
    return _LIB


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


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


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
        rc = _lib().reloc_encode_pack(
            mat.data_ptr(), idx.data_ptr(), widths.data_ptr(),
            out.data_ptr(), n, m, nb, width, _stream(mat.device))
        _check(rc, "reloc_encode_pack")
        _counted("reloc_encode_pack")
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
        rc = _lib().reloc_pack_rows(
            flat_src.data_ptr(), offsets.data_ptr(), widths.data_ptr(),
            out.data_ptr(), n, int(flat_src.shape[0]), width,
            _stream(flat_src.device))
        _check(rc, "reloc_pack_rows")
        _counted("reloc_pack_rows")
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
    out = torch.empty((m, nbytes // isz), dtype=dtype, device=rows.device)
    if m * nbytes:
        rc = _lib().reloc_decode_rows(
            rows.data_ptr(), out.data_ptr(), m, rows.stride(0), nbytes,
            _stream(rows.device))
        _check(rc, "reloc_decode_rows")
        _counted("reloc_decode_rows")
    return out
