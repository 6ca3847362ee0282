"""Plain PyTorch versions of the relocation-codec kernels.

The port of ``repro.kernels.ref`` §codec (``reloc_*_ref``): each function
computes what its CUDA kernel in ``csrc/reloc_codec.cu`` computes, bit
for bit, with ordinary tensor ops.  The CPU tests hold the port against
the JAX oracles through these, and ``chip_smoke.py`` holds each kernel
against them on the card.  Nothing on the card's main path calls them:
the kernel wrappers take them only for tensors that lie on the CPU.

The gathers walk the slot table in steps of about 128 MiB of index
temporaries, so the main path's ~67 M-slot send buffers fit beside the
kernel's own output on one card.
"""
from __future__ import annotations

import torch

__all__ = ["reloc_encode_pack_ref", "reloc_pack_rows_ref",
           "reloc_decode_rows_ref"]

# bytes of int64 position temporaries per gather step
_STEP_BYTES = 1 << 27


def _step(width: int) -> int:
    return max(1, _STEP_BYTES // (8 * max(int(width), 1)))


def _u8_rows(mat: torch.Tensor) -> torch.Tensor:
    """(m, k) rows of any dtype → (m, k*itemsize) uint8 wire rows."""
    m = int(mat.shape[0])
    return mat.contiguous().reshape(m, -1).view(torch.uint8).reshape(m, -1)


def reloc_encode_pack_ref(mat, idx, widths, *, pairs: int, slots: int,
                          width: int) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.reloc_codec.encode_pack`:
    slot ``s`` ← row ``clamp(idx[s], 0, m-1)`` as bytes, zero from byte
    ``min(widths[s], nb)`` on."""
    mat = torch.as_tensor(mat)
    dev = mat.device
    if mat.dim() != 2 or mat.shape[0] == 0:
        raise ValueError(f"encode_pack needs a non-empty (m, k) matrix, "
                         f"got {tuple(mat.shape)}")
    u8 = _u8_rows(mat)
    m, nb = int(u8.shape[0]), int(u8.shape[1])
    if width < nb:
        raise ValueError(f"slot width {width} < row bytes {nb}")
    if width > nb:
        padded = u8.new_zeros((m, width))
        padded[:, :nb] = u8
        u8 = padded
    idx = torch.as_tensor(idx).to(dev, torch.int64).clamp(0, m - 1)
    wid = torch.as_tensor(widths).to(dev, torch.int64)
    n = pairs * slots
    out = torch.empty((n, width), dtype=torch.uint8, device=dev)
    span = torch.arange(width, device=dev)
    step = _step(width)
    for s0 in range(0, n, step):
        s1 = min(n, s0 + step)
        rows = u8[idx[s0:s1]]
        out[s0:s1] = rows.masked_fill_(span[None, :] >= wid[s0:s1, None], 0)
    return out.reshape(pairs, slots, width)


def reloc_pack_rows_ref(flat_src, offsets, widths, *, pairs: int,
                        slots: int, width: int) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.reloc_codec.pack_rows`:
    slot ``s`` ← ``arena[clamp(off[s] + j, 0, A-1)]`` for ``j <
    widths[s]``, zero past it."""
    arena = torch.as_tensor(flat_src)
    if arena.dtype != torch.uint8 or arena.dim() != 1:
        raise ValueError("pack_rows needs a 1-D uint8 arena")
    dev = arena.device
    last = int(arena.shape[0]) - 1
    off = torch.as_tensor(offsets).to(dev, torch.int64)
    wid = torch.as_tensor(widths).to(dev, torch.int64)
    n = pairs * slots
    out = torch.empty((n, width), dtype=torch.uint8, device=dev)
    span = torch.arange(width, device=dev)
    step = _step(width)
    for s0 in range(0, n, step):
        s1 = min(n, s0 + step)
        pos = (off[s0:s1, None] + span[None, :]).clamp_(0, last)
        rows = arena[pos]
        out[s0:s1] = rows.masked_fill_(span[None, :] >= wid[s0:s1, None], 0)
    return out.reshape(pairs, slots, width)


def reloc_decode_rows_ref(rows, *, nbytes: int, dtype) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.reloc_codec.decode_rows`:
    the first ``nbytes`` of each row, bitcast to ``dtype``, in a fresh
    tensor."""
    rows = torch.as_tensor(rows)
    m = int(rows.shape[0])
    isz = dtype.itemsize
    if nbytes % isz:
        raise ValueError(f"{nbytes} bytes is not a whole number of "
                         f"{dtype} elements")
    u8 = rows[:, :nbytes].to(torch.uint8).clone(
        memory_format=torch.contiguous_format)
    return u8.view(dtype).reshape(m, nbytes // isz)
