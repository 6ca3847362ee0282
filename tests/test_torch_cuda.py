"""The port's CUDA kernels on the card, each against its plain version.

Needs an NVIDIA card and ``nvcc`` (the kernels have no CPU mode; their
plain versions are held against the JAX package in
``test_torch_codec.py``).  Imports neither JAX nor ``ml_dtypes``, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: exact (``torch.equal``) — the kernels only move bytes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import reloc_codec as rc

DTYPES = ["float32", "bfloat16", "int32", "uint8", "float64"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")


def _rows(dtype, m, k, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    u8 = torch.randint(0, 256, (m, k * dt.itemsize), generator=g,
                       device="cuda", dtype=torch.uint8)
    return u8.view(dt)


def _tables(pairs, slots, m, nb, seed):
    """Live slots, zero-width slots, widths below nb, out-of-range and
    negative row indices."""
    rng = np.random.default_rng(seed)
    n = pairs * slots
    idx = rng.integers(-3, m + 3, n).astype(np.int32)
    wid = np.where(rng.random(n) < 0.6, nb, 0).astype(np.int32)
    wid[::7] = np.minimum(nb, rng.integers(0, nb + 1, len(wid[::7])))
    return idx, wid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_match_plain_versions_on_card(dtype):
    _need_card()
    dev = torch.device("cuda")
    before = dict(rc.launch_counts)
    for k in (3, 8, 32):
        mat = _rows(dtype, 37, k, seed=k)
        nb = k * mat.element_size()
        for W in sorted({max(8, 1 << (nb - 1).bit_length()), 2 * nb + 16}):
            idx, wid = _tables(9, 5, 37, nb, seed=W)
            got = rc.encode_pack(mat, idx, wid, pairs=9, slots=5, width=W)
            want = ref.reloc_encode_pack_ref(mat, idx, wid, pairs=9,
                                             slots=5, width=W)
            assert torch.equal(got, want)
            arena = torch.cat([got.reshape(-1),
                               torch.zeros(W, dtype=torch.uint8,
                                           device=dev)])
            offs = np.arange(45, dtype=np.int64) * W + 3
            offs[-1] = arena.numel() - 2           # reads past the end
            got2 = rc.pack_rows(arena, offs, wid, pairs=9, slots=5, width=W)
            want2 = ref.reloc_pack_rows_ref(arena, offs, wid, pairs=9,
                                            slots=5, width=W)
            assert torch.equal(got2, want2)
            block = got.view(3, 3, 5, W).transpose(0, 1)[1, 2, 1:5]
            got3 = rc.decode_rows(block, nbytes=nb, dtype=mat.dtype)
            want3 = ref.reloc_decode_rows_ref(block, nbytes=nb,
                                              dtype=mat.dtype)
            torch.cuda.synchronize()
            assert torch.equal(got3.view(torch.uint8),
                               want3.view(torch.uint8))
    assert all(rc.launch_counts[n] > before[n] for n in rc.KERNELS)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    _need_card()
    mat = torch.zeros((4, 8), dtype=torch.float32, device="cuda")
    with pytest.raises(ValueError):                  # slot narrower than row
        rc.encode_pack(mat, np.zeros(2, np.int32), np.zeros(2, np.int32),
                       pairs=1, slots=2, width=16)
    with pytest.raises(ValueError):                  # not contiguous
        rc.encode_pack(mat.t(), np.zeros(2, np.int32),
                       np.zeros(2, np.int32), pairs=1, slots=2, width=64)
    rows = torch.zeros((4, 64), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError):                  # byte stride != 1
        rc.decode_rows(rows[:, ::2], nbytes=16, dtype=torch.float32)
    with pytest.raises(ValueError):                  # table length
        rc.pack_rows(rows.reshape(-1), np.zeros(3, np.int64),
                     np.zeros(4, np.int32), pairs=2, slots=2, width=8)
