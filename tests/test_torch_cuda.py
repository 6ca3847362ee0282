"""The port's CUDA kernels on the card, each against its plain version.

Needs an NVIDIA card and ``nvcc`` (the kernels have no CPU mode; their
plain versions are held against the JAX package in
``test_torch_codec.py`` and ``test_torch_attention.py``).  Imports
neither JAX nor ``ml_dtypes``, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the codec kernels exactly (``torch.equal``) — they only
move bytes; the flash kernel within ``1e-4`` in float32 and ``2e-2``
(absolute and relative) in bfloat16 and float16 of ``flash_ref`` — both
sum in f32, in another order, and round the output once; the model's
fused prefill within ``3e-2`` of the composite one in bfloat16, the
tolerance of ``tests/test_arch_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
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


FLASH_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, window, softcap)
    (2, 4, 4, 70, 70, 64, True, None, 0.0),
    (1, 6, 1, 129, 129, 128, True, None, 0.0),
    (2, 8, 1, 100, 100, 256, False, None, 0.0),
    (1, 4, 2, 200, 200, 128, True, 48, 0.0),
    (1, 4, 2, 65, 65, 128, False, None, 50.0),
    (2, 4, 2, 1, 90, 128, True, None, 0.0),           # Sq = 1
    (1, 2, 1, 130, 40, 64, True, 16, 0.0),            # masked rows
]


def _flash_inputs(case, dtype, seed):
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    mk = lambda h, s: torch.randn((B, h, s, D), generator=g,
                                  device="cuda").to(dt)
    return mk(Hq, Sq), mk(Hkv, Skv), mk(Hkv, Skv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernel_matches_flash_ref_on_card(case, dtype):
    _need_card()
    q, k, v = _flash_inputs(case, dtype, seed=len(str(case)))
    causal, window, softcap = case[6:]
    before = rc.launch_counts["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    want = ref.flash_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap)
    torch.cuda.synchronize()
    assert rc.launch_counts["flash_attention"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=0 if dtype == "float32" else tol)
    assert torch.isfinite(got.float()).all()
    if causal and window is not None and case[3] > case[4]:
        # top-left causal rows i >= Skv + window - 1 keep no key: exact 0
        dead = case[4] + window - 1
        assert not got[:, :, dead:].float().abs().max().item()


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take():
    _need_card()
    q = torch.zeros((1, 2, 8, 32), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):                  # head dim 32
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 3, 8, 64), device="cuda", dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 8, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):                  # 3 % 2 heads
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError):                  # float64
        fa.flash_attention(q.double(), k.double(), k.double())


@pytest.mark.cuda
def test_model_prefill_fused_matches_composite_on_card():
    _need_card()
    from repro_torch.models import transformer as T
    from repro_torch.models import zoo
    from repro_torch.models.parallel import Parallel
    from repro_torch.serving.decode import serving_config

    cfg = dataclasses.replace(serving_config(), head_dim=64)
    par = Parallel()
    params = zoo.init_params(cfg, 0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=g,
                           device="cuda", dtype=torch.int32)
    before = rc.launch_counts["flash_attention"]
    st_f, lg_f = T.prefill_forward(params, cfg, par, {"tokens": tokens},
                                   128, impl="fused")
    assert rc.launch_counts["flash_attention"] == before + cfg.n_layers
    st_c, lg_c = T.prefill_forward(params, cfg, par, {"tokens": tokens},
                                   128, impl="composite")
    torch.testing.assert_close(lg_f, lg_c, atol=3e-2, rtol=3e-2)
    for a, b in zip(st_f["scan"][0].values(), st_c["scan"][0].values()):
        torch.testing.assert_close(a.float(), b.float(), atol=3e-2,
                                   rtol=3e-2)
