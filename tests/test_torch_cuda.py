"""The port's CUDA kernels on the card, each against its plain version.

Needs an NVIDIA card and ``nvcc`` (the kernels have no CPU mode; their
plain versions are held against the JAX package in
``test_torch_codec.py``, ``test_torch_attention.py``,
``test_torch_recurrent.py``, ``test_torch_xlstm.py`` and
``test_torch_moe.py``).  Imports
neither JAX nor ``ml_dtypes``, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the codec kernels exactly (``torch.equal``) — they only
move bytes; the flash kernel within ``1e-4`` in float32 and ``2e-2``
(absolute and relative) in bfloat16 and float16 of ``flash_ref`` — both
sum in f32, in another order, and round the output once — and also
within ``1e-4`` plus one output ulp (relative ``1e-2`` in bfloat16,
``2e-3`` in float16), and in bfloat16 within half an ulp plus ``1e-4``
of ``flash_ref`` on float32 copies of its inputs; the model's
fused prefill within ``3e-2`` of the composite one in bfloat16, the
tolerance of ``tests/test_arch_smoke.py``; the recurrence kernels and
the recurrent models within the tolerances stated at their tests; the
MoE gather exactly, the MoE combine within ``1e-6`` of each row's
largest term (both sum in f32, in another order), plus one ulp of the
output type in bfloat16 and float16 (each rounds its sum once);
``segment_accept`` and ``Accumulator.totals`` the same bits on two
calls; the paper's apps on the card against their CPU runs at the
tolerances of ``tests/test_torch_apps.py``.  The flash backward: in
float32 within ``1e-4`` of the largest gradient element of
``flash_bwd_ref``; in bfloat16 each of dq, dk, dv no further (relative
L2) from ``flash_bwd_ref`` on float32 copies than 1.25x the plain
version's own bfloat16 result is; two launches the same bits; the
forward's log-sum-exp within ``1e-5`` of ``flash_ref``'s; every case on
both of its routes (16-bit aligned: the tensor-core kernels; float32
and unaligned views: the FMA kernels), each element of a 16-bit
gradient within half an output ulp of the float32 result plus ``1e-4``
of the largest; a reduced qwen2 train step's gradients fused vs
composite within ``1e-4`` in relative L2 (float32).  The routes of
``rg_lru`` (TMA, simple) and ``moe_combine`` (bulk, registers, simple)
keep one per-element arithmetic and order: the same bits on every route
a case allows, and on two launches.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

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
    # (B, Hq, Hkv, Sq, Skv, D, causal, window, softcap[, layout]);
    # bfloat16/float16 with 16-byte rows run the TMA + wgmma kernel (key
    # tiles of 128 at D <= 128, 64 at D = 192 and 256), float32 and
    # layout "pad" the FMA kernel
    (2, 4, 4, 70, 70, 64, True, None, 0.0),
    (1, 6, 1, 129, 129, 128, True, None, 0.0),
    (2, 8, 1, 100, 100, 256, False, None, 0.0),
    (1, 4, 2, 200, 200, 128, True, 48, 0.0),
    (1, 4, 2, 65, 65, 128, False, None, 50.0),
    (2, 4, 2, 1, 90, 128, True, None, 0.0),           # Sq = 1
    (1, 2, 1, 130, 40, 64, True, 16, 0.0),            # masked rows
    (2, 4, 4, 150, 150, 192, True, None, 0.0),        # MLA's head dim
    (1, 4, 4, 77, 77, 192, False, None, 0.0),
    (2, 4, 4, 1, 90, 192, True, None, 0.0),
    # lengths that are no multiple of the 128-row q-block or a key tile
    (1, 6, 1, 129, 200, 128, True, None, 0.0),
    (1, 8, 1, 200, 129, 256, False, None, 0.0),
    (1, 4, 4, 1000, 1000, 192, True, None, 0.0),
    (1, 2, 2, 1000, 1000, 64, False, None, 0.0),
    # Skv < Sq: rows i >= Skv + window - 1 keep no key and give 0
    (1, 6, 1, 1000, 200, 128, True, 100, 0.0),
    (1, 8, 1, 300, 129, 256, True, 16, 0.0),
    # windows shorter than one key tile, longer than several
    (1, 8, 1, 700, 700, 64, True, 5, 0.0),
    (1, 8, 1, 700, 700, 192, True, 40, 0.0),
    (1, 10, 1, 1000, 1000, 256, True, 300, 0.0),
    (1, 6, 1, 1000, 1000, 128, False, 450, 0.0),
    # a window above 2^31 keeps every key its causal mask keeps
    (1, 6, 1, 300, 300, 128, True, 2 ** 32 + 16, 0.0),
    (1, 4, 2, 200, 200, 256, False, 2 ** 31 + 5, 0.0),
    # GQA groups 6, 8 and 10 at D = 256 (recurrentgemma's local attention
    # is group 10, window 2048)
    (2, 6, 1, 200, 200, 256, True, None, 0.0),
    (1, 16, 2, 200, 200, 256, True, 64, 0.0),
    (1, 10, 1, 1000, 1000, 256, True, 2048, 0.0),
    # q, k, v as the models pass them: (B, S, H, D) viewed as (B, H, S, D)
    (2, 12, 2, 300, 300, 128, True, None, 0.0, "bshd"),
    (1, 16, 16, 200, 200, 192, True, None, 0.0, "bshd"),
    (1, 10, 1, 500, 500, 256, True, 128, 0.0, "bshd"),
    (2, 8, 8, 129, 129, 64, False, None, 20.0, "bshd"),
    # rows D + 4 elements apart: no 16-byte multiple in bf16/f16
    (1, 4, 2, 150, 150, 128, True, None, 0.0, "pad"),
    (1, 4, 4, 90, 90, 256, True, 32, 0.0, "pad"),
    # windows <= 0 keep keys j > i - window: after the row (non-causal;
    # each head's last row keeps none) or none at all (causal)
    (1, 4, 2, 64, 64, 64, False, 0, 0.0),
    (1, 4, 2, 200, 300, 128, False, -3, 0.0),
    (1, 4, 2, 150, 150, 256, True, 0, 0.0),
    (1, 4, 2, 150, 150, 128, True, -3, 0.0),
    (1, 4, 2, 150, 150, 192, False, -151, 0.0),
    (1, 4, 2, 130, 130, 128, False, 0, 0.0, "pad"),
]


def _flash_inputs(case, dtype, seed):
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    layout = case[9] if len(case) > 9 else "bhsd"
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def mk(h, s):
        if layout == "bshd":
            return torch.randn((B, s, h, D), generator=g,
                               device="cuda").to(dt).transpose(1, 2)
        if layout == "pad":
            return torch.randn((B, h, s, D + 4), generator=g,
                               device="cuda").to(dt)[..., :D]
        return torch.randn((B, h, s, D), generator=g, device="cuda").to(dt)
    return mk(Hq, Sq), mk(Hkv, Skv), mk(Hkv, Skv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernel_matches_flash_ref_on_card(case, dtype):
    _need_card()
    q, k, v = _flash_inputs(case, dtype, seed=len(str(case)))
    causal, window, softcap = case[6:9]
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
    if dtype != "float32":
        # both round an f32 sum to the output type once: one ulp apart
        rtol = 1e-2 if dtype == "bfloat16" else 2e-3
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                                   rtol=rtol)
    if causal and window is not None and case[3] > case[4]:
        # top-left causal rows i >= Skv + window - 1 keep no key: exact 0
        dead = case[4] + window - 1
        assert not got[:, :, dead:].float().abs().max().item()


# (B, Hq, Hkv, Sq, Skv, D, causal, window): few keys per row, where one
# bfloat16 rounding of P shows most (about 1e-3 past half an ulp)
SPLIT_CASES = [
    (2, 4, 4, 64, 64, 64, False, None),
    (1, 4, 2, 200, 200, 128, True, None),
    (1, 4, 4, 150, 150, 192, True, None),
    (1, 8, 1, 100, 100, 256, False, None),
    (1, 10, 1, 300, 300, 256, True, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_flash_kernel_splits_p_at_bf16(case):
    """bfloat16 inputs through the tensor-core kernel against flash_ref on
    float32 copies: within half an output ulp plus 1e-4, which P rounded
    once to bfloat16 (no hi + lo split) misses."""
    _need_card()
    q, k, v = _flash_inputs(case, "bfloat16", seed=len(str(case)))
    causal, window = case[6:8]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window)
    _, e = torch.frexp(want)                 # |want| in [2^(e-1), 2^e)
    half_ulp = torch.where(want == 0, 0.0, torch.ldexp(
        torch.ones_like(want), e.clamp_min(-125) - 9))
    excess = float(((got.float() - want).abs() - half_ulp).max())
    assert excess <= 1e-4, excess


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


# -- the recurrences: rg_lru and the chunkwise mLSTM --------------------------
RG_LRU_CASES = [
    # (B, S, D, with h0)
    (2, 256, 128, True), (1, 100, 96, False), (3, 64, 32, True),
    (1, 517, 2560, True), (2, 7, 33, False), (1, 16, 1, True),
]


def _rg_lru_inputs(case, dtype, seed):
    B, S, D, with_h0 = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    x = torch.randn((B, S, D), generator=g, device="cuda").to(dt)
    a = (0.5 + 0.49 * torch.rand((B, S, D), generator=g,
                                 device="cuda")).to(dt)
    h0 = torch.randn((B, D), generator=g, device="cuda") if with_h0 else None
    return x, a, h0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", RG_LRU_CASES, ids=str)
def test_rg_lru_kernel_matches_plain_version_on_card(case, dtype):
    """Within 1e-5 on unit-scale inputs: the kernel contracts a*h + b
    into one FMA where the plain version rounds twice; a 16-bit output
    may differ from the plain one's by the last bit of its rounding."""
    _need_card()
    from repro_torch.kernels import rg_lru as rl

    x, a, h0 = _rg_lru_inputs(case, dtype, seed=len(str(case)))
    before = rc.launch_counts["rg_lru"]
    hs, hl = rl.rg_lru(x, a, h0)
    want_s, want_l = ref.rg_lru_ref(x, a, h0)
    torch.cuda.synchronize()
    assert rc.launch_counts["rg_lru"] == before + 1
    assert hs.dtype == x.dtype and hl.dtype == torch.float32
    rtol = {"float32": 0.0, "bfloat16": 2 ** -7, "float16": 2 ** -10}[dtype]
    torch.testing.assert_close(hs.float(), want_s.float(), atol=1e-5,
                               rtol=rtol)
    torch.testing.assert_close(hl, want_l, atol=1e-5, rtol=0)


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _same_bits(first, *others):
    return all(len(o) == len(first) and all(
        torch.equal(_bits(p), _bits(q)) for p, q in zip(first, o))
        for o in others)


def _offset_copy(t, elems=1):
    """A copy of ``t`` whose storage starts ``elems`` elements past an
    aligned allocation: contiguous, but not 16-byte aligned."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    out = buf[elems:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", RG_LRU_CASES, ids=str)
def test_rg_lru_routes_give_the_same_bits_on_card(case, dtype):
    """The TMA route keeps the simple route's per-element arithmetic and
    its order: its own route twice and the simple route give the same
    bits, and each launch counts on its route."""
    _need_card()
    from repro_torch.kernels import rg_lru as rl

    x, a, h0 = _rg_lru_inputs(case, dtype, seed=len(str(case)) + 1)
    route = rl.rg_lru_route(x, a)
    assert route == ("tma" if case[2] * x.element_size() % 16 == 0
                     else "simple")
    before = dict(rl.route_counts)
    first = rl.rg_lru(x, a, h0)
    again = rl.rg_lru(x, a, h0)
    simple = rl.rg_lru(x, a, h0, route="simple")
    torch.cuda.synchronize()
    assert rl.route_counts[route] == before[route] + (
        2 if route == "tma" else 3)
    assert _same_bits(first, again, simple)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rg_lru_offset_view_takes_the_simple_route_on_card(dtype):
    """Inputs that start off a 16-byte boundary cannot feed a tensor map:
    the simple route, the same bits as the TMA route on aligned copies;
    asking for the TMA route raises."""
    _need_card()
    from repro_torch.kernels import rg_lru as rl

    x, a, h0 = _rg_lru_inputs((2, 300, 2560, True), dtype, seed=3)
    xo = _offset_copy(x)
    assert rl.rg_lru_route(xo, a) == "simple"
    with pytest.raises(ValueError, match="TMA route"):
        rl.rg_lru(xo, a, h0, route="tma")
    before = rl.route_counts["simple"]
    got = rl.rg_lru(xo, a, h0)
    assert rl.route_counts["simple"] == before + 1
    assert rl.rg_lru_route(x, a) == "tma"
    want = rl.rg_lru(x, a, h0)
    torch.cuda.synchronize()
    assert _same_bits(got, want)


MLSTM_CASES = [
    # (BH, S, d, gate offsets (i, f))
    (2, 128, 64, (0.0, 2.0)), (1, 100, 32, (0.0, 2.0)),
    (4, 64, 16, (0.0, 2.0)), (1, 256, 64, (0.0, 2.0)),
    (2, 40, 512, (0.0, 2.0)), (1, 130, 512, (0.0, 2.0)),
    (2, 150, 64, (-30.0, 2.0)),       # strongly negative input gates
    (2, 150, 64, (0.0, 60.0)),        # forget gates near 1
    (1, 1, 16, (0.0, 2.0)),
]


def _mlstm_inputs(case, dtype, seed):
    BH, S, d, (i_off, f_off) = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((BH, S, d), generator=g, device="cuda").to(dt)
               for _ in range(3))
    ig = torch.randn((BH, S), generator=g, device="cuda") + i_off
    fg = torch.randn((BH, S), generator=g, device="cuda") + f_off
    return q, k, v, ig.to(dt), fg.to(dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", MLSTM_CASES, ids=str)
def test_mlstm_kernel_matches_plain_version_on_card(case, dtype):
    """float32: h within 5e-4 of max|h|, C within 1e-3, m within 1e-4
    (the JAX package's own chunkwise-vs-sequential tolerance).
    bfloat16 / float16: the kernel scales q and k in the input type as
    the Pallas wrapper does, the plain version in f32 — one rounding of
    each (2^-9 in bfloat16), so h within 1e-2 of max|h| and C, n within
    1e-2 of their largest."""
    _need_card()
    from repro_torch.kernels import mlstm as ml

    q, k, v, ig, fg = _mlstm_inputs(case, dtype, seed=len(str(case)))
    before = rc.launch_counts["mlstm_chunkwise"]
    h, (C, n, m) = ml.mlstm_chunkwise(q, k, v, ig, fg)
    hr, (Cr, nr, mr) = ref.mlstm_ref(q, k, v, ig, fg)
    torch.cuda.synchronize()
    assert rc.launch_counts["mlstm_chunkwise"] == before + 1
    assert h.dtype == q.dtype and C.dtype == torch.float32
    for t in (h, C, n, m):
        assert torch.isfinite(t.float()).all()
    f32 = dtype == "float32"
    scale = float(hr.float().abs().max()) + 1e-9
    assert float((h.float() - hr.float()).abs().max()) / scale \
        < (5e-4 if f32 else 1e-2)
    if f32:
        torch.testing.assert_close(C, Cr, atol=1e-3, rtol=1e-3)
        torch.testing.assert_close(n, nr, atol=1e-3, rtol=1e-3)
        torch.testing.assert_close(m, mr, atol=1e-4, rtol=0)
    else:
        for got, want in ((C, Cr), (n, nr)):
            top = float(want.abs().max()) + 1e-9
            assert float((got - want).abs().max()) / top < 1e-2
        torch.testing.assert_close(m, mr, atol=1e-3, rtol=1e-3)


def _mlstm_gate_share(h, q, k, v, ig, fg):
    """The largest share of the contract gate that the 16-bit ``h`` uses:
    within half an output ulp plus 1e-4 max|h| of the f32 recurrence on
    f32 copies of the kernel's own rounded, scaled q and k."""
    dt, d = q.dtype, q.shape[-1]
    s = float(torch.tensor(1.0 / d ** 0.5).to(dt))
    qs, ks = ((t.float() * s).to(dt).float() for t in (q, k))
    want, _ = ref.mlstm_ref(qs, ks, v.float(), ig, fg, scale=1.0)
    mant = 8 if dt == torch.bfloat16 else 11
    _, e = torch.frexp(want)
    half_ulp = torch.where(want == 0, 0.0, torch.ldexp(
        torch.ones_like(want), e.clamp_min(-125) - mant - 1))
    bound = half_ulp + 1e-4 * float(want.abs().max())
    return float(((h.float() - want).abs() / bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("case", MLSTM_CASES + [
    (1, 65, 64, (0.0, 2.0)), (1, 70, 1024, (0.0, 2.0)),
    (2, 300, 80, (-30.0, 60.0))], ids=str)
def test_mlstm_tensor_core_route_meets_the_contract_gate(case, dtype):
    """The tensor-core route (16-bit, d % 16 == 0): h within half an
    output ulp plus 1e-4 max|h| of the f32 recurrence on the kernel's
    own rounded, scaled q and k — what the hi + lo pairs of C, W and
    k * u buy."""
    _need_card()
    from repro_torch.kernels import mlstm as ml

    q, k, v, ig, fg = _mlstm_inputs(case, dtype, seed=len(str(case)) + 1)
    assert ml.tensor_core_route(q, k, v)
    BH, S, d = case[:3]
    assert ml.scratch_floats(BH, S, d) \
        == ml.LIBRARY.lib().mlstm_tc_scratch_floats(BH, S, d)
    h, _ = ml.mlstm_chunkwise(q, k, v, ig, fg)
    torch.cuda.synchronize()
    assert _mlstm_gate_share(h, q, k, v, ig, fg) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["d=24", "d=8", "unaligned", "float32"])
def test_mlstm_fma_route_cases(what):
    """Each case the wrapper's rule sends to the FMA kernel: a head dim
    that is no multiple of 16, q, k, v off a 16-byte boundary, float32;
    the 16-bit ones within the contract gate too."""
    _need_card()
    from repro_torch.kernels import mlstm as ml

    d = {"d=24": 24, "d=8": 8}.get(what, 64)
    dtype = "float32" if what == "float32" else "bfloat16"
    q, k, v, ig, fg = _mlstm_inputs((2, 150, d, (0.0, 2.0)), dtype, seed=9)
    if what == "unaligned":
        q, k, v = (torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:]
                   .view(t.shape) for t in (q, k, v))
    assert not ml.tensor_core_route(q, k, v)
    h, (C, n, m) = ml.mlstm_chunkwise(q, k, v, ig, fg)
    hr, (Cr, nr, mr) = ref.mlstm_ref(q, k, v, ig, fg)
    torch.cuda.synchronize()
    top = float(hr.float().abs().max())
    if dtype == "float32":
        assert float((h - hr).abs().max()) / top < 5e-4
        torch.testing.assert_close(C, Cr, atol=1e-3, rtol=1e-3)
    else:
        assert _mlstm_gate_share(h, q, k, v, ig, fg) <= 1.0
    torch.testing.assert_close(m, mr, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "strided", "wide rows"])
def test_decode_rows_streaming_copy_on_card(layout):
    """decode_rows bit-equal to its plain version on the flat path (a
    contiguous block), the strided path (row stride 2 x 128 B, a ragged
    last tile) and rows wider than one tile of 32 KiB."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    m, W, stride = {"contiguous": (100_003, 128, 128),
                    "strided": (70_001, 128, 256),
                    "wide rows": (5, 49_152, 49_152 + 64)}[layout]
    buf = torch.randint(0, 256, (m, stride), generator=g, device="cuda",
                        dtype=torch.uint8)
    block = buf[:, :W] if stride != W else buf
    for dt in (torch.float32, torch.bfloat16, torch.uint8, torch.float64):
        got = rc.decode_rows(block, nbytes=W, dtype=dt)
        want = ref.reloc_decode_rows_ref(block, nbytes=W, dtype=dt)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(
            got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
def test_recurrence_kernels_refuse_what_they_do_not_take():
    _need_card()
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import rg_lru as rl

    x = torch.zeros((1, 4, 8), device="cuda")
    with pytest.raises(ValueError):                  # mixed dtypes
        rl.rg_lru(x, x.bfloat16())
    with pytest.raises(ValueError):                  # h0 not float32
        rl.rg_lru(x, x, torch.zeros((1, 8), device="cuda").half())
    q = torch.zeros((2, 4, 2048), device="cuda")
    g = torch.zeros((2, 4), device="cuda")
    with pytest.raises(ValueError):                  # head dim > 1024
        ml.mlstm_chunkwise(q, q, q, g, g)
    q = torch.zeros((2, 4, 64), device="cuda")
    with pytest.raises(ValueError):                  # gate shape
        ml.mlstm_chunkwise(q, q, q, g[:, :3], g[:, :3])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "xlstm_350m"])
def test_recurrent_model_fused_matches_composite_on_card(arch):
    """Two layers of each family (head dim 64 for the flash kernel),
    float32 compute: the fused prefill through the kernels and the
    composite one through the plain versions agree within 1e-3, and so
    do 4 decode steps from each state."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models import zoo
    from repro_torch.models.parallel import Parallel

    n_layers = 3 if arch == "recurrentgemma_2b" else 2
    cfg = get_config(arch).reduced(n_layers=n_layers, head_dim=64,
                                   dtype="float32")
    par = Parallel()
    params = zoo.init_params(cfg, 0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=g,
                           device="cuda", dtype=torch.int32)
    before = dict(rc.launch_counts)
    st_f, lg_f = T.prefill_forward(params, cfg, par, {"tokens": tokens},
                                   128, impl="fused")
    kernel = "rg_lru" if arch == "recurrentgemma_2b" else "mlstm_chunkwise"
    assert rc.launch_counts[kernel] > before[kernel]
    st_c, lg_c = T.prefill_forward(params, cfg, par, {"tokens": tokens},
                                   128, impl="composite")
    torch.testing.assert_close(lg_f, lg_c, atol=1e-3, rtol=1e-3)
    for a, b in zip(pytree.tree_leaves(st_f), pytree.tree_leaves(st_c)):
        torch.testing.assert_close(a.float(), b.float(), atol=1e-3,
                                   rtol=1e-3)
    tok = lg_f.argmax(-1)[:, None].to(torch.int32)
    for _ in range(4):
        st_f, lf = T.decode_step(params, cfg, par, st_f, tok)
        st_c, lc = T.decode_step(params, cfg, par, st_c, tok)
        torch.testing.assert_close(lf, lc, atol=1e-3, rtol=1e-3)
        tok = lf.argmax(-1)[:, None].to(torch.int32)


# -- the MoE dispatch: gather_rows and moe_combine ----------------------------
# (N, M, D): aligned and unaligned rows, repeated indices, M = 0, N = 1
GATHER_CASES = [(300, 500, 2048), (50, 64, 24), (37, 100, 13), (1, 9, 24),
                (20, 0, 24), (4097, 2048, 2048)]
# (T, K, S, D): K = 1 and 8, unaligned D
COMBINE_CASES = [(200, 6, 640, 2048), (33, 1, 40, 24), (50, 8, 400, 24),
                 (17, 6, 60, 13), (4, 6, 256, 2048)]


def _ulp(x, dtype):
    """One unit in the last place of ``x`` in ``dtype`` (as f32)."""
    bits = {"bfloat16": 8, "float16": 11}[dtype]
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -14)))
    return torch.exp2(e - (bits - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_moe_kernels_match_plain_versions_on_card(dtype):
    _need_card()
    from repro_torch.kernels import moe_dispatch as md

    g = torch.Generator(device="cuda").manual_seed(5)
    dt = getattr(torch, dtype)
    for N, M, D in GATHER_CASES:
        x = torch.randn((N, D), generator=g, device="cuda").to(dt)
        idx = torch.randint(0, N, (M,), generator=g, device="cuda",
                            dtype=torch.int32)
        before = rc.launch_counts["gather_rows"]
        got = md.gather_rows(x, idx)
        torch.cuda.synchronize()
        assert rc.launch_counts["gather_rows"] == before + (M > 0)
        assert torch.equal(got, ref.gather_rows_ref(x, idx))
    for Tn, K, S, D in COMBINE_CASES:
        y = torch.randn((S, D), generator=g, device="cuda").to(dt)
        w = torch.rand((Tn, K), generator=g, device="cuda")
        for lo in (-1, -S):                      # some dropped; all dropped
            slots = torch.randint(lo, S, (Tn, K), generator=g,
                                  device="cuda", dtype=torch.int32)
            if lo == -S:
                slots = slots.clamp(max=-1)
            got = md.moe_combine(y, slots, w)
            want = ref.moe_combine_ref(y, slots, w)
            torch.cuda.synchronize()
            assert got.dtype == dt and torch.isfinite(got.float()).all()
            err = (got.float() - want.float()).abs()
            # the f32 sums differ by their order: 1e-6 of the row's
            # largest term; a 16-bit output adds one ulp of its rounding
            ok = slots >= 0
            terms = (w[:, :, None] * y[slots.clamp(min=0).long()].float()
                     * ok[:, :, None]).abs().amax(dim=(1, 2))
            tol = 1e-6 * terms[:, None]
            if dtype != "float32":
                tol = tol + _ulp(torch.maximum(got.float().abs(),
                                               want.float().abs()), dtype)
            assert (err <= tol).all()


# (T, K, S, D): every combine case, and K = 16 and token counts on both
# sides of moe_dispatch.RING_MIN_TOKENS
COMBINE_ROUTE_CASES = COMBINE_CASES + [(300, 6, 640, 2048),
                                       (100, 16, 900, 512),
                                       (300, 16, 900, 512),
                                       (3, 16, 100, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", COMBINE_ROUTE_CASES, ids=str)
def test_moe_combine_routes_give_the_same_bits_on_card(case, dtype):
    """Every route sums the same products in the same order with the
    same roundings: its own route twice and every route the inputs allow
    give the same bits (some slots dropped, and every slot dropped)."""
    _need_card()
    from repro_torch.kernels import moe_dispatch as md

    Tn, K, S, D = case
    g = torch.Generator(device="cuda").manual_seed(Tn * 31 + K)
    dt = getattr(torch, dtype)
    y = torch.randn((S, D), generator=g, device="cuda").to(dt)
    w = torch.rand((Tn, K), generator=g, device="cuda")
    for lo in (-1, -S):
        slots = torch.randint(lo, S, (Tn, K), generator=g, device="cuda",
                              dtype=torch.int32)
        if lo == -S:
            slots = slots.clamp(max=-1)
        route = md.combine_route(y, slots)
        assert route == ("simple" if D * y.element_size() % 16
                         else "bulk" if Tn >= md.RING_MIN_TOKENS
                         else "registers")
        before = dict(md.combine_route_counts)
        first = md.moe_combine(y, slots, w)
        others = [md.moe_combine(y, slots, w)] + [
            md.moe_combine(y, slots, w, route=r) for r in md.COMBINE_ROUTES
            if route != "simple" or r == "simple"]
        torch.cuda.synchronize()
        assert md.combine_route_counts[route] == before[route] + 3
        assert _same_bits((first,), *((o,) for o in others))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_combine_offset_view_takes_the_simple_route_on_card(dtype):
    """Expert outputs that start off a 16-byte boundary cannot take
    16-byte copies: the simple route, the same bits as the chunked routes
    on an aligned copy; asking for a chunked route raises."""
    _need_card()
    from repro_torch.kernels import moe_dispatch as md

    g = torch.Generator(device="cuda").manual_seed(9)
    y = torch.randn((640, 2048), generator=g, device="cuda").to(
        getattr(torch, dtype))
    w = torch.rand((300, 6), generator=g, device="cuda")
    slots = torch.randint(-1, 640, (300, 6), generator=g, device="cuda",
                          dtype=torch.int32)
    yo = _offset_copy(y)
    assert md.combine_route(yo, slots) == "simple"
    for r in ("bulk", "registers"):
        with pytest.raises(ValueError, match=f"{r} route"):
            md.moe_combine(yo, slots, w, route=r)
    before = md.combine_route_counts["simple"]
    got = md.moe_combine(yo, slots, w)
    assert md.combine_route_counts["simple"] == before + 1
    want = [md.moe_combine(y, slots, w, route=r)
            for r in ("bulk", "registers")]
    torch.cuda.synchronize()
    assert _same_bits((got,), *((o,) for o in want))


@pytest.mark.cuda
def test_moe_kernels_refuse_what_they_do_not_take():
    _need_card()
    from repro_torch.kernels import moe_dispatch as md

    x = torch.zeros((4, 8), device="cuda")
    with pytest.raises(ValueError):                  # int64 indices
        md.gather_rows(x, torch.zeros(3, dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError):                  # 1-byte elements
        md.gather_rows(x.to(torch.uint8),
                       torch.zeros(3, dtype=torch.int32, device="cuda"))
    slots = torch.zeros((2, 17), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):                  # K > 16
        md.moe_combine(x, slots, slots.float())
    with pytest.raises(ValueError):                  # float64 y
        md.moe_combine(x.double(), slots[:, :4], slots[:, :4].float())


@pytest.mark.cuda
def test_deepseek_fused_matches_composite_on_card():
    """Reduced deepseek-v2-lite (a dense first layer and one MLA + MoE
    layer) with qk 128 + 64, so MLA's flash launch runs at head dim 192,
    float32 compute: the fused prefill (flash, gather_rows, moe_combine)
    and the composite one agree within 1e-3, and so do 4 decode steps
    from each state on their own backends."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models import zoo
    from repro_torch.models.parallel import Parallel

    cfg = get_config("deepseek_v2_lite_16b").reduced(
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, dtype="float32")
    par = Parallel()
    params = zoo.init_params(cfg, 0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=g,
                           device="cuda", dtype=torch.int32)
    before = dict(rc.launch_counts)
    st_f, lg_f = T.prefill_forward(params, cfg, par, {"tokens": tokens},
                                   128, impl="fused")
    torch.cuda.synchronize()
    for name, n in (("flash_attention", cfg.n_layers), ("gather_rows", 1),
                    ("moe_combine", 1)):
        assert rc.launch_counts[name] == before[name] + n, name
    st_c, lg_c = T.prefill_forward(params, cfg, par, {"tokens": tokens},
                                   128, impl="composite")
    torch.testing.assert_close(lg_f, lg_c, atol=1e-3, rtol=1e-3)
    for a, b in zip(pytree.tree_leaves(st_f), pytree.tree_leaves(st_c)):
        torch.testing.assert_close(a.float(), b.float(), atol=1e-3,
                                   rtol=1e-3)
    tok = lg_f.argmax(-1)[:, None].to(torch.int32)
    for _ in range(4):
        st_f, lf = T.decode_step(params, cfg, par, st_f, tok, impl="fused")
        st_c, lc = T.decode_step(params, cfg, par, st_c, tok,
                                 impl="composite")
        torch.testing.assert_close(lf, lc, atol=1e-3, rtol=1e-3)
        tok = lf.argmax(-1)[:, None].to(torch.int32)


# ---------------------------------------------------------------------------
# the paper's workloads on the card: the accumulator's sums are fixed-order,
# and each app equals its CPU run
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_segment_accept_gives_the_same_bits_twice_on_card(dtype):
    _need_card()
    from repro_torch.core import segment_accept

    rng = np.random.default_rng(3)
    partials = torch.from_numpy(
        rng.standard_normal((4, 200_000, 3)).astype(dtype))
    ids = torch.from_numpy(rng.integers(-1, 65, 200_000))
    a = segment_accept(partials.cuda(), ids.cuda(), 64)
    b = segment_accept(partials.cuda(), ids.cuda(), 64)
    assert torch.equal(a, b)
    want = segment_accept(partials, ids, 64)
    tol = 1e-9 if dtype == "float64" else 1e-3
    torch.testing.assert_close(a.cpu(), want, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_accumulator_totals_give_the_same_bits_twice_on_card():
    _need_card()
    from repro_torch.core import Accumulator, LongRange

    def run():
        acc = Accumulator(LongRange(0, 5000), (3,), device="cuda")
        g = torch.Generator(device="cuda").manual_seed(0)
        for _ in range(6):
            acc.grain().copy_(torch.randn(5000, 3, generator=g,
                                          device="cuda", dtype=torch.float64))
        return acc.totals()

    assert torch.equal(run(), run())


@pytest.mark.cuda
def test_apps_on_card_match_their_cpu_runs():
    _need_card()
    from repro_torch.apps import KMeans, MolDyn, PlhamSim
    from repro_torch.core import GLBConfig

    kms = [KMeans(n_places=4, n_points=4096, k=8, seed=1, speeds=(1, 1, 1, 3),
                  glb=GLBConfig(period=2, transport="device"), device=dev)
           for dev in ("cuda", "cpu")]
    before = dict(rc.launch_counts)
    for _ in range(6):
        for km in kms:
            km.iterate()
    for km in kms:
        km.finish()
    assert rc.launch_counts["reloc_encode_pack"] > before["reloc_encode_pack"]
    torch.testing.assert_close(kms[0].centroids.cpu(), kms[1].centroids,
                               atol=1e-9, rtol=0)
    mds = [MolDyn(n_places=4, n_particles=343, ndivide=5, seed=2, device=dev)
           for dev in ("cuda", "cpu")]
    for _ in range(3):
        for md in mds:
            md.step()
    torch.testing.assert_close(mds[0].positions().cpu(), mds[1].positions(),
                               atol=0, rtol=1e-10)
    assert mds[0].allreduce_bytes == mds[1].allreduce_bytes
    sims = [PlhamSim(6, n_agents=400, strategy="level_extremes",
                     speeds=(1, 1, 1, 1, 1, 3), lb_period=5, seed=1,
                     device=dev) for dev in ("cuda", "cpu")]
    for sim in sims:
        sim.run(30)
    assert sims[0].relocated == sims[1].relocated > 0
    for a, b in zip(sims[0].distribution_history,
                    sims[1].distribution_history):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(sims[0].sim_time, sims[1].sim_time,
                               rtol=1e-12)



# -- the flash backward ------------------------------------------------------
# (B, Hq, Hkv, Sq, Skv, D, causal, window, softcap[, layout])
FLASH_BWD_CASES = [
    (2, 4, 4, 200, 200, 64, True, None, 0.0),
    (1, 12, 2, 257, 257, 128, False, None, 0.0),
    (1, 12, 2, 300, 300, 128, True, 100, 50.0),
    (1, 6, 1, 129, 200, 128, True, None, 0.0),
    (1, 8, 2, 200, 200, 64, False, 0, 0.0),
    (1, 8, 2, 200, 200, 128, True, -3, 0.0),
    (2, 12, 2, 300, 300, 128, True, None, 0.0, "bshd"),
]


def _rel_l2(a, b):
    return float((a.float() - b).norm() / b.norm().clamp_min(1e-30))


def _bwd_expected_route(dtype, layout):
    return "fma" if dtype == "float32" or layout == "pad" else "tensor_core"


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=str)
def test_flash_backward_kernel_matches_flash_bwd_ref_on_card(case, dtype,
                                                             rows):
    """Every case on both routes: bfloat16 / float16 with aligned rows
    take the tensor-core kernels, float32 and rows whose stride is no
    16-byte multiple (``"pad"`` views) the FMA kernels."""
    _need_card()
    if rows == "unaligned":
        case = case[:9] + ("pad",)
    layout = case[9] if len(case) > 9 else "bhsd"
    q, k, v = _flash_inputs(case, dtype, seed=len(str(case)))
    do = _flash_inputs(case, dtype, seed=len(str(case)) + 1)[0]
    kw = dict(zip(("causal", "window", "softcap"), case[6:9]))
    out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    o_ref, lse_ref = ref.flash_ref(q, k, v, return_lse=True, **kw)
    live = torch.isfinite(lse_ref)
    assert torch.equal(live, torch.isfinite(lse))
    if live.any():
        assert float((lse[live] - lse_ref[live]).abs().max()) <= 1e-5
    before = rc.launch_counts["flash_attention_bwd"]
    routes = dict(fa.bwd_route_counts)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert rc.launch_counts["flash_attention_bwd"] == before + 2
    route = _bwd_expected_route(dtype, layout)
    assert {r: n - routes[r] for r, n in fa.bwd_route_counts.items()} \
        == {r: 2 * (r == route) for r in routes}
    want = ref.flash_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                             lse, do.float(), **kw)
    plain = ref.flash_bwd_ref(q, k, v, out, lse, do, **kw)
    for name, a, a2, w, p in zip("qkv", got, again, want, plain):
        assert a.dtype == q.dtype and a.shape == w.shape, name
        assert torch.equal(a, a2), f"d{name} differs between two launches"
        if dtype == "float32":
            tol = 1e-4 * max(float(w.abs().max()), 1e-30)
            torch.testing.assert_close(a, w, atol=tol, rtol=0)
        else:
            assert _rel_l2(a, w) <= 1.25 * _rel_l2(p, w) + 1e-7, name
            # each element within half an output ulp of the f32 result
            # plus 1e-4 of the largest (a 16-bit P or dS inside the
            # kernel lands ~1e-3 beyond)
            _, e = torch.frexp(w)
            lo, bits = {"bfloat16": (-125, 9), "float16": (-13, 12)}[dtype]
            half_ulp = torch.where(w == 0, 0.0, torch.ldexp(
                torch.ones_like(w), e.clamp_min(lo) - bits))
            excess = (a.float() - w).abs() - half_ulp
            assert float(excess.max()) <= 1e-4 * float(w.abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bshd", "pad"])
def test_flash_gradients_reach_q_k_v_on_card(layout):
    """Autograd through ``FlashAttention`` on both routes: aligned
    (B, S, H, D) views take the tensor-core backward, ``"pad"`` views
    the FMA one."""
    _need_card()
    q, k, v = (t.requires_grad_() for t in _flash_inputs(
        (1, 12, 2, 300, 300, 128, True, None, 0.0, layout), "bfloat16", 3))
    before = dict(rc.launch_counts)
    routes = dict(fa.bwd_route_counts)
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.requires_grad and out.grad_fn is not None
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert rc.launch_counts["flash_attention"] == before["flash_attention"] + 1
    assert rc.launch_counts["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    route = _bwd_expected_route("bfloat16", layout)
    assert fa.bwd_route_counts[route] == routes[route] + 1
    for t in (q, k, v):
        assert t.grad is not None and t.grad.shape == t.shape
        assert torch.isfinite(t.grad.float()).all() and t.grad.abs().max() > 0
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
    with pytest.raises(ValueError, match="ROADMAP"):     # no D = 256 yet
        x = torch.zeros((1, 2, 8, 256), device="cuda", dtype=torch.bfloat16)
        fa.flash_attention_bwd(x, x, x, x, torch.zeros((1, 2, 8),
                                                       device="cuda"), x)


@pytest.mark.cuda
def test_kernels_without_backward_refuse_autograd_on_card():
    """rg_lru, mlstm_chunkwise, gather_rows and moe_combine have no
    backward kernel yet: under autograd their outputs would cut the
    graph, so they raise (on the CPU their plain versions, which autograd
    follows, run instead)."""
    _need_card()
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import rg_lru as rl

    dev = "cuda"
    x = torch.rand((1, 8, 16), device=dev, requires_grad=True)
    a = torch.rand((1, 8, 16), device=dev) * 0.5 + 0.25
    q = torch.randn((2, 16, 16), device=dev, requires_grad=True)
    gate = torch.randn((2, 16), device=dev)
    y = torch.randn((6, 8), device=dev, requires_grad=True)
    idx = torch.arange(4, dtype=torch.int32, device=dev)
    slots = torch.zeros((3, 2), dtype=torch.int32, device=dev)
    w = torch.ones((3, 2), device=dev)
    calls = [lambda: rl.rg_lru(x, a),
             lambda: ml.mlstm_chunkwise(q, q, q, gate, gate),
             lambda: md.gather_rows(y, idx),
             lambda: md.moe_combine(y, slots, w)]
    for call in calls:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_train_step_fused_matches_composite_on_card():
    """A reduced qwen2 (head dim 64, float32 compute) train step on the
    card: the gradients through the flash kernels and through autograd of
    flash_ref agree within 1e-4 in relative L2 leaf by leaf (the key bias,
    whose exact gradient is 0, against the whole gradient's norm), and
    three steps lower the loss."""
    _need_card()
    from repro_torch.models import transformer as T
    from repro_torch.models import zoo
    from repro_torch.models.parallel import Parallel
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.serving.decode import serving_config
    from repro_torch.train import build_train_step

    cfg = dataclasses.replace(serving_config(), head_dim=64,
                              dtype="float32", loss_chunk=50,
                              remat="full")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=g,
                           device="cuda", dtype=torch.int32)
    grads = {}
    for impl in ("fused", "composite"):
        params = zoo.init_params(cfg, 0, device="cuda")
        leaves, spec = pytree.tree_flatten(params)
        for t in leaves:
            t.requires_grad_(True)
        before = dict(rc.launch_counts)
        loss, _ = T.train_loss(params, cfg, Parallel(), {"tokens": tokens},
                               impl=impl)
        grads[impl] = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        n = cfg.n_layers if impl == "fused" else 0
        assert rc.launch_counts["flash_attention_bwd"] == \
            before["flash_attention_bwd"] + n
        assert rc.launch_counts["flash_attention"] == \
            before["flash_attention"] + 2 * n
    total = float(torch.sqrt(sum(x.square().sum()
                                 for x in grads["composite"])))
    paths = [str(p) for p, _ in pytree.tree_flatten_with_path(params)[0]]
    for path, a, b in zip(paths, grads["fused"], grads["composite"]):
        if "'wk'" in path and "'b'" in path:
            assert float((a - b).norm()) <= 1e-4 * total, path
        else:
            assert _rel_l2(a, b) <= 1e-4, path
    params = zoo.init_params(cfg, 0, device="cuda")
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    step, _, _ = build_train_step(cfg, Parallel(), opt, impl="fused")
    state = adamw_init(params, opt)
    losses = []
    for _ in range(3):
        params, state, m = step(params, state, {"tokens": tokens})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
