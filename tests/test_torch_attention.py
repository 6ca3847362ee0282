"""Attention of the PyTorch port against the JAX package.

The same inputs, made from a numpy seed, go through the port's
``kernels.ops.attention`` (on CPU tensors: the flash kernel's plain
version ``flash_ref``, under both ``fused`` and ``composite``) and
through the JAX package's Pallas ``flash_attention`` in interpret mode
and its ``attention_ref``.  Cases cover causal and non-causal masks, a
sliding window, a softcap, GQA groups 1 / 2 / 4, ``Sq != Skv``, lengths
that are not block multiples and fully masked rows.  ``attention_flops``
(the kernel's bound) is held against a brute-force count of the mask,
and a plain emulation of the tensor-core kernel's arithmetic (bf16
products summed in f32, P split into bf16 hi + lo, each P V product in
f32) against ``flash_ref``.  The backward: ``flash_bwd_ref`` (the
backward kernel's plain version) and autograd through ``FlashAttention``
on CPU tensors against ``jax.grad`` of the JAX package's
``attention_ref`` (causal, windows 0 and -3, softcap, GQA) at float32
within ``1e-5`` of the largest gradient element, and a plain emulation
of the tensor-core backward's arithmetic (bf16 products summed in f32,
P and dS split into bf16 hi + lo, dK/dV group partials summed in head
order) within half a bf16 ulp plus ``1e-4`` of the largest element of
``jax.grad``, where one bf16 rounding of P and dS lands ~1e-3 beyond.

Tolerances: float32 ``1e-5`` (the two packages sum in f32 in another
order); bfloat16 ``2e-2`` absolute and relative (both round the f32
result to bfloat16 once, and their inputs to the products differ by
rounding only where the JAX kernel upcasts blocks).
"""
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.cuda_build import launch_counts

# (B, Hq, Hkv, Sq, Skv, D, causal, window, softcap)
CASES = [
    (1, 2, 2, 40, 40, 16, True, None, 0.0),          # group 1, causal
    (2, 4, 2, 37, 37, 16, False, None, 0.0),         # group 2, ragged
    (1, 8, 2, 70, 70, 32, True, 16, 0.0),            # group 4, window
    (1, 4, 4, 50, 50, 16, True, None, 20.0),         # softcap
    (1, 4, 1, 24, 61, 16, True, None, 0.0),          # Sq < Skv
    (1, 4, 2, 61, 24, 16, False, 8, 5.0),            # Sq > Skv, window
    (2, 4, 2, 90, 30, 16, True, 12, 0.0),            # rows >= 41 masked
    (1, 2, 1, 1, 33, 32, True, None, 0.0),           # Sq = 1
]
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}


def _inputs(case, dtype, seed):
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    rng = np.random.default_rng(seed)
    mk = lambda h, s: rng.standard_normal((B, h, s, D)).astype(np.float32)
    q, k, v = mk(Hq, Sq), mk(Hkv, Skv), mk(Hkv, Skv)
    if dtype == "bfloat16":
        # round once on the host, so both packages see the same bits
        q, k, v = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    return q, k, v


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("impl", ["fused", "composite"])
def test_port_attention_matches_jax(case, dtype, impl):
    q, k, v = _inputs(case, dtype, seed=len(str(case)))
    causal, window, softcap = case[6:]
    got = ops.attention(_torch(q), _torch(k), _torch(v), causal=causal,
                        window=window, softcap=softcap, impl=impl)
    assert got.dtype == _torch(q).dtype and tuple(got.shape) == q.shape
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(jflash(jq, jk, jv, causal=causal, window=window,
                               softcap=softcap, block_q=32, block_k=32,
                               interpret=True)).astype(np.float32)
    dense = np.asarray(jref.attention_ref(
        jq, jk, jv, causal=causal, window=window,
        softcap=softcap)).astype(np.float32)
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(_np(got), pallas, atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(got), dense, atol=atol, rtol=rtol)
    if causal and window is not None and case[3] > case[4]:
        dead = case[4] + window - 1          # rows keeping no key: exact 0
        assert not np.abs(_np(got)[:, :, dead:]).max()


@pytest.mark.parametrize("case", CASES[:4], ids=str)
def test_port_flash_ref_matches_jax_flash_ref(case):
    """The port's blocked plain version against the JAX package's, at
    a block size that splits the sequence (causal windows included)."""
    q, k, v = _inputs(case, "float32", seed=7)
    causal, window, softcap = case[6:]
    got = ref.flash_ref(_torch(q), _torch(k), _torch(v), causal=causal,
                        window=window, softcap=softcap, block_q=16)
    want = np.asarray(jref.flash_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window, softcap=softcap,
                                     block_q=16))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_attention_ref_matches_dense_jax():
    q, k, v = _inputs(CASES[2], "float32", seed=3)
    got = ref.attention_ref(_torch(q), _torch(k), _torch(v), causal=True,
                            window=16)
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True,
                                         window=16))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    q, k, v = (_torch(a) for a in _inputs(CASES[0], "float32", seed=1))
    n0 = launch_counts["flash_attention"]
    out = fa.flash_attention(q, k, v)
    assert launch_counts["flash_attention"] == n0
    assert fa.LIBRARY._lib is None or torch.cuda.is_available()
    torch.testing.assert_close(out, ref.flash_ref(q, k, v))


def test_attention_flops_counts_kept_pairs():
    # causal 4x4: 10 pairs; window 2: 7 pairs; 2 * 2 operations per pair
    # and head dim for both products
    assert fa.attention_flops(1, 1, 4, 4, 8, causal=True,
                              window=None) == 4 * 8 * 10
    assert fa.attention_flops(1, 1, 4, 4, 8, causal=True,
                              window=2) == 4 * 8 * 7
    assert fa.attention_flops(2, 3, 4, 6, 8, causal=False,
                              window=None) == 4 * 2 * 3 * 8 * 24


# (B, Hq, Sq, Skv, D, causal, window)
FLOPS_CASES = [
    (1, 2, 61, 24, 16, True, 8),         # Skv < Sq, window
    (1, 2, 61, 24, 16, False, 8),        # window without causal
    (1, 4, 24, 61, 16, True, None),      # Sq < Skv
    (2, 3, 90, 30, 16, True, 12),        # rows >= 41 keep no key
    (1, 1, 1, 33, 32, True, None),       # Sq = 1
    (2, 10, 300, 300, 256, True, 128),   # recurrentgemma-like: group 10,
    (1, 10, 257, 257, 256, True, 300),   # window < Sq and window > Sq
    (1, 2, 40, 40, 16, False, 0),        # window 0: keys after the row
    (1, 2, 40, 50, 16, False, -3),       # window < 0
    (1, 2, 40, 40, 16, True, 0),         # causal, window <= 0: no key
    (1, 2, 40, 40, 16, True, -3),
]


@pytest.mark.parametrize("case", FLOPS_CASES, ids=str)
def test_attention_flops_matches_a_brute_force_mask_count(case):
    B, Hq, Sq, Skv, D, causal, window = case
    kept = sum(1 for i in range(Sq) for j in range(Skv)
               if (not causal or j <= i)
               and (window is None or j > i - window))
    assert fa.attention_flops(B, Hq, Sq, Skv, D, causal=causal,
                              window=window) == 4 * B * Hq * D * kept


# (B, Hq, Hkv, Sq, Skv, D, causal, window): a window <= 0 keeps keys
# j > i - window, after the row (non-causal) or none (causal)
NONPOS_WINDOW_CASES = [
    (1, 4, 2, 64, 64, 16, False, 0),     # each head's last row: no key
    (1, 4, 2, 64, 64, 16, False, -3),
    (2, 2, 1, 30, 45, 32, False, 0),     # Skv > Sq
    (1, 4, 2, 64, 64, 16, True, 0),      # causal: every row gives 0
    (1, 4, 2, 64, 64, 16, True, -3),
]


@pytest.mark.parametrize("case", NONPOS_WINDOW_CASES, ids=str)
def test_flash_attention_window_nonpositive_matches_jax(case):
    """CPU tensors through ``flash_attention`` at windows 0 and -3 against
    the JAX package's dense ``attention_ref`` (f32, within 1e-5): the
    window is a mask like any other, not "no keys"."""
    q, k, v = _inputs(case, "float32", seed=11)
    causal, window = case[6:8]
    got = fa.flash_attention(_torch(q), _torch(k), _torch(v),
                             causal=causal, window=window)
    want = np.asarray(jref.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    Sq, Skv = case[3], case[4]
    live = [i for i in range(Sq) if not causal and i - window < Skv - 1]
    assert bool(np.abs(want[:, :, live]).max(axis=-1).all()) \
        if live else not np.abs(want).max()


def _emulate_tensor_core_path(q, k, v, *, causal, window, block_k, split):
    """The bf16 tensor-core kernel's arithmetic in plain f32: per key
    tile, S = Q K^T from bf16 inputs summed in f32, the online softmax in
    f32 with masked lanes at the mask value and then 0, P rounded to bf16
    as ``hi`` (and, with ``split``, the residual as ``lo``), each
    product with V summed in f32; O / l where l > 0."""
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    group = Hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    mask_value = torch.tensor(-0.7 * torch.finfo(torch.float32).max)
    m = torch.full((B, Hq, Sq, 1), -math.inf)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, D))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, block_k):
        cols = torch.arange(k0, min(k0 + block_k, Skv))[None, :]
        keep = torch.ones(Sq, cols.shape[1], dtype=torch.bool)
        if causal:
            keep &= cols <= rows
        if window is not None:
            keep &= cols > rows - window
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2) / math.sqrt(D)
        s = torch.where(keep, s, mask_value)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(keep, torch.exp(s - m_new), torch.tensor(0.0))
        l = alpha * l + p.sum(-1, keepdim=True)
        m = m_new
        hi = p.to(q.dtype).float()
        pv = hi @ vf[:, :, k0:k0 + block_k]
        if split:
            lo = (p - hi).to(q.dtype).float()
            pv = pv + lo @ vf[:, :, k0:k0 + block_k]
        acc = acc * alpha + pv
    return torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)


# (B, Hq, Hkv, Sq, Skv, D, causal, window, block_k): the kernel's key
# tile is 128 at D <= 128 and 64 at D = 192 and 256
EMULATION_CASES = [
    (1, 2, 2, 200, 200, 64, True, None, 128),
    (1, 4, 2, 257, 257, 128, True, None, 128),
    (2, 6, 1, 129, 300, 128, False, None, 128),
    (1, 4, 4, 200, 200, 192, True, None, 64),
    (1, 10, 1, 300, 300, 256, True, 128, 64),
]


@pytest.mark.parametrize("case", EMULATION_CASES, ids=str)
def test_split_p_arithmetic_contract_stays_at_f32_accuracy(case):
    """The arithmetic contract of the bf16 tensor-core kernel, emulated
    here in plain f32 (not the kernel itself): with P split into bf16
    hi + lo, the result stays as close to flash_ref's f32 P V as the f32
    kernel (1e-4); one bf16 rounding of P lands several times further
    out.  The kernel's own check of the split is
    ``test_flash_kernel_splits_p_at_bf16`` in ``test_torch_cuda.py``,
    on the card."""
    q, k, v = (_torch(a) for a in _inputs(case, "bfloat16", seed=11))
    causal, window, block_k = case[6:]
    want = ref.flash_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window)
    kw = dict(causal=causal, window=window, block_k=block_k)
    split = _emulate_tensor_core_path(q, k, v, split=True, **kw)
    single = _emulate_tensor_core_path(q, k, v, split=False, **kw)
    torch.testing.assert_close(split, want, atol=2e-2, rtol=2e-2)
    err_split = float((split - want).abs().max())
    err_single = float((single - want).abs().max())
    assert err_split < 1e-4 < err_single, (err_split, err_single)


# (B, Hq, Hkv, Sq, Skv, D, causal, window, softcap): the masks the
# backward kernel takes, windows 0 and -3 (keys after the row, or none)
# among them
BWD_CASES = CASES[:7] + [
    (1, 4, 2, 30, 30, 16, False, 0, 0.0),
    (1, 4, 2, 30, 30, 16, False, -3, 0.0),
    (1, 6, 2, 33, 33, 16, True, -3, 0.0),            # no key: zero grad
    (1, 6, 3, 45, 45, 16, True, 9, 7.0),
]


def _jax_attention_grads(q, k, v, do, causal, window, softcap):
    def f(q, k, v):
        out = jref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
        return jnp.sum(out * do)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_backward_matches_jax_grad(case):
    q, k, v = _inputs(case, "float32", seed=21)
    causal, window, softcap = case[6:]
    do = np.random.default_rng(22).standard_normal(q.shape) \
        .astype(np.float32)
    want = _jax_attention_grads(q, k, v, do, causal, window, softcap)
    kw = dict(causal=causal, window=window, softcap=softcap)
    tq, tk, tv = (_torch(a) for a in (q, k, v))
    out, lse = ref.flash_ref(tq, tk, tv, return_lse=True, block_q=16, **kw)
    plain = ref.flash_bwd_ref(tq, tk, tv, out, lse, torch.from_numpy(do),
                              block_q=16, **kw)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    got = fa.flash_attention(*leaves, **kw)
    assert got.grad_fn is not None
    auto = torch.autograd.grad(got, leaves, torch.from_numpy(do))
    for name, p, a, w in zip("qkv", plain, auto, want):
        tol = 1e-5 * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(_np(p), w, atol=tol, rtol=0, err_msg=name)
        np.testing.assert_allclose(_np(a), w, atol=tol, rtol=0, err_msg=name)
    if causal and window is not None and window <= 0:
        assert not any(float(g.abs().max()) for g in plain)
        assert bool(torch.isinf(lse).all())


def _emulate_tensor_core_backward(q, k, v, o, lse, do, *, causal, window,
                                  softcap, split):
    """The 16-bit backward route's arithmetic in plain PyTorch (not the
    kernel): q, k, v, do in bfloat16; S = Q K^T and dP = dO V^T summed in
    f32; P = exp(x - L) and dS = P (dP - D) dcap sm_scale in f32, then
    split into bfloat16 ``hi`` (and, with ``split``, the residual as
    ``lo``); dV = P^T dO, dK = dS^T Q and dQ = dS K from those halves,
    summed in f32; dK and dV of a kv head summed over its group's
    q-heads in head order, as the kernel's group-sum pass does; each
    gradient rounded once."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    sm = 1.0 / math.sqrt(D)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    x = qf @ kf.transpose(-1, -2) * sm
    if softcap:
        t = torch.tanh(x / softcap)
        x = softcap * t
    rows, cols = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    keep = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        keep &= cols <= rows
    if window is not None:
        keep &= cols > rows - window
    live = torch.isfinite(lse)[..., None]
    p = torch.where(keep & live, torch.exp(
        x - torch.where(live, lse[..., None], 0.0)), 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * sm
    if softcap:
        ds = ds * (1.0 - t * t)

    def halves(a):
        hi = a.to(q.dtype).float()
        return [hi, (a - hi).to(q.dtype).float()] if split else [hi]

    def group_sum(a):
        a = a.reshape(B, Hkv, group, Skv, D)
        acc = a[:, :, 0]
        for g in range(1, group):
            acc = acc + a[:, :, g]
        return acc

    dq = sum(h @ kf for h in halves(ds))
    dk = group_sum(sum(h.transpose(-1, -2) @ qf for h in halves(ds)))
    dv = group_sum(sum(h.transpose(-1, -2) @ dof for h in halves(p)))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _half_ulp_excess(got, want):
    """The largest ``|got - want| - ulp(want) / 2`` in bfloat16, as a
    share of ``max|want|``."""
    want = torch.from_numpy(np.array(want))
    _, e = torch.frexp(want)
    half_ulp = torch.where(want == 0, 0.0, torch.ldexp(
        torch.ones_like(want), e.clamp_min(-125) - 9))
    excess = float(((got.float() - want).abs() - half_ulp).max())
    return excess / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_split_p_and_ds_backward_contract_stays_within_half_an_ulp(case):
    """The arithmetic contract of the tensor-core backward (bfloat16 /
    float16 aligned views), emulated in plain PyTorch: with P and dS
    split into bfloat16 hi + lo, every gradient element lies within half
    a bfloat16 ulp of ``jax.grad`` of the JAX package's
    ``attention_ref`` (f32, on the same bfloat16 inputs) plus 1e-4 of
    the largest; one bfloat16 rounding of P and dS misses that gate
    (~1e-3 beyond) wherever the gradient is not 0.  O and L are the f32
    forward's, as in ``jax.grad``'s own row sums; the kernel itself is
    held to this gate against ``flash_bwd_ref`` on the card
    (``test_torch_cuda.py``, ``chip_smoke.py`` phase 18)."""
    qn, kn, vn = _inputs(case, "bfloat16", seed=21)
    causal, window, softcap = case[6:]
    don = np.random.default_rng(22).standard_normal(qn.shape) \
        .astype(np.float32).astype(ml_dtypes.bfloat16)
    f32 = [np.asarray(a, np.float32) for a in (qn, kn, vn, don)]
    want = _jax_attention_grads(*f32, causal, window, softcap)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in f32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = ref.flash_ref(*(torch.from_numpy(a) for a in f32[:3]),
                           return_lse=True, **kw)
    split, single = (
        max(_half_ulp_excess(g, w) for g, w in zip(
            _emulate_tensor_core_backward(q, k, v, o, lse, do, split=s,
                                          **kw), want))
        for s in (True, False))
    if not any(np.abs(w).max() for w in want):      # no kept key
        assert split == single == 0.0
    else:
        assert split <= 1e-4 < single, (split, single)


def test_flash_bwd_ref_matches_autograd_through_flash_ref():
    q, k, v = (_torch(a) for a in _inputs(CASES[5], "float32", seed=5))
    causal, window, softcap = CASES[5][6:]
    kw = dict(causal=causal, window=window, softcap=softcap)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ref.flash_ref(*leaves, block_q=16, **kw)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    auto = torch.autograd.grad(out, leaves, do)
    with torch.no_grad():
        o, lse = ref.flash_ref(q, k, v, return_lse=True, **kw)
        plain = ref.flash_bwd_ref(q, k, v, o, lse, do, **kw)
    for p, a in zip(plain, auto):
        torch.testing.assert_close(p, a, atol=1e-5 * float(a.abs().max()),
                                   rtol=0)


def test_flash_attention_without_grad_saves_nothing():
    q, k, v = (_torch(a).requires_grad_() for a in _inputs(CASES[0],
                                                            "float32", 1))
    with torch.no_grad():
        out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None and not out.requires_grad
    # nor where no input asks for a gradient
    out = fa.flash_attention(q.detach(), k.detach(), v.detach())
    assert out.grad_fn is None
    # the same values either way
    with_grad = fa.flash_attention(q, k, v)
    assert type(with_grad.grad_fn).__name__ == "FlashAttentionBackward"
    torch.testing.assert_close(with_grad.detach(), out, atol=0, rtol=0)
