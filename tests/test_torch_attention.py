"""Attention of the PyTorch port against the JAX package.

The same inputs, made from a numpy seed, go through the port's
``kernels.ops.attention`` (on CPU tensors: the flash kernel's plain
version ``flash_ref``, under both ``fused`` and ``composite``) and
through the JAX package's Pallas ``flash_attention`` in interpret mode
and its ``attention_ref``.  Cases cover causal and non-causal masks, a
sliding window, a softcap, GQA groups 1 / 2 / 4, ``Sq != Skv``, lengths
that are not block multiples and fully masked rows.

Tolerances: float32 ``1e-5`` (the two packages sum in f32 in another
order); bfloat16 ``2e-2`` absolute and relative (both round the f32
result to bfloat16 once, and their inputs to the products differ by
rounding only where the JAX kernel upcasts blocks).
"""
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
