"""The tensor-core mLSTM decomposition, emulated on the CPU.

``csrc/mlstm.cu``'s tensor-core route computes the chunkwise mLSTM in
three passes: a gate pass (b, m, g, u and the carry decay of each
chunk), the scores ``W = (Q Kᵀ) ∘ D`` once per chunk, and a state pass
sequential over chunks that keeps C in f32 and feeds every f32 operand
of a product (C for ``Q C``, W for ``W V``, ``k * u`` for the update)
to the tensor cores as an input-type ``hi + lo`` pair; q, k and v (the
kernel's own rounded, scaled q and k) enter exactly, and products sum in
f32.  C's pair is scaled by a power of two (max|C| into [2^14, 2^15)).
:func:`emulate` repeats that arithmetic with torch on the CPU.

* Against ``ref.mlstm_ref`` on f32 copies of the same rounded, scaled q
  and k (``scale=1.0``): h within ``1e-4`` of max|h| before the output
  rounding, and the output-type h within the card's contract gate —
  half an output ulp plus ``1e-4`` max|h| (``chip_smoke.py`` phase 7).
* Against the JAX package's Pallas ``mlstm_chunkwise`` in interpret
  mode on the same bfloat16 inputs (which scales q and k in bfloat16
  as the kernel does, then runs f32 products): within the same gate.
* One rounding of each f32 operand instead of its pair: how far past
  the contract gate it lands.  The finding decides which pairs the
  kernel keeps (``PERF.md``).
* ``mlstm_ref(scale=...)``: the default is today's output, bit for bit.
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.mlstm import mlstm_chunkwise as pallas_mlstm
from repro_torch.kernels import mlstm as ml
from repro_torch.kernels import ref

CHUNK = 64
GATE_ATOL = 1e-4        # the contract gate's slack, a share of max|h|


def _inputs(BH, S, d, i_off, f_off, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((BH, S, d)).astype(np.float32)
               for _ in range(3))
    ig = (rng.standard_normal((BH, S)) + i_off).astype(np.float32)
    fg = (rng.standard_normal((BH, S)) + f_off).astype(np.float32)
    return q, k, v, ig, fg


def scaled_inputs(q, k, dtype):
    """The kernel's q and k: ``round(x * round(1/sqrt(d)))``, each round
    to ``dtype``, as f32 tensors."""
    d = q.shape[-1]
    s = float(torch.tensor(1.0 / math.sqrt(d)).to(dtype))
    return tuple((t.to(dtype).float() * s).to(dtype).float() for t in (q, k))


def _pair(x, dtype, once=False):
    hi = x.to(dtype).float()
    return (hi,) if once else (hi, (x - hi).to(dtype).float())


def _prod(a_parts, b_parts):
    """Sum of the parts' products, each exact, summed in f64 and rounded
    to f32 (the tensor cores' f32 accumulation)."""
    return sum(a.double() @ b.double() for a in a_parts
               for b in b_parts).float()


def emulate(qs, ks, v, ig, fg, dtype, once=()):
    """The tensor-core route's arithmetic; ``qs``, ``ks``: the kernel's
    rounded, scaled q and k (f32 tensors); ``v`` in ``dtype``.  ``once``
    names the f32 operands ("C", "W", "ku") rounded once instead of
    split.  Returns f32 (h, (C, n, m))."""
    BH, S, d = qs.shape
    vf = v.to(dtype).float()
    logf = torch.nn.functional.logsigmoid(fg.float())
    ig = ig.float()
    C = torch.zeros((BH, d, d))
    n = torch.zeros((BH, d))
    m_prev = torch.full((BH,), float("-inf"))
    hs = torch.empty((BH, S, d))
    fin = lambda x: torch.where(torch.isfinite(x), x,  # noqa: E731
                                torch.zeros_like(x))
    for t0 in range(0, S, CHUNK):
        sl = slice(t0, min(S, t0 + CHUNK))
        Q, K, V = qs[:, sl], ks[:, sl], vf[:, sl]
        L = Q.shape[1]
        # (a) the gate pass
        b = torch.cumsum(logf[:, sl], dim=1)
        i = ig[:, sl]
        g_run = torch.cummax(i - b, dim=1).values
        m_t = b + torch.maximum(m_prev[:, None], g_run)
        g = fin(torch.exp(b + m_prev[:, None] - m_t))
        b_e, m_e = b[:, -1:], m_t[:, -1:]
        u = torch.exp(b_e - b + i - m_e)
        carry = fin(torch.exp(b_e[:, 0] + m_prev - m_e[:, 0]))
        # (b) the scores once per chunk, W = S o D and its row sums
        Sc = _prod([Q], [K.transpose(1, 2)])
        D = torch.exp(b[:, :, None] - b[:, None, :] + i[:, None, :]
                      - m_t[:, :, None])
        D = torch.where(torch.ones(L, L, dtype=torch.bool).tril(), D, 0.0)
        W = Sc * D
        rsum = W.sum(-1)
        # (c) the state pass: C's pair scaled by a power of two
        top = C.abs().amax(dim=(1, 2))
        ex = torch.where(top > 0, 15 - torch.frexp(top).exponent, 0)
        sc = torch.ldexp(torch.ones(BH), ex.clamp(-100, 100))[:, None, None]
        QC = _prod([Q], _pair(C * sc, dtype, "C" in once)) / sc
        WV = _prod(_pair(W, dtype, "W" in once), [V])
        denom = torch.clamp((g * (Q @ n[:, :, None])[..., 0] + rsum).abs(),
                            min=1.0)
        hs[:, sl] = (g[..., None] * QC + WV) / denom[..., None]
        ku = K * u[..., None]
        C = carry[:, None, None] * C + _prod(
            [p.transpose(1, 2) for p in _pair(ku, dtype, "ku" in once)],
            [V])
        n = carry[:, None] * n + ku.sum(1)
        m_prev = m_e[:, 0]
    return hs, (C, n, m_prev)


def half_ulp(x, dtype):
    """Half a unit in the last place of ``dtype`` at each |x|."""
    mant = {torch.bfloat16: 8, torch.float16: 11}[dtype]
    _, e = torch.frexp(x)                    # |x| in [2^(e-1), 2^e)
    emin = {torch.bfloat16: -125, torch.float16: -13}[dtype]
    return torch.where(x == 0, 0.0, torch.ldexp(
        torch.ones_like(x), e.clamp_min(emin) - mant - 1))


def gate_share(h_out, h_exact, dtype):
    """The largest share of the contract gate (half an output ulp plus
    ``GATE_ATOL`` max|h|) that an element of ``h_out`` uses."""
    bound = half_ulp(h_exact, dtype) + GATE_ATOL * float(
        h_exact.abs().max())
    return float(((h_out.float() - h_exact).abs() / bound).max())


# (BH, S, d, i offset, f offset): ragged S, S < 64, d 16 / 64 / 512,
# strongly negative input gates, forget gates near 1
CASES = [
    (2, 40, 16, 0.0, 2.0),
    (2, 130, 64, -30.0, 2.0),
    (2, 200, 64, 0.0, 60.0),
    (1, 130, 512, 0.0, 2.0),
    (1, 100, 512, -30.0, 2.0),
    (3, 65, 16, 0.0, 60.0),
]


def _case(case, dtype):
    q, k, v, ig, fg = (torch.from_numpy(a)
                       for a in _inputs(*case, seed=len(str(case))))
    qs, ks = scaled_inputs(q, k, dtype)
    vt = v.to(dtype)
    exact = ref.mlstm_ref(qs, ks, vt.float(), ig, fg, scale=1.0)
    return qs, ks, vt, ig, fg, exact


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=str)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulated_decomposition_meets_the_contract_gate(case, dtype):
    qs, ks, vt, ig, fg, (hx, (Cx, nx, mx)) = _case(case, dtype)
    h, (C, n, m) = emulate(qs, ks, vt, ig, fg, dtype)
    top = float(hx.abs().max())
    assert float((h - hx).abs().max()) <= 1e-4 * top
    torch.testing.assert_close(C, Cx, atol=1e-4 * float(Cx.abs().max()),
                               rtol=1e-4)
    torch.testing.assert_close(n, nx, atol=1e-4 * float(nx.abs().max()),
                               rtol=1e-4)
    torch.testing.assert_close(m, mx, atol=1e-5, rtol=1e-6)
    assert gate_share(h.to(dtype), hx, dtype) <= 1.0


def test_emulated_decomposition_matches_pallas_interpret():
    """bfloat16 inputs through the JAX Pallas kernel (interpret mode: it
    scales q and k in bfloat16, then runs f32 products) and through the
    emulation: both within the contract gate of the f32 recurrence."""
    case = (2, 150, 64, 0.0, 2.0)
    q, k, v, ig, fg = _inputs(*case, seed=5)
    bf = ml_dtypes.bfloat16
    qb, kb, vb, ib, fb = (a.astype(bf) for a in (q, k, v, ig, fg))
    ph, (pC, pn, pm) = pallas_mlstm(*(jnp.asarray(a) for a in
                                      (qb, kb, vb, ib, fb)),
                                    interpret=True)
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a).astype(np.float32))
    qs, ks = scaled_inputs(t(qb), t(kb), torch.bfloat16)
    ig_t, fg_t = t(ib), t(fb)
    hx, _ = ref.mlstm_ref(qs, ks, t(vb), ig_t, fg_t, scale=1.0)
    h, (C, n, m) = emulate(qs, ks, t(vb).to(torch.bfloat16), ig_t, fg_t,
                           torch.bfloat16)
    assert gate_share(t(ph), hx, torch.bfloat16) <= 1.0
    assert gate_share(h.to(torch.bfloat16), hx, torch.bfloat16) <= 1.0
    for got, want in ((C, t(pC)), (n, t(pn))):
        top = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * top
    torch.testing.assert_close(m, t(pm), atol=1e-5, rtol=1e-6)


# the f32 operand rounded once, at the sweep's widest row; bfloat16
ONCE_CASE = (1, 130, 512, 0.0, 2.0)


@pytest.mark.parametrize("operand", ["C", "W", "ku"])
def test_one_rounding_of_an_operand_against_the_gate(operand):
    """Each f32 operand rounded once to bfloat16 (no lo part) instead of
    its pair: the share of the contract gate the output then uses.  All
    three land past the gate (share > 1), so the kernel keeps all three
    pairs; the split version stays well inside it."""
    dtype = torch.bfloat16
    qs, ks, vt, ig, fg, (hx, _) = _case(ONCE_CASE, dtype)
    split = gate_share(emulate(qs, ks, vt, ig, fg, dtype)[0].to(dtype), hx,
                       dtype)
    once = gate_share(emulate(qs, ks, vt, ig, fg, dtype,
                              once=(operand,))[0].to(dtype), hx, dtype)
    assert split <= 1.0
    assert once > 1.0, (operand, once, split)


def test_mlstm_ref_default_scale_is_unchanged():
    """The default ``scale=None`` is today's output bit for bit; a given
    scale multiplies q and k in f32 (``scale=1.0`` on pre-divided inputs
    is the same computation)."""
    q, k, v, ig, fg = (torch.from_numpy(a)
                       for a in _inputs(2, 70, 32, 0.0, 2.0, seed=3))
    default = ref.mlstm_ref(q, k, v, ig, fg)
    same = ref.mlstm_ref(q, k, v, ig, fg, scale=None)
    pre = ref.mlstm_ref(q / math.sqrt(32), k / math.sqrt(32), v, ig, fg,
                        scale=1.0)
    for a, b in zip((default[0], *default[1]), (same[0], *same[1])):
        assert torch.equal(a, b)
    for a, b in zip((default[0], *default[1]), (pre[0], *pre[1])):
        assert torch.equal(a, b)
    half = ref.mlstm_ref(q, k, v, ig, fg, scale=0.5)
    want = ref.mlstm_ref(q * 0.5, k * 0.5, v, ig, fg, scale=1.0)
    assert torch.equal(half[0], want[0])


def test_scratch_and_route_rule():
    """The tensor-core route's scratch holds six per-step f32 arrays, the
    n increments and carry decays, W's pair, the scaled q and (k u)ᵀ's
    pair; the route takes 16-bit dtypes at head
    dims that are multiples of 16 and sends the rest to the FMA kernel."""
    small = 16 * (6 * 2048 + 32 * 512 + 32)
    assert ml.scratch_floats(16, 2048, 512) == small + 16 * 32 * (
        4096 + 8 * 3 * 64 * 72 // 2)
    # 6 * 128 + 2 * 16 + 2 = 802 words, padded to 804
    assert ml.scratch_floats(1, 65, 16) == 804 + 2 * (4096 + 3 * 2304)
    z = lambda d, dt: torch.zeros((1, 4, d), dtype=dt)  # noqa: E731
    assert ml.tensor_core_route(*(z(512, torch.bfloat16),) * 3)
    assert ml.tensor_core_route(*(z(16, torch.float16),) * 3)
    assert not ml.tensor_core_route(*(z(24, torch.bfloat16),) * 3)
    assert not ml.tensor_core_route(*(z(512, torch.float32),) * 3)
