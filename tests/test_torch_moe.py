"""The port's MoE path (deepseek-v2-lite family) against the JAX package.

Inputs come from numpy seeds; parameters from the JAX package's inits,
carried across with ``core.interop``.  On the CPU the kernel wrappers
take their plain versions.

* ``gather_rows`` / ``moe_combine``: the port's ``ops`` entry points
  (``fused`` and ``composite``, both the plain versions on CPU tensors)
  against the Pallas kernels in interpret mode, over the sweeps of
  ``tests/test_kernels.py`` plus repeated indices, every slot -1 and
  K = 1.  The gather is exact (it moves rows); the combine within
  ``1e-6`` in float32 (both sum K products in f32, in another order).
* ``route``: weights, indices and the aux and z metrics against the JAX
  router in float32, within ``1e-6``; the indices equal (the inputs are
  random normals: no two router probabilities tie).
* ``moe_forward_dense`` on both backends against the JAX one within
  ``1e-5`` in float32: a prefill-sized batch, one at capacity factor
  0.25 where tokens drop, and the decode case (T = B) where the capacity
  floor ``min(T, 64)`` applies; the ``fused`` dispatch buffer (gathered
  from a source table) equals the ``composite`` one (packed by
  ``_pack_by_dest``) bit for bit.
* ``init_params`` drawn in the compute dtype equals ``cast_params`` of
  the float32 draw, leaf for leaf (what ``DecodeEngine`` relies on).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models.moe as JM
from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.kernels.moe_dispatch import gather_rows as pallas_gather
from repro.kernels.moe_dispatch import moe_combine as pallas_combine
from repro_torch.configs import PORTED, get_config
from repro_torch.core import interop
from repro_torch.kernels import ops
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models import zoo

ARCH = "deepseek_v2_lite_16b"


def _t(a):
    return interop.tensor_from_numpy(a, "cpu")


def _np(x):
    """Either package's array as numpy (bfloat16 as its uint16 view)."""
    if isinstance(x, torch.Tensor):
        return interop.tensor_to_numpy(x)
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _cfgs(**kw):
    return (get_config(ARCH).reduced(dtype="float32", **kw),
            j_get_config(ARCH).reduced(dtype="float32", **kw))


# ---------------------------------------------------------------------------
# kernels 7 and 8
# ---------------------------------------------------------------------------
GATHER_CASES = [(64, 96, 128), (10, 3, 8), (128, 128, 256),   # N, M, D
                (1, 5, 24), (7, 0, 24), (33, 40, 13)]


@pytest.mark.parametrize("impl", ["fused", "composite"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GATHER_CASES, ids=str)
def test_gather_rows_matches_pallas(case, dtype, impl):
    N, M, D = case
    rng = np.random.default_rng(N * 1000 + M)
    x = rng.standard_normal((N, D)).astype(getattr(ml_dtypes, dtype)
                                           if dtype == "bfloat16"
                                           else np.float32)
    # repeated indices (M may exceed N); the last row read twice
    idx = rng.integers(0, N, size=(M,)).astype(np.int32)
    if M:
        idx[-1] = idx[0] = N - 1
    # the Pallas kernel cannot run an empty grid: M = 0 takes its oracle
    want = np.asarray(pallas_gather(jnp.asarray(x), jnp.asarray(idx),
                                    interpret=True) if M
                      else jref.gather_rows_ref(x, idx))
    got = ops.gather_rows(_t(x), _t(idx), impl=impl)
    assert got.dtype == _t(x).dtype and tuple(got.shape) == (M, D)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_gather_rows_plain_version_checks_the_index_range():
    x = torch.zeros((4, 8))
    for bad in ([0, 4], [-1, 2]):
        with pytest.raises(IndexError, match="outside"):
            ops.gather_rows(x, torch.tensor(bad, dtype=torch.int32))


COMBINE_CASES = [(32, 4, 128, 64), (7, 2, 16, 8), (64, 8, 512, 128),
                 (9, 1, 20, 24), (5, 6, 12, 13)]            # T, K, S, D


@pytest.mark.parametrize("impl", ["fused", "composite"])
@pytest.mark.parametrize("all_dropped", [False, True])
@pytest.mark.parametrize("case", COMBINE_CASES, ids=str)
def test_moe_combine_matches_pallas(case, all_dropped, impl):
    Tn, K, S, D = case
    rng = np.random.default_rng(Tn * 100 + K)
    y = rng.standard_normal((S, D)).astype(np.float32)
    slots = rng.integers(-1, S, size=(Tn, K)).astype(np.int32)
    if all_dropped:
        slots[:] = -1
    w = rng.standard_normal((Tn, K)).astype(np.float32)
    want = np.asarray(pallas_combine(jnp.asarray(y), jnp.asarray(slots),
                                     jnp.asarray(w), interpret=True))
    got = ops.moe_combine(_t(y), _t(slots), _t(w), impl=impl)
    assert got.dtype == torch.float32 and tuple(got.shape) == (Tn, D)
    if all_dropped:
        assert not got.abs().max().item() and not np.abs(want).max()
    # within 1e-6 of each row's largest |w * y| term
    scale = np.abs(w[:, :, None] * y[np.maximum(slots, 0)]
                   * (slots >= 0)[:, :, None]).max(axis=(1, 2))
    err = np.abs(_f32(got) - want).max(axis=1)
    assert (err <= 1e-6 * np.maximum(scale, 1e-30)).all(), err.max()
    np.testing.assert_allclose(
        _f32(got), np.asarray(jref.moe_combine_ref(y, slots, w)),
        atol=1e-6, rtol=1e-6)


def _combine_inputs(tokens, D, dtype=torch.bfloat16, offset=0, S=64,
                    K=6):
    y = torch.zeros(S * D + offset, dtype=dtype)[offset:].view(S, D)
    return y, torch.zeros((tokens, K), dtype=torch.int32)


# the combine's route, from dtype, shape, alignment and the token count
# alone (the kernels run on the card; the choice is plain Python, so it
# is checked here)
COMBINE_ROUTE_CASES = {
    "prefill: 16384 tokens, bf16 D 2048": (
        lambda: _combine_inputs(16384, 2048), "bulk"),
    "decode: 4 tokens, bf16 D 2048": (
        lambda: _combine_inputs(4, 2048), "registers"),
    "one token under the ring's floor": (
        lambda: _combine_inputs(263, 2048), "registers"),
    "the ring's floor": (lambda: _combine_inputs(264, 2048), "bulk"),
    "f32 D 24 (96 bytes a row), K 16": (
        lambda: _combine_inputs(33, 24, torch.float32, K=16), "registers"),
    "f32 D 13": (lambda: _combine_inputs(33, 13, torch.float32), "simple"),
    "odd D * itemsize (bf16 D 12)": (
        lambda: _combine_inputs(300, 12), "simple"),
    "offset view": (lambda: _combine_inputs(300, 2048, offset=1),
                    "simple"),
    "y[:, 1:] view": (lambda: (torch.zeros(64, 2049)[:, 1:],
                               torch.zeros((4, 6), dtype=torch.int32)),
                      "simple"),
    "float64": (lambda: _combine_inputs(4, 2048, torch.float64), "simple"),
}


@pytest.mark.parametrize("case", list(COMBINE_ROUTE_CASES))
def test_moe_combine_route_follows_dtype_shape_and_alignment(case):
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref

    make, want = COMBINE_ROUTE_CASES[case]
    y, slots = make()
    assert md.combine_route(y, slots) == want
    # on CPU tensors the wrapper is the plain version, whatever the route
    if y.dtype != torch.float64:
        w = torch.ones(slots.shape)
        assert torch.equal(md.moe_combine(y, slots, w, route="simple"),
                           ref.moe_combine_ref(y, slots, w))


# ---------------------------------------------------------------------------
# router and MoE FFN
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def moe_setup():
    cfg, jcfg = _cfgs()
    jp = JM.moe_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = interop.pytree.tree_map(
        _t, jax.tree_util.tree_map(np.asarray, jp))
    return cfg, jcfg, jp, tp


def test_route_matches_jax(moe_setup):
    cfg, jcfg, jp, tp = moe_setup
    x = np.random.default_rng(4).standard_normal(
        (40, cfg.d_model)).astype(np.float32)
    jw, ji, jaux = JM.route(jp["router"], jnp.asarray(x), cfg.top_k,
                            n_experts=cfg.n_experts)
    tw, ti, taux = M.route(tp["router"], _t(x), cfg.top_k,
                           n_experts=cfg.n_experts)
    assert ti.dtype == torch.int32 and tw.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)
    for name in ("aux", "z"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   atol=1e-6, rtol=1e-6)


# (batch, seq, capacity factor): prefill-sized, dropping, decode (T = B)
MOE_CASES = [(2, 12, 1.25), (2, 128, 0.25), (3, 1, 1.25)]


@pytest.mark.parametrize("impl", ["fused", "composite"])
@pytest.mark.parametrize("case", MOE_CASES, ids=str)
def test_moe_forward_dense_matches_jax(moe_setup, case, impl):
    cfg0, jcfg0, jp, tp = moe_setup
    B, S, cf = case
    cfg = dataclasses.replace(cfg0, capacity_factor=cf)
    jcfg = dataclasses.replace(jcfg0, capacity_factor=cf)
    x = np.random.default_rng(B * S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jo, jaux = JM.moe_forward_dense(jp, jcfg, jnp.asarray(x))
    to, taux = M.moe_forward_dense(tp, cfg, _t(x), impl=impl)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    for name in ("aux", "z"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", MOE_CASES, ids=str)
def test_fused_dispatch_buffer_equals_composite_bit_for_bit(moe_setup,
                                                            case):
    cfg, _, _, tp = moe_setup
    B, S, cf = case
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    xt = _t(np.random.default_rng(B * S).standard_normal(
        (B * S, cfg.d_model)).astype(np.float32))
    _, idx, _ = M.route(tp["router"], xt, cfg.top_k,
                        n_experts=cfg.n_experts)
    cap = M.moe_capacity(cfg, B * S)
    fb, fs = M.moe_dispatch(xt, idx, cfg.n_experts, cap, impl="fused")
    cb, cs = M.moe_dispatch(xt, idx, cfg.n_experts, cap, impl="composite")
    assert tuple(fb.shape) == (cfg.n_experts, cap, cfg.d_model)
    assert torch.equal(fb.view(torch.int32), cb.view(torch.int32))
    assert torch.equal(fs, cs)
    dropped = int((cs < 0).sum())
    assert (dropped > 0) == (cf < 1.0), dropped   # the 0.25 case drops
    if S == 1:
        assert cap == B                            # the decode floor


def test_expert_parallel_paths_need_a_mesh():
    for fn in (M.expert_all_to_all, M.expert_replicated):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn()


# ---------------------------------------------------------------------------
# parameters drawn in the compute dtype
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", PORTED)
def test_compute_dtype_draw_equals_cast_of_the_f32_draw(arch):
    cfg = get_config(arch).reduced()
    assert cfg.param_dtype == "float32" and cfg.dtype == "bfloat16"
    master = T.cast_params(zoo.init_params(cfg, 7, device="cpu"), cfg)
    direct = T.cast_params(zoo.init_params(
        dataclasses.replace(cfg, param_dtype=cfg.dtype), 7, device="cpu"),
        cfg)
    a, spec_a = interop.pytree.tree_flatten(master)
    b, spec_b = interop.pytree.tree_flatten(direct)
    assert spec_a == spec_b
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
