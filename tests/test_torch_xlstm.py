"""The port's mLSTM and sLSTM path (xlstm family) against the JAX package.

Inputs are made from a seed with numpy; parameters come from one JAX
``zoo.init_params`` carried across through
``core.interop.params_from_numpy``.  On the CPU the kernel wrappers take
their plain versions.

* ``mlstm``: the port's plain version (``ref.mlstm_ref``, the sequential
  recurrence; what ``ops.mlstm`` computes on a CPU tensor) against the
  JAX ``mlstm_ref`` within ``1e-5``, and against the Pallas chunkwise
  kernel in interpret mode with the JAX test's own tolerance: h within
  ``5e-4`` of max|h|, C within ``1e-3``, m within ``1e-4`` (float32).  In
  bfloat16 the Pallas wrapper rounds the scaled q and k to bfloat16
  where the plain version keeps them in f32: h and C within ``1e-2`` of
  their largest value.  Shapes: ``tests/test_kernels.py``'s sweep, a
  sequence shorter than the chunk, strongly negative input gates and
  forget gates near 1.
* the mLSTM and sLSTM blocks and their decode steps against the JAX
  modules: within ``1e-5`` (float32).
* xlstm-350m reduced to one period (7 mLSTM + 1 sLSTM layers, d_model
  64): prefill logits and every decode-state leaf, then 8 teacher-forced
  decode steps, float32 within ``1e-4``; in bfloat16 the port is held
  against the float32 run and must be no further from it than the JAX
  package's own bfloat16 run (x1.5 in relative L2): the mLSTM stabilizer
  is a max over bfloat16 gate values, one ulp moves it and rescales C
  and n, and at eight layers the two packages' bfloat16 runs differ from
  each other about as much as each differs from float32.
* a JAX decode state (m = -inf where no input came yet) continued by
  the port; the sequential prefill against the parallel one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models.ssm as JS
import repro.models.transformer as JT
from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.kernels.mlstm import mlstm_chunkwise as pallas_mlstm
from repro.models import Parallel as JParallel
from repro.models import zoo as jzoo
from repro_torch.configs import get_config
from repro_torch.core import interop
from repro_torch.core.interop import tensor_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import Parallel
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

ARCH = "xlstm_350m"
S_CACHE = 48
F32_TOL = 1e-4
BF16_MARGIN = 1.5
RNG = np.random.default_rng(21)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _cfgs(dtype="float32"):
    cfg = get_config(ARCH).reduced(dtype=dtype)
    jcfg = j_get_config(ARCH).reduced(dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = _cfgs()
    jp = jzoo.init_params(jcfg, 0)
    tp = interop.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    follow = rng.integers(0, cfg.vocab_size, (8, 2, 1)).astype(np.int32)
    return cfg, jcfg, jp, tp, tokens, follow


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------
MLSTM_CASES = [
    # (BH, S, d, Pallas block_s, i offset, f offset)
    (2, 128, 64, 32, 0.0, 2.0), (1, 100, 32, 64, 0.0, 2.0),
    (4, 64, 16, 64, 0.0, 2.0), (1, 256, 64, 128, 0.0, 2.0),
    (2, 40, 32, 64, 0.0, 2.0),                 # shorter than the chunk
    (2, 150, 16, 64, -30.0, 2.0),              # strongly negative i
    (2, 150, 16, 64, 0.0, 60.0),               # forget gates near 1
]


def _mlstm_inputs(BH, S_, d, i_off, f_off, dtype=np.float32):
    q, k, v = (RNG.normal(size=(BH, S_, d)).astype(dtype) for _ in range(3))
    ig = (RNG.normal(size=(BH, S_)) + i_off).astype(np.float32)
    fg = (RNG.normal(size=(BH, S_)) + f_off).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("BH,S_,d,bs,i_off,f_off", MLSTM_CASES)
def test_mlstm_plain_version_matches_pallas_and_ref(BH, S_, d, bs, i_off,
                                                    f_off):
    q, k, v, ig, fg = _mlstm_inputs(BH, S_, d, i_off, f_off)
    h, (C, n, m) = ref.mlstm_ref(*map(_t, (q, k, v, ig, fg)))
    jh, (jC, jn, jm) = jref.mlstm_ref(q, k, v, ig, fg)
    for got, want in ((h, jh), (C, jC), (n, jn), (m, jm)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5,
                                   rtol=1e-5)
    ph, (pC, pn, pm) = pallas_mlstm(q, k, v, ig, fg, block_s=bs,
                                    interpret=True)
    scale = np.abs(_f32(h)).max() + 1e-9
    assert np.abs(_f32(ph) - _f32(h)).max() / scale < 5e-4
    np.testing.assert_allclose(_f32(pC), _f32(C), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(_f32(pn), _f32(n), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(_f32(pm), _f32(m), atol=1e-4, rtol=0)
    # the op: its fused path on a CPU tensor is the plain version
    oh, (oC, on, om) = ops.mlstm(*map(_t, (q, k, v, ig, fg)), impl="fused",
                                 return_state=True)
    assert torch.equal(oh, h) and torch.equal(oC, C) and torch.equal(om, m)
    assert torch.equal(ops.mlstm(*map(_t, (q, k, v, ig, fg)),
                                 impl="composite"), h)


@pytest.mark.parametrize("d", [32, 64])
def test_mlstm_plain_version_in_bf16(d):
    """The Pallas wrapper scales q and k in bfloat16 (the scale itself
    rounded to bfloat16), the plain version in f32: at d = 64 the scale
    is a power of two and the two agree to f32 rounding; at d = 32 they
    differ by one rounding of q and k, well inside 1e-2."""
    q, k, v, ig, fg = _mlstm_inputs(2, 100, d, 0.0, 2.0, ml_dtypes.bfloat16)
    h, (C, _, _) = ref.mlstm_ref(*map(_t, (q, k, v, ig, fg)))
    assert h.dtype == torch.bfloat16 and C.dtype == torch.float32
    ph, (pC, _, _) = pallas_mlstm(q, k, v, ig, fg, interpret=True)
    for got, want in ((ph, h), (pC, C)):
        top = np.abs(_f32(want)).max() + 1e-9
        assert np.abs(_f32(got) - _f32(want)).max() / top < 1e-2


# ---------------------------------------------------------------------------
# the blocks and their steps
# ---------------------------------------------------------------------------
def _layer(tree_j, tree_t, slot):
    jl = jax.tree_util.tree_map(lambda a: a[0], tree_j["scan"][slot]["mixer"])
    tl = interop.pytree.tree_map(lambda a: a[0],
                                 tree_t["scan"][slot]["mixer"])
    return jl, tl


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_and_step_match_jax(setup, kind):
    cfg, jcfg, jp, tp, _, _ = setup
    slot = 0 if kind == "mlstm" else 7
    jl, tl = _layer(jp, tp, slot)
    block = {"mlstm": (JS.mlstm_block, S.mlstm_block),
             "slstm": (JS.slstm_block, S.slstm_block)}[kind]
    step = {"mlstm": (JS.mlstm_block_step, S.mlstm_block_step),
            "slstm": (JS.slstm_block_step, S.slstm_block_step)}[kind]
    x = RNG.normal(size=(2, 70, cfg.d_model)).astype(np.float32)
    kw = {"impl": "pallas_interpret"} if kind == "mlstm" else {}
    jo, js = block[0](jl, jcfg, jnp.asarray(x), return_state=True, **kw)
    to, ts = block[1](tl, cfg, _t(x), return_state=True)
    _close(to, jo, 1e-4)                  # chunkwise vs sequential
    assert list(ts) == sorted(js)         # flatten order
    for name in ts:
        _close(ts[name], js[name], 1e-4)
    xt = RNG.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    jo, jn = step[0](jl, jcfg, jnp.asarray(xt), js)
    before = {name: t.clone() for name, t in ts.items()}
    to, tn = step[1](tl, cfg, _t(xt), ts)
    _close(to, jo, 1e-4)
    for name in tn:
        _close(tn[name], jn[name], 1e-4)
        assert torch.equal(ts[name], before[name])   # input not written
    empty = {"mlstm": (JS.mlstm_empty_state, S.mlstm_empty_state),
             "slstm": (JS.slstm_empty_state, S.slstm_empty_state)}[kind]
    je, te = empty[0](jcfg, 3), empty[1](cfg, 3, device="cpu")
    assert list(te) == sorted(je)
    for name in te:
        np.testing.assert_array_equal(_f32(te[name]), _f32(je[name]))


def test_step_from_the_empty_state_matches_jax(setup):
    """The first decode step starts from m = -inf: exp(-inf - -inf) is
    NaN and the step maps the decay to 0, as the reference does."""
    cfg, jcfg, jp, tp, _, _ = setup
    jl, tl = _layer(jp, tp, 0)
    xt = RNG.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    jo, jn = JS.mlstm_block_step(jl, jcfg, jnp.asarray(xt),
                                 JS.mlstm_empty_state(jcfg, 2))
    to, tn = S.mlstm_block_step(tl, cfg, _t(xt),
                                S.mlstm_empty_state(cfg, 2, device="cpu"))
    _close(to, jo)
    for name in tn:
        assert torch.isfinite(tn[name]).all()
        _close(tn[name], jn[name])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_prefill_and_decode_match_jax_f32(setup):
    cfg, jcfg, jp, tp, tokens, follow = setup
    js, jl = JT.prefill_forward(jp, jcfg, JParallel(),
                                {"tokens": jnp.asarray(tokens)}, S_CACHE,
                                impl="pallas_interpret")
    ts, tl = T.prefill_forward(tp, cfg, Parallel(),
                               {"tokens": torch.from_numpy(tokens)},
                               S_CACHE, impl="fused")
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    _close(tl, jl, F32_TOL)
    jleaves = jax.tree_util.tree_leaves(js)
    tleaves = interop.pytree.tree_leaves(ts)
    assert [tuple(x.shape) for x in tleaves] == \
        [tuple(x.shape) for x in jleaves]
    for a, b in zip(tleaves, jleaves):
        _close(a, b, F32_TOL)
    for tok in follow:
        js, jd = JT.decode_step(jp, jcfg, JParallel(), js, jnp.asarray(tok))
        ts, td = T.decode_step(tp, cfg, Parallel(), ts,
                               torch.from_numpy(tok))
        _close(td, jd, F32_TOL)
    for a, b in zip(interop.pytree.tree_leaves(ts),
                    jax.tree_util.tree_leaves(js)):
        _close(a, b, F32_TOL)


def _logits(params, cfg, tokens, follow, *, jax_side, impl):
    if jax_side:
        st, lg = JT.prefill_forward(params, cfg, JParallel(),
                                    {"tokens": jnp.asarray(tokens)},
                                    S_CACHE, impl=impl)
        out = [_f32(lg)]
        for tok in follow:
            st, d = JT.decode_step(params, cfg, JParallel(), st,
                                   jnp.asarray(tok))
            out.append(_f32(d))
        return np.stack(out)
    st, lg = T.prefill_forward(params, cfg, Parallel(),
                               {"tokens": torch.from_numpy(tokens)},
                               S_CACHE, impl=impl)
    out = [_f32(lg)]
    for tok in follow:
        st, d = T.decode_step(params, cfg, Parallel(), st,
                              torch.from_numpy(tok))
        out.append(_f32(d))
    return np.stack(out)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_prefill_and_decode_bf16_as_close_to_f32_as_jax(setup):
    _, _, jp, tp, tokens, follow = setup
    cfg32, jcfg32 = _cfgs("float32")
    cfg16, jcfg16 = _cfgs("bfloat16")
    truth = _logits(jp, jcfg32, tokens, follow, jax_side=True, impl="xla")
    jax16 = _logits(jp, jcfg16, tokens, follow, jax_side=True,
                    impl="pallas_interpret")
    port16 = _logits(tp, cfg16, tokens, follow, jax_side=False,
                     impl="fused")
    assert np.isfinite(port16).all()
    for i in range(len(truth)):        # prefill logits, then each step
        assert _rel(port16[i], truth[i]) <= BF16_MARGIN * _rel(
            jax16[i], truth[i]) + 1e-3


def test_decode_state_from_jax_continues_decode(setup):
    cfg, jcfg, jp, tp, tokens, follow = setup
    js = JT.init_decode_state(jcfg, 2, S_CACHE)       # m = -inf
    ts = interop.decode_state_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, js), device="cpu")
    assert torch.isneginf(ts["scan"][0]["m"]).all()
    for tok in list(tokens.T[:, :, None][:6]) + list(follow[:3]):
        js, jd = JT.decode_step(jp, jcfg, JParallel(), js, jnp.asarray(tok))
        ts, td = T.decode_step(tp, cfg, Parallel(), ts,
                               torch.from_numpy(np.ascontiguousarray(tok)))
        _close(td, jd, F32_TOL)
    back = interop.decode_state_to_numpy(ts)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(js)):
        _close(a, b, F32_TOL)


def test_sequential_prefill_matches_parallel_prefill(setup):
    cfg, _, _, tp, tokens, _ = setup
    tok = torch.from_numpy(tokens)
    st_seq, lg_seq = T.prefill(tp, cfg, Parallel(), tok, S_CACHE)
    st_par, lg_par = T.prefill_forward(tp, cfg, Parallel(), {"tokens": tok},
                                       S_CACHE)
    _close(lg_seq[:, -1], lg_par, F32_TOL)
    for a, b in zip(interop.pytree.tree_leaves(st_seq),
                    interop.pytree.tree_leaves(st_par)):
        _close(a, b, F32_TOL)


def test_empty_decode_state_crosses_numpy_unchanged():
    cfg, jcfg = _cfgs()
    st = T.init_decode_state(cfg, 2, S_CACHE, device="cpu")
    back = interop.decode_state_to_numpy(st)
    again = interop.decode_state_from_numpy(cfg, back, device="cpu")
    jst = JT.init_decode_state(jcfg, 2, S_CACHE)
    for a, b, c in zip(interop.pytree.tree_leaves(again),
                       jax.tree_util.tree_leaves(back),
                       jax.tree_util.tree_leaves(jst)):
        np.testing.assert_array_equal(_f32(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(b), np.asarray(c))
