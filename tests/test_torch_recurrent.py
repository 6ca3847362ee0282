"""The port's RG-LRU path (recurrentgemma family) against the JAX package.

Inputs are made from a seed with numpy; parameters come from one JAX
``zoo.init_params`` carried across through
``core.interop.params_from_numpy``.  On the CPU the kernel wrappers take
their plain versions.

* ``rg_lru``: the port's plain version (``ref.rg_lru_ref``, also what
  ``ops.rg_lru_scan`` computes on a CPU tensor) against the Pallas
  kernel in interpret mode and against the JAX ``rg_lru_ref``, at the
  shapes of ``tests/test_kernels.py``: within ``1e-5`` (both run the
  same f32 steps; the JAX test's own tolerance is ``1e-4``).
* the RG-LRU block and its decode step against the JAX module: within
  ``1e-5`` in float32.
* recurrentgemma-2b reduced to 5 layers (one rec/rec/local-attention
  period + two rec suffix layers, d_model 64, window 16): prefill logits
  and every decode-state leaf, then 8 teacher-forced decode steps, in
  float32 within ``1e-4``.  In bfloat16, prefill and decode logits
  within ``3e-2`` of the JAX package's (``tests/test_arch_smoke.py``'s
  tolerance), and no further from the float32 run than the JAX
  package's own bfloat16 run is (x1.5 in relative L2).
* a JAX decode state continued by the port; the sequential prefill
  against the parallel one; a ``SeqKV`` of this family through both
  packages' device transports (equal bytes and ``TransportStats``); the
  elastic serving runtime with a ``DecodeEngine`` of this family.
* ``init_decode_state`` with no ``device`` needs the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as J
import repro.models.rglru as JR
import repro.models.transformer as JT
import repro_torch.core as TC
from repro.configs import get_config as j_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rg_lru import rg_lru as pallas_rg_lru
from repro.models import Parallel as JParallel
from repro.models import zoo as jzoo
from repro.serving import SeqKV as JSeqKV
from repro_torch.configs import get_config
from repro_torch.core import interop
from repro_torch.core.interop import tensor_from_numpy, tensor_to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import Parallel
from repro_torch.models import rglru as R
from repro_torch.models import transformer as T
from repro_torch.serving import DecodeEngine, RealDecodeSim, SeqKV

ARCH = "recurrentgemma_2b"
N_LAYERS = 5
S_CACHE = 48
F32_TOL = 1e-4
BF16_TOL = 3e-2
BF16_MARGIN = 1.5
RNG = np.random.default_rng(13)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _cfgs(dtype="float32"):
    cfg = get_config(ARCH).reduced(n_layers=N_LAYERS, dtype=dtype)
    jcfg = j_get_config(ARCH).reduced(n_layers=N_LAYERS, dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = _cfgs()
    jp = jzoo.init_params(jcfg, 0)
    tp = interop.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    # longer than the window (16): the local ring wraps
    tokens = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    follow = rng.integers(0, cfg.vocab_size, (8, 2, 1)).astype(np.int32)
    return cfg, jcfg, jp, tp, tokens, follow


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,D,bs,bd", [
    (2, 256, 128, 64, 64), (1, 100, 96, 32, 128), (3, 64, 32, 128, 16),
    (1, 512, 256, 128, 128),
])
def test_rg_lru_plain_version_matches_pallas_and_ref(B, S, D, bs, bd):
    x = RNG.normal(size=(B, S, D)).astype(np.float32)
    a = (0.5 + 0.49 * RNG.random(size=(B, S, D))).astype(np.float32)
    h0 = RNG.normal(size=(B, D)).astype(np.float32)
    hs, hl = ref.rg_lru_ref(_t(x), _t(a), _t(h0))
    ps, pl = pallas_rg_lru(x, a, h0, block_s=bs, block_d=bd,
                           interpret=True)
    rs, rl = jref.rg_lru_ref(x, a, h0)
    for got_s, got_l in ((ps, pl), (rs, rl)):
        np.testing.assert_allclose(_f32(hs), _f32(got_s), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(_f32(hl), _f32(got_l), atol=1e-5,
                                   rtol=0)
    # the op: its fused path on a CPU tensor is the plain version
    os_, ol = ops.rg_lru_scan(_t(x), _t(a), _t(h0), impl="fused")
    assert torch.equal(os_, hs) and torch.equal(ol, hl)
    zs, zl = ops.rg_lru_scan(_t(x), _t(a), impl="composite")
    js, jl = jref.rg_lru_ref(x, a)
    np.testing.assert_allclose(_f32(zs), _f32(js), atol=1e-5, rtol=0)
    assert zl.dtype == torch.float32 and zs.dtype == torch.float32


def test_rg_lru_plain_version_keeps_the_input_dtype():
    x = RNG.normal(size=(2, 33, 24)).astype(ml_dtypes.bfloat16)
    a = (0.5 + 0.49 * RNG.random(size=(2, 33, 24))).astype(
        ml_dtypes.bfloat16)
    hs, hl = ref.rg_lru_ref(_t(x), _t(a))
    ps, pl = pallas_rg_lru(x, a, interpret=True)
    assert hs.dtype == torch.bfloat16 and hl.dtype == torch.float32
    # one rounding of the same f32 value: at most one bfloat16 ulp apart
    np.testing.assert_allclose(_f32(hs), _f32(ps), atol=1e-5, rtol=2 ** -7)
    np.testing.assert_allclose(_f32(hl), _f32(pl), atol=1e-5, rtol=0)


def _offset(shape, dtype, elems=1):
    """A contiguous (B, S, D) view that starts ``elems`` elements past a
    16-byte aligned allocation."""
    n = int(np.prod(shape))
    return torch.zeros(n + elems, dtype=dtype)[elems:].view(shape)


# the kernel's route, from dtype, shape and alignment alone (the kernel
# runs on the card; the choice is plain Python, so it is checked here)
RG_LRU_ROUTE_CASES = {
    "aligned f32 D 2560": (lambda: (torch.zeros(4, 16, 2560),) * 2, "tma"),
    "aligned bf16 D 2560": (
        lambda: (torch.zeros(2, 8, 2560, dtype=torch.bfloat16),) * 2, "tma"),
    "aligned f16 D 8 (narrower than a block)": (
        lambda: (torch.zeros(2, 70, 8, dtype=torch.float16),) * 2, "tma"),
    "f32 D 33": (lambda: (torch.zeros(2, 7, 33),) * 2, "simple"),
    "x[..., 1:] view": (
        lambda: (torch.zeros(2, 8, 2561)[..., 1:],) * 2, "simple"),
    "offset view": (lambda: (_offset((2, 8, 2560), torch.float32),) * 2,
                    "simple"),
    "offset a only": (lambda: (torch.zeros(2, 8, 2560),
                               _offset((2, 8, 2560), torch.float32, 2)),
                      "simple"),
    "odd D * itemsize (bf16 D 12)": (
        lambda: (torch.zeros(1, 4, 12, dtype=torch.bfloat16),) * 2,
        "simple"),
    "mixed dtypes": (lambda: (torch.zeros(1, 4, 64),
                              torch.zeros(1, 4, 64, dtype=torch.bfloat16)),
                     "simple"),
}


@pytest.mark.parametrize("case", list(RG_LRU_ROUTE_CASES))
def test_rg_lru_route_follows_dtype_shape_and_alignment(case):
    from repro_torch.kernels import rg_lru as rl

    make, want = RG_LRU_ROUTE_CASES[case]
    x, a = make()
    assert rl.rg_lru_route(x, a) == want
    # on CPU tensors the wrapper is the plain version, whatever the route
    if x.dtype == a.dtype:
        hs, hl = rl.rg_lru(x, a, route="simple")
        ws, wl = ref.rg_lru_ref(x, a)
        assert torch.equal(hs, ws) and torch.equal(hl, wl)


# ---------------------------------------------------------------------------
# the block and its step
# ---------------------------------------------------------------------------
def _layer0(jp, tp):
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["scan"][0]["mixer"])
    tl = interop.pytree.tree_map(lambda a: a[0], tp["scan"][0]["mixer"])
    return jl, tl


def test_rglru_block_and_step_match_jax(setup):
    cfg, jcfg, jp, tp, _, _ = setup
    jl, tl = _layer0(jp, tp)
    x = RNG.normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    jo, js = JR.rglru_block(jl, jcfg, jnp.asarray(x), impl="xla",
                            return_state=True)
    to, ts = R.rglru_block(tl, cfg, _t(x), return_state=True)
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=1e-5, rtol=1e-5)
    assert list(ts) == sorted(js)                     # flatten order
    for k in ts:
        np.testing.assert_allclose(_f32(ts[k]), _f32(js[k]), atol=1e-5,
                                   rtol=1e-5)
    xt = RNG.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    jo, jn = JR.rglru_block_step(jl, jcfg, jnp.asarray(xt), js)
    before = {k: v.clone() for k, v in ts.items()}
    to, tn = R.rglru_block_step(tl, cfg, _t(xt), ts)
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=1e-5, rtol=1e-5)
    for k in tn:
        np.testing.assert_allclose(_f32(tn[k]), _f32(jn[k]), atol=1e-5,
                                   rtol=1e-5)
        assert torch.equal(ts[k], before[k])          # input not written
    empty = R.rglru_empty_state(cfg, 3, device="cpu")
    jempty = JR.rglru_empty_state(jcfg, 3)
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {k: tuple(v.shape) for k, v in jempty.items()}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _run(pkg_params, cfg, tokens, follow, *, jax_side, impl):
    """Prefill then teacher-forced decode; returns (state, last logits,
    stacked decode logits)."""
    if jax_side:
        st, lg = JT.prefill_forward(pkg_params, cfg, JParallel(),
                                    {"tokens": jnp.asarray(tokens)},
                                    S_CACHE, impl=impl)
        dec = []
        for tok in follow:
            st, d = JT.decode_step(pkg_params, cfg, JParallel(), st,
                                   jnp.asarray(tok))
            dec.append(_f32(d))
        return st, _f32(lg), np.stack(dec)
    st0, lg = T.prefill_forward(pkg_params, cfg, Parallel(),
                                {"tokens": torch.from_numpy(tokens)},
                                S_CACHE, impl=impl)
    st, dec = st0, []
    for tok in follow:
        st, d = T.decode_step(pkg_params, cfg, Parallel(), st,
                              torch.from_numpy(tok))
        dec.append(_f32(d))
    return st0, _f32(lg), np.stack(dec)


def test_prefill_and_decode_match_jax_f32(setup):
    cfg, jcfg, jp, tp, tokens, follow = setup
    js, jl = JT.prefill_forward(jp, jcfg, JParallel(),
                                {"tokens": jnp.asarray(tokens)}, S_CACHE,
                                impl="pallas_interpret")
    ts, tl = T.prefill_forward(tp, cfg, Parallel(),
                               {"tokens": torch.from_numpy(tokens)},
                               S_CACHE, impl="fused")
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=F32_TOL,
                               rtol=F32_TOL)
    jleaves = jax.tree_util.tree_leaves(js)
    tleaves = interop.pytree.tree_leaves(ts)
    assert [tuple(x.shape) for x in tleaves] == \
        [tuple(x.shape) for x in jleaves]
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=F32_TOL,
                                   rtol=F32_TOL)
    for tok in follow:
        js, jd = JT.decode_step(jp, jcfg, JParallel(), js, jnp.asarray(tok))
        ts, td = T.decode_step(tp, cfg, Parallel(), ts,
                               torch.from_numpy(tok))
        np.testing.assert_allclose(_f32(td), _f32(jd), atol=F32_TOL,
                                   rtol=F32_TOL)
    for a, b in zip(interop.pytree.tree_leaves(ts),
                    jax.tree_util.tree_leaves(js)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=F32_TOL,
                                   rtol=F32_TOL)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_prefill_and_decode_match_jax_bf16(setup):
    """bfloat16 compute: held to the JAX package directly (3e-2) and
    against both packages' float32 runs (the port no further from it
    than the reference, x1.5 in relative L2)."""
    _, _, jp, tp, tokens, follow = setup
    runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg, jcfg = _cfgs(dtype)
        impl_j = "pallas_interpret" if dtype == "float32" else "xla"
        _, jl, jd = _run(jp, jcfg, tokens, follow, jax_side=True,
                         impl=impl_j)
        _, tl, td = _run(tp, cfg, tokens, follow, jax_side=False,
                         impl="fused")
        runs[dtype] = (jl, jd, tl, td)
    jl32, jd32, _, _ = runs["float32"]
    jl, jd, tl, td = runs["bfloat16"]
    for got, want, truth in ((tl, jl, jl32), (td, jd, jd32)):
        np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)
        assert _rel(got, truth) <= BF16_MARGIN * _rel(want, truth)


def test_decode_state_from_jax_continues_decode(setup):
    cfg, jcfg, jp, tp, tokens, follow = setup
    js, _ = JT.prefill_forward(jp, jcfg, JParallel(),
                               {"tokens": jnp.asarray(tokens)}, S_CACHE,
                               impl="xla")
    ts = interop.decode_state_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, js), device="cpu")
    for tok in follow[:3]:
        js, jd = JT.decode_step(jp, jcfg, JParallel(), js, jnp.asarray(tok))
        ts, td = T.decode_step(tp, cfg, Parallel(), ts,
                               torch.from_numpy(tok))
        np.testing.assert_allclose(_f32(td), _f32(jd), atol=F32_TOL,
                                   rtol=F32_TOL)
    back = interop.decode_state_to_numpy(ts)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(js)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=F32_TOL,
                                   rtol=F32_TOL)


def test_sequential_prefill_matches_parallel_prefill(setup):
    cfg, _, _, tp, tokens, _ = setup
    tok = torch.from_numpy(tokens)
    st_seq, lg_seq = T.prefill(tp, cfg, Parallel(), tok, S_CACHE)
    st_par, lg_par = T.prefill_forward(tp, cfg, Parallel(), {"tokens": tok},
                                       S_CACHE)
    np.testing.assert_allclose(_f32(lg_seq[:, -1]), _f32(lg_par),
                               atol=F32_TOL, rtol=F32_TOL)
    for a, b in zip(interop.pytree.tree_leaves(st_seq),
                    interop.pytree.tree_leaves(st_par)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=F32_TOL,
                                   rtol=F32_TOL)


def test_init_decode_state_needs_the_card_unless_asked():
    cfg, jcfg = _cfgs()
    if torch.cuda.is_available():
        assert T.init_decode_state(cfg, 1, 8)["pos"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_decode_state(cfg, 1, 8)
    st = T.init_decode_state(cfg, 2, S_CACHE, device="cpu")
    jst = JT.init_decode_state(jcfg, 2, S_CACHE)
    assert [tuple(x.shape) for x in interop.pytree.tree_leaves(st)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(jst)]
    for a, b in zip(interop.pytree.tree_leaves(st),
                    jax.tree_util.tree_leaves(jst)):
        np.testing.assert_array_equal(_f32(a), _f32(b))


# ---------------------------------------------------------------------------
# serving: the SeqKV of this family relocates
# ---------------------------------------------------------------------------
def _state_np(jcfg, seed):
    """A batch-1 decode state of the reduced config with random content
    (bfloat16 attention caches, f32 recurrent states)."""
    rng = np.random.default_rng(seed)
    shapes = JT.init_decode_state(jcfg, 1, S_CACHE)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            return rng.integers(-1, 60, a.shape).astype(np.int32)
        return rng.standard_normal(a.shape).astype(a.dtype)
    return jax.tree_util.tree_map(fill, shapes)


def _seqkv_window(pkg, jcfg, n_keys=5):
    torch_side = pkg is TC
    g = TC.PlaceGroup(3, device="cpu") if torch_side else J.PlaceGroup(3)
    kv = pkg.DistIdMap(g)
    for p in g.members:
        kv.handle(p)
    for k in range(n_keys):
        st = _state_np(jcfg, k)
        tok = np.array([[k]], np.int32)
        if torch_side:
            st = interop.pytree.tree_map(_t, st)
            kv.put(0, k, SeqKV(st, _t(tok)))
        else:
            st = jax.tree_util.tree_map(jnp.asarray, st)
            kv.put(0, k, JSeqKV(st, jnp.asarray(tok)))
    mm = pkg.CollectiveMoveManager(g, transport="device")
    kv.move_at_sync(0, lambda k: 1 + k % 2, mm)
    mm.sync()
    out = {}
    for p in g.members:
        for k in kv.keys(p):
            v = kv.get(p, k)
            leaves = (TC.collections.tree_leaves(v) if torch_side
                      else jax.tree_util.tree_leaves(v))
            out[k] = (p, [(tensor_to_numpy(x) if torch_side
                           else np.asarray(x)).tobytes() for x in leaves])
    st = mm.last_transport_stats
    return out, tuple(getattr(st, f) for f in (
        "payloads", "rows", "row_bytes", "wire_bytes", "pad_waste_bytes",
        "width", "exchanges"))


@pytest.mark.parametrize("backend", ["fused", "composite"])
def test_seqkv_window_matches_jax(backend):
    _, jcfg = _cfgs()
    prev_t, prev_j = ops.get_backend(), jops.get_backend()
    ops.set_backend(backend)
    jops.set_backend("xla")
    try:
        got = _seqkv_window(TC, jcfg)
        want = _seqkv_window(J, jcfg)
    finally:
        ops.set_backend(prev_t)
        jops.set_backend(prev_j)
    assert got == want


def test_elastic_serving_migrates_recurrent_state():
    cfg = get_config(ARCH).reduced(n_layers=N_LAYERS, vocab_size=256)
    engine = DecodeEngine(cfg, s_cache=32, device="cpu")
    sim = RealDecodeSim(n_replicas=4, slots=16, work=(1, 1, 4, 1),
                        arrival_rate=3.0, glb_period=4, seed=1,
                        engine=engine, transport="device").run(16)
    d = sim.driver
    assert d.lost() == 0
    assert d.glb.stats.rebalances > 0 and d.transport.lifetime.exchanges >= 1
    for p in d.group.members:
        assert sorted(d.seqs.keys(p)) == sorted(d.kv.keys(p))
        for v in d.kv.handle(p).values():
            assert isinstance(v, SeqKV) and v.on_device("cpu")
            rec = v.state["suffix"][0]
            assert list(rec) == ["conv_tail", "h"]
            assert tuple(rec["h"].shape) == (1, cfg.d_model)
