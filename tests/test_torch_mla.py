"""The port's deepseek-v2-lite slice (MLA + MoE) against the JAX package.

Parameters come from one JAX ``zoo.init_params`` of the reduced config
(2 layers: a dense first layer and one MLA + MoE layer; d_model 64, 4
heads, kv_lora 32, qk 16 + 8, v 16, 4 experts top-2, 1 shared), carried
across with ``core.interop.params_from_numpy``; inputs come from numpy
seeds.  On the CPU the flash kernel's wrapper takes ``flash_ref`` and
the MoE kernels' wrappers their plain versions.

* ``mla_forward``, ``mla_decode_project``, ``mla_attend_cache`` and
  ``mla_decode`` against the JAX module in float32, within ``1e-5``.
* The slice as a whole: ``prefill_forward`` (the JAX package's through
  its Pallas flash kernel in interpret mode) and 4 teacher-forced
  ``decode_step`` s, float32 within ``1e-4`` and bfloat16 within
  ``3e-2`` (``tests/test_torch_model.py``'s tolerances); the decode
  state leaf for leaf, and its layout that of ``init_decode_state``.
* A JAX decode state continued by the port; the sequential prefill
  against the parallel one.
* Serving: both packages' ``ElasticServingDriver`` with a
  ``DecodeEngine`` of this config (one set of parameters, float32) and
  the same admissions, decoding for real but reporting a synthetic
  decode time (so the control plane is deterministic): equal loads,
  completions, migrations, router table and wire accounting every round
  (the pickled ``Sequence`` rows differ only by the length of their
  class's module name), then every ``SeqKV`` equal in layout and within
  ``1e-4``.  And one window of this family's ``SeqKV`` through both
  packages' device transports: equal bytes and ``TransportStats``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.models.moe as JM
import repro.models.transformer as JT
import repro_torch.core as TC
from repro.configs import get_config as j_get_config
from repro.core import GLBConfig as JGLBConfig
from repro.kernels import ops as jops
from repro.models import Parallel as JParallel
from repro.models import zoo as jzoo
from repro.serving import DecodeEngine as JDecodeEngine
from repro.serving import ElasticServingDriver as JDriver
from repro.serving import SeqKV as JSeqKV
from repro_torch.configs import get_config
from repro_torch.core import GLBConfig, interop
from repro_torch.core.interop import tensor_from_numpy, tensor_to_numpy
from repro_torch.kernels import ops
from repro_torch.models import Parallel
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serving import DecodeEngine, ElasticServingDriver, SeqKV

ARCH = "deepseek_v2_lite_16b"
S_CACHE = 16
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
STAT_FIELDS = ("payloads", "local", "rows", "row_bytes", "wire_bytes",
               "pad_waste_bytes", "width", "exchanges")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _paths(tree, prefix=""):
    """(path, shape, dtype name) of every leaf in flatten order, for a
    tree of either package (dict keys sorted, None is structure)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _paths(v, f"{prefix}/{i}")]
    if tree is None:
        return []
    return [(prefix, tuple(tree.shape),
             str(tree.dtype).replace("torch.", ""))]


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
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    follow = rng.integers(0, cfg.vocab_size, (4, 2, 1)).astype(np.int32)
    return cfg, jcfg, jp, tp, tokens, follow


def _layer(tree):
    """The MLA parameters of the first MLA + MoE layer (scan period 0)."""
    if isinstance(tree["scan"][0]["mixer"]["wo"]["w"], torch.Tensor):
        return interop.pytree.tree_map(lambda a: a[0],
                                       tree["scan"][0]["mixer"])
    return jax.tree_util.tree_map(lambda a: a[0], tree["scan"][0]["mixer"])


def test_params_carry_across_and_own_init_has_their_layout(setup):
    cfg, _, jp, tp, _, _ = setup
    assert _paths(tp) == _paths(jp)
    # the reference's empty marker crosses as structure
    assert jp["scan"][0]["shared_norm_alias"] == ()
    assert tp["scan"][0]["shared_norm_alias"] == ()
    from repro_torch.models import zoo
    own = zoo.init_params(cfg, 3, device="cpu")
    assert _paths(own) == _paths(tp)
    assert own["scan"][0]["shared_norm_alias"] == ()


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
def test_mla_forward_matches_jax(setup):
    cfg, jcfg, jp, tp, _, _ = setup
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(10, dtype=np.int32), (2, 1))
    jo, (jc, jk) = JM.mla_forward(_layer(jp), jcfg, jnp.asarray(x),
                                  jnp.asarray(pos), impl="xla")
    for impl in ("fused", "composite"):
        to, (tc, tk) = M.mla_forward(_layer(tp), cfg, _t(x), _t(pos),
                                     impl=impl)
        for a, b in ((to, jo), (tc, jc), (tk, jk)):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-5,
                                       rtol=1e-5)


def test_mla_decode_pieces_match_jax(setup):
    cfg, jcfg, jp, tp, _, _ = setup
    rng = np.random.default_rng(2)
    B, size = 2, 8
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([[3], [9]], np.int32)           # the second wraps
    ckv = rng.standard_normal((B, size, cfg.kv_lora_rank)).astype(
        np.float32)
    krp = rng.standard_normal((B, size, cfg.qk_rope_dim)).astype(
        np.float32)
    cpos = np.tile(np.arange(size, dtype=np.int32) - 2, (B, 1))
    jl, tl = _layer(jp), _layer(tp)
    (jqn, jqr), jc, jk = JM.mla_decode_project(jl, jcfg, jnp.asarray(x),
                                               jnp.asarray(pos))
    (tqn, tqr), tc, tk = M.mla_decode_project(tl, cfg, _t(x), _t(pos))
    for a, b in ((tqn, jqn), (tqr, jqr), (tc, jc), (tk, jk)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-5, rtol=1e-5)
    ja = JM.mla_attend_cache(jl, jcfg, (jqn, jqr), jnp.asarray(ckv),
                             jnp.asarray(krp), jnp.asarray(cpos),
                             jnp.asarray(pos))
    ta = M.mla_attend_cache(tl, cfg, (tqn, tqr), _t(ckv), _t(krp),
                            _t(cpos), _t(pos))
    np.testing.assert_allclose(_f32(ta), _f32(ja), atol=1e-5, rtol=1e-5)
    jd = JM.mla_decode(jl, jcfg, jnp.asarray(x), jnp.asarray(pos),
                       jnp.asarray(ckv), jnp.asarray(krp), jnp.asarray(cpos))
    td = M.mla_decode(tl, cfg, _t(x), _t(pos), _t(ckv), _t(krp), _t(cpos))
    for a, b in zip(td, jd):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------
def test_init_decode_state_layout_matches(setup):
    cfg = setup[0]
    jst = JT.init_decode_state(cfg, 3, S_CACHE)
    tst = T.init_decode_state(cfg, 3, S_CACHE, device="cpu")
    assert _paths(tst) == _paths(jst)
    assert list(tst["scan"][0]) == ["ckv", "krope", "pos"]
    for a, b in zip(interop.pytree.tree_leaves(tst),
                    jax.tree_util.tree_leaves(jst)):
        np.testing.assert_array_equal(_f32(a), _f32(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(setup, dtype):
    cfg0, jcfg0, jp, tp, tokens, follow = setup
    cfg = dataclasses.replace(cfg0, dtype=dtype)
    jcfg = dataclasses.replace(jcfg0, dtype=dtype)
    tol = TOL[dtype]
    js, jl = JT.prefill_forward(jp, jcfg, JParallel(),
                                {"tokens": jnp.asarray(tokens)}, S_CACHE,
                                impl="pallas_interpret")
    ts, tl = T.prefill_forward(tp, cfg, Parallel(),
                               {"tokens": torch.from_numpy(tokens)},
                               S_CACHE, impl="fused")
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=tol, rtol=tol)
    assert _paths(ts) == _paths(js)
    assert _paths(ts) == _paths(T.init_decode_state(
        cfg, tokens.shape[0], S_CACHE, device="cpu"))
    for a, b in zip(interop.pytree.tree_leaves(ts),
                    jax.tree_util.tree_leaves(js)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=tol, rtol=tol)
    for tok in follow:
        js, jl = JT.decode_step(jp, jcfg, JParallel(), js, jnp.asarray(tok))
        ts, tl = T.decode_step(tp, cfg, Parallel(), ts,
                               torch.from_numpy(tok))
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=tol, rtol=tol)
    for a, b in zip(interop.pytree.tree_leaves(ts),
                    jax.tree_util.tree_leaves(js)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=tol, rtol=tol)


def test_decode_state_from_jax_continues_decode(setup):
    cfg, jcfg, jp, tp, tokens, follow = setup
    js, _ = JT.prefill_forward(jp, jcfg, JParallel(),
                               {"tokens": jnp.asarray(tokens)}, S_CACHE,
                               impl="xla")
    ts = interop.decode_state_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, js), device="cpu")
    _, jl = JT.decode_step(jp, jcfg, JParallel(), js, jnp.asarray(follow[0]))
    _, tl = T.decode_step(tp, cfg, Parallel(), ts,
                          torch.from_numpy(follow[0]))
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4, rtol=1e-4)


def test_sequential_prefill_matches_parallel_prefill(setup):
    cfg, _, _, tp, tokens, _ = setup
    tok = torch.from_numpy(tokens)
    st_seq, lg_seq = T.prefill(tp, cfg, Parallel(), tok, S_CACHE)
    st_par, lg_par = T.prefill_forward(tp, cfg, Parallel(), {"tokens": tok},
                                       S_CACHE)
    np.testing.assert_allclose(_f32(lg_seq[:, -1]), _f32(lg_par),
                               atol=1e-4, rtol=1e-4)
    for a, b in zip(interop.pytree.tree_leaves(st_seq),
                    interop.pytree.tree_leaves(st_par)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
class _SyntheticTime:
    """A ``DecodeEngine`` that decodes for real but reports a decode time
    made from the batch size and the replica's work, so both packages'
    control planes see the same numbers."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def decode_batch(self, seq_kvs, *, work=1):
        self.engine.decode_batch(seq_kvs)
        return work * (1e-3 + 1e-4 * len(seq_kvs))


def _drive_serving(driver_cls, glb_cls, engine, extra, rounds=12, seed=7):
    d = driver_cls(4, slots_per_replica=8,
                   glb=glb_cls(period=3, policy="proportional", ema=0.3,
                               asynchronous=False, pipeline_depth=1),
                   heartbeat_timeout=2, engine=_SyntheticTime(engine),
                   transport="device", **extra)
    rng = np.random.default_rng(seed)
    for _ in range(10):                          # a hot replica
        d.admit(int(rng.integers(4, 12)), int(rng.integers(10, 14)),
                place=2)
    trace = []
    for it in range(rounds):
        for _ in range(rng.poisson(1.5)):
            d.admit(int(rng.integers(4, 12)), int(rng.integers(3, 8)))
        info = d.decode_round(work=(1, 1, 3, 1))
        rb = info.get("rebalance")
        life = d.transport.lifetime
        trace.append((
            it, tuple(int(x) for x in d.loads()), tuple(d.completed),
            None if rb is None else tuple(tuple(int(v) for v in m)
                                          for m in rb.moves),
            d.workload.last_moved_seqs, d.glb.stats.rebalances,
            tuple(int(x) for x in d.router.table),
            tuple(getattr(life, f) for f in STAT_FIELDS)))
    d.sync()
    assert d.lost() == 0
    kv = {(p, sid): d.kv.get(p, sid) for p in d.group.members
          for sid in d.kv.keys(p)}
    return trace, kv


def test_serving_matches_jax(setup):
    """Control plane and SeqKVs of the two packages' serving runtimes."""
    cfg, jcfg, jp, _, _, _ = setup
    jeng = JDecodeEngine(jcfg, s_cache=32, max_batch=4, seed=5)
    jeng.params = jp
    teng = DecodeEngine(cfg, s_cache=32, max_batch=4, seed=5, device="cpu")
    teng.params = T.cast_params(interop.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu"), cfg)
    prev_t, prev_j = ops.get_backend(), jops.get_backend()
    ops.set_backend("fused")
    jops.set_backend("xla")
    try:
        want, jkv = _drive_serving(JDriver, JGLBConfig, jeng, {})
        got, tkv = _drive_serving(ElasticServingDriver, GLBConfig, teng,
                                  {"device": "cpu"})
    finally:
        ops.set_backend(prev_t)
        jops.set_backend(prev_j)
    assert any(row[3] for row in want)                 # migrations ran
    rows_i, rb_i, pad_i = (STAT_FIELDS.index(f) for f in
                           ("rows", "row_bytes", "pad_waste_bytes"))
    for g, w in zip(got, want):
        assert g[:-1] == w[:-1], f"round {w[0]} differs"
        gs, ws = list(g[-1]), list(w[-1])
        # a migrated sequence ships its SeqKV (equal bytes) and its
        # pickled Sequence, whose class's module name is 6 bytes longer
        assert gs[rb_i] - ws[rb_i] == 6 * (ws[rows_i] // 2)
        assert gs[pad_i] - ws[pad_i] == -(gs[rb_i] - ws[rb_i])
        gs[rb_i], gs[pad_i] = ws[rb_i], ws[pad_i]
        assert gs == ws, f"round {w[0]}: wire accounting differs"
    assert sorted(tkv) == sorted(jkv)
    for key, jv in jkv.items():
        tv = tkv[key]
        assert isinstance(tv, SeqKV)
        assert _paths(tv.state) == _paths(jv.state)
        assert tv.nbytes == jv.nbytes
        assert np.array_equal(tv.token.numpy(), np.asarray(jv.token))
        for a, b in zip(interop.pytree.tree_leaves(tv.state),
                        jax.tree_util.tree_leaves(jv.state)):
            np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-4,
                                       rtol=1e-4)


def _state_np(jcfg, seed):
    """A batch-1 decode state of the reduced config with random content
    (bfloat16 latent caches, int32 positions)."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            return rng.integers(-1, 60, a.shape).astype(np.int32)
        return rng.standard_normal(a.shape).astype(a.dtype)
    return jax.tree_util.tree_map(fill, JT.init_decode_state(jcfg, 1,
                                                             S_CACHE))


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
            kv.put(0, k, SeqKV(interop.pytree.tree_map(_t, st), _t(tok)))
        else:
            kv.put(0, k, JSeqKV(jax.tree_util.tree_map(jnp.asarray, st),
                                jnp.asarray(tok)))
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
    _, jcfg = _cfgs("bfloat16")
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
