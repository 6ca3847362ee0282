"""The port's elastic serving runtime, on the CPU and against the JAX
package.

* The real-decode scenarios that ``tests/test_serving_real.py`` runs on
  the JAX package, on the port with ``device="cpu"``: measured steps,
  migration of device KV with zero lost, failure re-homing, the device
  transport moving ``SeqKV`` payloads, throughput.
* The control plane, deterministically: both packages'
  ``ElasticServingDriver(engine=None)`` driven by ``step`` with the same
  synthetic decode times, admissions and a replica failure must give the
  same loads, migrations, router table and wire accounting every round
  (the pickled ``Sequence`` metadata rows differ only by the length of
  their class's module name).
* One ``SeqKV`` window on both packages' device transports: equal
  delivered bytes and equal ``TransportStats``.
* ``None`` inside a map value is structure, not a leaf: such a value
  takes the tree codec on the port's ``fused`` and ``composite`` windows
  as on the JAX package's ``xla`` window, with equal delivered values
  and equal ``TransportStats`` (on the parent commit the port pickled
  it).

Tolerance: exact — every comparison here is of counts, tables or bytes.
"""
import contextlib
import gc
import weakref

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.kernels import ops as jops
from repro.serving import ElasticServingDriver as JDriver
from repro.serving import SeqKV as JSeqKV
from repro_torch.core import GLBConfig
from repro_torch.core.interop import tensor_to_numpy
from repro_torch.kernels import ops as tops
from repro_torch.serving import (DecodeEngine, ElasticServingDriver,
                                 RealDecodeSim, SeqKV, serving_config)

STAT_FIELDS = ("payloads", "local", "rows", "row_bytes", "wire_bytes",
               "pad_waste_bytes", "width", "exchanges")


@contextlib.contextmanager
def backends(torch_backend="auto", jax_backend="xla"):
    pt, pj = tops.get_backend(), jops.get_backend()
    tops.set_backend(torch_backend)
    jops.set_backend(jax_backend)
    try:
        yield
    finally:
        tops.set_backend(pt)
        jops.set_backend(pj)


@pytest.fixture(scope="module")
def engine():
    """One shared engine so the module reuses its warmed buckets."""
    return DecodeEngine(serving_config(n_layers=2, d_model=64, d_ff=128,
                                       vocab_size=256), s_cache=32,
                        device="cpu")


# ---------------------------------------------------------------------------
# the real-decode scenarios of tests/test_serving_real.py
# ---------------------------------------------------------------------------
class TestDecodeEngine:
    def test_measured_step_advances_tokens(self, engine):
        kvs = [engine.new_seq(8) for _ in range(3)]
        before = [int(kv.state["pos"]) for kv in kvs]
        dt = engine.decode_batch(kvs)
        assert dt > 0.0                      # wall clock, not a model
        for kv, b in zip(kvs, before):
            assert int(kv.state["pos"]) == b + 1
            assert kv.token.shape == (1, 1) and kv.on_device("cpu")

    def test_work_multiplier_really_runs(self, engine):
        kvs = [engine.new_seq(8)]
        t1 = min(engine.decode_batch(kvs) for _ in range(3))
        t4 = min(engine.decode_batch(kvs, work=8) for _ in range(3))
        assert t4 > 2.0 * t1                 # 8x the compute, measured

    def test_bucket_padding_keeps_results(self, engine):
        """Padding to a bucket must not perturb the real sequences."""
        a = [engine.new_seq(4) for _ in range(2)]
        b = [engine.new_seq(4) for _ in range(2)]
        for kv_a, kv_b in zip(a, b):         # identical start states
            kv_b.state = kv_a.state
            kv_b.token = kv_a.token
        engine.decode_batch(a)               # bucket 2
        engine.decode_batch(b + [engine.new_seq(4)])   # 3 → pad to 4
        assert torch.equal(a[0].token, b[0].token)

    def test_seq_kv_owns_contiguous_leaves(self, engine):
        kvs = [engine.new_seq(5) for _ in range(3)]
        engine.decode_batch(kvs)
        ptrs = set()
        for kv in kvs:
            for leaf in T.collections.tree_leaves(kv):
                assert leaf.is_contiguous()
                assert leaf.untyped_storage().nbytes() == leaf.nbytes
                ptrs.add(leaf.data_ptr())
        assert len(ptrs) == 5 * len(kvs)     # no two leaves share storage

    def test_engine_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default is valid here")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DecodeEngine()


class TestRealDataPlane:
    def test_migration_moves_device_kv_zero_lost(self, engine):
        sim = RealDecodeSim(n_replicas=4, slots=16, work=(1, 1, 4, 1),
                            arrival_rate=3.0, glb_period=4, seed=1,
                            engine=engine).run(24)
        d = sim.driver
        assert d.lost() == 0
        st = d.glb.stats
        assert st.rebalances > 0 and st.bytes_moved > 0
        for p in d.group.members:
            assert sorted(d.seqs.keys(p)) == sorted(d.kv.keys(p))
            for v in d.kv.handle(p).values():
                assert isinstance(v, SeqKV) and v.on_device("cpu")
        assert d.seqs.local_size(2) < np.mean(
            [d.seqs.local_size(p) for p in d.group.members if p != 2])

    def test_failure_rehomes_device_kv(self, engine):
        sim = RealDecodeSim(n_replicas=4, slots=16, arrival_rate=3.0,
                            fail_at={8: 1}, glb_period=4, seed=2,
                            engine=engine).run(20)
        d = sim.driver
        assert d.evicted == [1] and 1 not in d.group.members
        assert d.lost() == 0 and d.rehomed_seqs > 0
        for p in d.group.members:
            for v in d.kv.handle(p).values():
                assert v.on_device("cpu")

    def test_decode_round_requires_engine(self):
        d = ElasticServingDriver(2, device="cpu")
        with pytest.raises(ValueError, match="engine"):
            d.decode_round()

    @pytest.mark.parametrize("backend", ["fused", "composite"])
    def test_device_transport_moves_kv(self, engine, backend):
        from repro_torch.core import DeviceTransport

        with backends(backend):
            sim = RealDecodeSim(n_replicas=4, slots=48, preload=(0, 24),
                                arrival_rate=2.0, glb_period=3, seed=1,
                                engine=engine, transport="device").run(12)
        d = sim.driver
        assert isinstance(d.transport, DeviceTransport)
        assert d.lost() == 0
        assert d.glb.stats.rebalances > 0
        assert d.transport.lifetime.exchanges >= 1
        assert d.transport.lifetime.row_bytes > 0
        assert d.transport.lifetime.codec_backend == backend
        for p in d.group.members:
            assert sorted(d.seqs.keys(p)) == sorted(d.kv.keys(p))
            for v in d.kv.handle(p).values():
                assert v.on_device("cpu")
        assert np.asarray(sim.window_p95()).size > 0

    def test_throughput_positive_and_tokens_counted(self, engine):
        sim = RealDecodeSim(n_replicas=2, slots=8, arrival_rate=2.0,
                            seed=3, engine=engine).run(10)
        assert sim.tokens > 0
        assert sim.throughput() > 0

    def test_router_device_table_lives_on_the_group_device(self, engine):
        sim = RealDecodeSim(n_replicas=3, slots=8, arrival_rate=2.0,
                            seed=4, engine=engine).run(6)
        r = sim.driver.router
        t = r.device_table()
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), r.table)

    def test_driver_and_its_kv_are_freed_without_a_collection(self, engine):
        """Dropping the simulation frees the driver and every ``SeqKV``
        at once: no reference cycle (the balancer's window hook, a
        finished window's collections) keeps them, and their device
        memory, until the garbage collector runs."""
        gc.collect()
        gc.disable()
        try:
            sim = RealDecodeSim(n_replicas=4, slots=16, work=(1, 1, 3, 1),
                                preload=(2, 24), arrival_rate=3.0,
                                glb_period=4, pipeline_depth=2, seed=1,
                                engine=engine, transport="device").run(12)
            d = sim.driver
            assert d.glb.stats.rebalances > 0
            # a SeqKV has slots and no weak reference: watch its token
            kv = [v.token for p in d.group.members
                  for v in d.kv.handle(p).values()]
            assert kv
            refs = [weakref.ref(d)] + [weakref.ref(t) for t in kv]
            del sim, d, kv
            assert [r() for r in refs if r() is not None] == []
        finally:
            gc.enable()


# ---------------------------------------------------------------------------
# the control plane, against the JAX package
# ---------------------------------------------------------------------------
def _drive_control_plane(driver_cls, kw, rounds=28, seed=5):
    """Admissions, synthetic decode times with a slow replica and a
    failure; the per-round observables in package-neutral form."""
    d = driver_cls(4, slots_per_replica=12,
                   glb=kw["glb"], heartbeat_timeout=2, transport="device",
                   **kw["extra"])
    rng = np.random.default_rng(seed)
    speeds = np.array([1.0, 1.0, 0.35, 1.0])
    trace = []
    for it in range(rounds):
        for _ in range(rng.poisson(2.5)):
            d.admit(int(rng.integers(8, 48)), int(rng.integers(6, 20)))
        failed = {3} if it >= 18 else set()
        t = np.full(4, np.nan)
        for p in d.group.members:
            if p not in failed:
                t[p] = (1e-3 + 2e-5 * d.workload.pages_of(p)) / speeds[p]
        info = d.step(t, failed=failed)
        rb = info.get("rebalance")
        life = d.transport.lifetime
        trace.append((
            it, tuple(d.group.members), tuple(int(x) for x in d.loads()),
            tuple(d.completed), tuple(info.get("evicted", ())),
            None if rb is None else tuple(tuple(int(v) for v in m)
                                          for m in rb.moves),
            d.workload.last_moved_seqs, d.workload.migrated_pages,
            d.glb.stats.rebalances, d.glb.stats.bytes_moved,
            int(d.router.base), tuple(int(x) for x in d.router.table),
            tuple(getattr(life, f) for f in STAT_FIELDS)))
    d.sync()
    assert d.lost() == 0
    return trace


@pytest.mark.parametrize("depth", [1, 2])
def test_control_plane_matches_jax(depth):
    jcfg = J.GLBConfig(period=3, policy="proportional", ema=0.3,
                       asynchronous=False, pipeline_depth=depth)
    tcfg = GLBConfig(period=3, policy="proportional", ema=0.3,
                     asynchronous=False, pipeline_depth=depth)
    with backends("fused", "xla"):
        want = _drive_control_plane(JDriver, {"glb": jcfg, "extra": {}})
        got = _drive_control_plane(ElasticServingDriver,
                                   {"glb": tcfg,
                                    "extra": {"device": "cpu"}})
    assert any(row[5] for row in want)           # rebalances happened
    assert any(row[4] for row in want)           # and an eviction
    rows_i, rb_i, pad_i = (STAT_FIELDS.index(f) for f in
                           ("rows", "row_bytes", "pad_waste_bytes"))
    for g, w in zip(got, want):
        assert g[:-1] == w[:-1], f"round {w[0]} differs"
        gs, ws = list(g[-1]), list(w[-1])
        # a migrated sequence ships two rows: its KV pages (equal bytes)
        # and its pickled Sequence, which names its class's module —
        # "repro_torch.serving.cache" is 6 bytes longer than the
        # reference's "repro.serving.cache"
        assert gs[rb_i] - ws[rb_i] == 6 * (ws[rows_i] // 2)
        assert gs[pad_i] - ws[pad_i] == -(gs[rb_i] - ws[rb_i])
        for i in (rb_i, pad_i):
            gs[i] = ws[i]
        assert gs == ws, f"round {w[0]}: wire accounting differs"


# ---------------------------------------------------------------------------
# one SeqKV window on both device transports
# ---------------------------------------------------------------------------
def _state_np(seed):
    """A batch-1 decode state of the serving config (2 layers), random
    bfloat16 caches, in the reference's leaf order."""
    rng = np.random.default_rng(seed)
    kv = lambda: rng.standard_normal((2, 1, 16, 2, 16)).astype(
        ml_dtypes.bfloat16)
    return {"pos": np.array([seed + 3], np.int32), "prefix": (),
            "scan": ({"k": kv(), "pos": rng.integers(
                -1, 40, (2, 1, 16)).astype(np.int32), "v": kv()},),
            "suffix": ()}


def _seqkv_window(pkg, n_keys=5):
    torch_side = pkg is T
    g = T.PlaceGroup(3, device="cpu") if torch_side else J.PlaceGroup(3)
    kv = pkg.DistIdMap(g)
    for p in g.members:
        kv.handle(p)
    for k in range(n_keys):
        st = _state_np(k)
        tok = np.array([[k]], np.int32)
        if torch_side:
            from repro_torch.core.interop import tensor_from_numpy
            conv = lambda a: tensor_from_numpy(a, "cpu")  # noqa: E731
            st = torch.utils._pytree.tree_map(conv, st)
            kv.put(0, k, SeqKV(st, conv(tok)))
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
            leaves = (T.collections.tree_leaves(v) if torch_side
                      else jax.tree_util.tree_leaves(v))
            out[k] = (p, [np.asarray(tensor_to_numpy(x) if torch_side
                                     else np.asarray(x)).tobytes()
                          for x in leaves])
            if torch_side:
                assert v.on_device("cpu")
    st = mm.last_transport_stats
    return out, tuple(getattr(st, f) for f in STAT_FIELDS)


@pytest.mark.parametrize("backend", ["fused", "composite"])
def test_seqkv_window_matches_jax(backend):
    with backends(backend, "xla"):
        got = _seqkv_window(T)
        want = _seqkv_window(J)
    assert got[1] == want[1]
    assert got[0] == want[0]


# ---------------------------------------------------------------------------
# None inside a value is structure, not a leaf
# ---------------------------------------------------------------------------
def _none_value_window(pkg):
    torch_side = pkg is T
    g = T.PlaceGroup(2, device="cpu") if torch_side else J.PlaceGroup(2)
    m = pkg.DistIdMap(g)
    for p in g.members:
        m.handle(p)
    for k in range(4):
        page = np.full((4, 8), k, np.float32)
        pos = np.full((1, 1), k, np.int32)
        if torch_side:
            page, pos = torch.from_numpy(page), torch.from_numpy(pos)
        else:
            page, pos = jnp.asarray(page), jnp.asarray(pos)
        m.put(0, k, {"k": page, "v": page, "pos": pos, "cross_kv": None})
    mm = pkg.CollectiveMoveManager(g, transport="device")
    m.move_at_sync(0, lambda k: 1, mm)
    mm.sync()
    vals = {}
    for k in m.keys(1):
        v = m.get(1, k)
        assert v["cross_kv"] is None
        if torch_side:
            assert v["k"] is v["v"]          # the alias was rebound
        vals[k] = tuple((f, np.asarray(v[f]).tobytes())
                        for f in ("k", "pos", "v"))
    st = mm.last_transport_stats
    return vals, tuple(getattr(st, f) for f in STAT_FIELDS), mm


@pytest.mark.parametrize("backend", ["fused", "composite"])
def test_none_leaf_value_takes_the_tree_codec(backend):
    with backends(backend, "xla"):
        got_vals, got_stats, _ = _none_value_window(T)
        want_vals, want_stats, _ = _none_value_window(J)
    assert got_vals == want_vals
    assert got_stats == want_stats
    # 4 keys x (one aliased 128 B page + a 4 B position): no pickle bytes
    assert got_stats[STAT_FIELDS.index("row_bytes")] == 4 * (128 + 4)


def test_none_is_structure_in_the_byte_accounting():
    from repro_torch.core.collections import (_value_nbytes, tree_flatten,
                                              tree_unflatten)
    t = torch.zeros(3)
    v = {"a": None, "b": t, "c": (None, t)}
    leaves, spec = tree_flatten(v)
    assert leaves == [t, t] or all(x is t for x in leaves)
    back = tree_unflatten(leaves, spec)
    assert back["a"] is None and back["c"][0] is None and back["b"] is t
    assert _value_nbytes(v) == 12            # one buffer, counted once
    assert _value_nbytes(None) == 0
    kv = SeqKV({"pos": t, "cross_kv": None}, torch.zeros((1, 1),
                                                         dtype=torch.int32))
    assert kv.nbytes == 12 + 4 and kv.on_device("cpu")
