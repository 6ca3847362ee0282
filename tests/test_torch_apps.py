"""The port's accumulator, ranged-list product and the paper's three
applications (K-Means, MolDyn, PlhamJ) against the JAX package.

Inputs come from numpy seeds; both packages draw their data from
``np.random.default_rng(seed)`` in the same order, and the port runs on
the CPU (``device="cpu"``).  The JAX side relocates through its
``HostTransport`` (the reference's fused Pallas codec does not run on
this JAX); the port's side also runs with ``transport="device"`` under
the ``fused`` backend, whose kernels take their plain versions on CPU
tensors, and must give the same results as its host transport.

Tolerances:
* ``Accumulator.totals`` equal to the reference's bit for bit (both sum
  the grains in the same fixed order), and within 1e-9 of a serial sum;
* ``segment_accept`` (float32) within 1e-6 of ``repro.core``'s, and
  equal to itself on a second call;
* ``teamed_split``: the same tile lists, place by place, for every
  argument set; the tiles cover each pair exactly once;
* K-Means centroids within 1e-9 with the same assignments; MolDyn
  positions within rtol 1e-10 with equal ``allreduce_bytes``; PlhamJ
  with equal ``distribution_history`` and ``relocated``, and
  ``sim_time`` within rtol 1e-12 (the scenarios of
  ``tests/test_substrates.py``).
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps as JA
import repro.core as J
import repro_torch.apps as TA
import repro_torch.core as T
from _hyp import given, settings, st
from repro_torch.kernels import ops as tops

CPU = "cpu"


@contextlib.contextmanager
def backend(name):
    prev = tops.get_backend()
    tops.set_backend(name)
    try:
        yield
    finally:
        tops.set_backend(prev)


# ---------------------------------------------------------------------------
# Accumulator and segment_accept
# ---------------------------------------------------------------------------
@settings(max_examples=30, deadline=None)
@given(grains=st.integers(1, 6), n=st.integers(1, 50),
       adds=st.lists(st.tuples(st.integers(0, 49), st.floats(-5, 5)),
                     max_size=30))
def test_accumulator_matches_the_reference_and_a_serial_sum(grains, n, adds):
    jacc = J.Accumulator(J.LongRange(0, n), ())
    tacc = T.Accumulator(T.LongRange(0, n), (), device=CPU)
    jbufs = [jacc.grain() for _ in range(grains)]
    tbufs = [tacc.grain() for _ in range(grains)]
    serial = np.zeros(n)
    for i, (idx, val) in enumerate(adds):
        idx = idx % n
        jacc.add(jbufs[i % grains], idx, val)
        tacc.add(tbufs[i % grains], idx, val)
        serial[idx] += val
    got = tacc.totals()
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), jacc.totals())
    np.testing.assert_allclose(got.numpy(), serial, rtol=1e-9, atol=1e-9)
    assert tacc.buffers_allocated == jacc.buffers_allocated


@pytest.mark.parametrize("block", [1, 4, 256])
@pytest.mark.parametrize("start", [0, 7])
def test_sparse_accumulator_matches_the_reference(block, start):
    rng = np.random.default_rng(block + start)
    n = 37
    r_j, r_t = J.LongRange(start, start + n), T.LongRange(start, start + n)
    jacc = J.Accumulator(r_j, (3,), sparse=True, block=block)
    tacc = T.Accumulator(r_t, (3,), sparse=True, block=block, device=CPU)
    for g in range(3):
        jv, tv = jacc.grain(), tacc.grain()
        for _ in range(20):
            idx = int(rng.integers(start, start + n))
            val = rng.standard_normal(3)
            jv.add(idx, val)
            tv.add(idx, torch.from_numpy(val))
    np.testing.assert_array_equal(tacc.totals().numpy(), jacc.totals())
    assert tacc.buffers_allocated == jacc.buffers_allocated
    seen = []
    tacc.accept(lambda i, v: seen.append((i, v.clone())))
    assert [i for i, _ in seen] == list(range(start, start + n))
    assert tacc.buffers_allocated == 0


def test_accumulator_accept_into_and_dtype():
    acc = T.Accumulator(T.LongRange(0, 4), (2,), torch.float32, device=CPU)
    b = acc.grain()
    acc.add(b, 2, torch.tensor([1.0, 2.0]))
    out = acc.accept_into(torch.ones(4, 2))
    assert out.dtype == torch.float32
    assert out[2].tolist() == [2.0, 3.0] and out[0].tolist() == [1.0, 1.0]
    assert acc.buffers_allocated == 0


@pytest.mark.parametrize("shape", [(1, 8, ()), (3, 50, (4,)), (4, 17, (2, 3))])
def test_segment_accept_matches_the_reference(shape):
    G, N, trail = shape
    rng = np.random.default_rng(N)
    partials = rng.standard_normal((G, N) + trail).astype(np.float32)
    num = 6
    # repeated ids, and ids outside [0, num) (dropped, as segment_sum does)
    ids = rng.integers(-2, num + 2, N).astype(np.int32)
    want = np.asarray(J.segment_accept(jnp.asarray(partials),
                                       jnp.asarray(ids), num))
    got = T.segment_accept(torch.from_numpy(partials),
                           torch.from_numpy(ids), num)
    again = T.segment_accept(torch.from_numpy(partials),
                             torch.from_numpy(ids), num)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, again)


# ---------------------------------------------------------------------------
# RangedListProduct
# ---------------------------------------------------------------------------
def _tile_key(t):
    return (t.rows.start, t.rows.end, t.cols.start, t.cols.end, t.diagonal)


@pytest.mark.parametrize("n", [2, 27, 125, 300])
@pytest.mark.parametrize("ndiv,n_places", [(1, 1), (3, 3), (5, 4), (8, 6)])
def test_teamed_split_assigns_the_reference_tiles(n, ndiv, n_places):
    for seed in range(4):
        want = J.RangedListProduct.new_product_triangle(n).teamed_split(
            ndiv, ndiv, n_places, seed)
        got = T.RangedListProduct.new_product_triangle(n).teamed_split(
            ndiv, ndiv, n_places, seed)
        assert [[_tile_key(t) for t in s.tiles] for s in got] == \
            [[_tile_key(t) for t in s.tiles] for s in want]
        assert [s.total_pairs() for s in got] == \
            [s.total_pairs() for s in want]


@settings(max_examples=30, deadline=None)
@given(n=st.integers(2, 300), ndiv=st.integers(1, 8),
       n_places=st.integers(1, 6), seed=st.integers(0, 10))
def test_teamed_split_covers_each_pair_once(n, ndiv, n_places, seed):
    prod = T.RangedListProduct.new_product_triangle(n)
    splits = prod.teamed_split(ndiv, ndiv, n_places, seed)
    assert sum(s.total_pairs() for s in splits) == n * (n - 1) // 2
    seen = set()
    for s in splits:
        s.for_each_pair(lambda i, j: seen.add((i, j)))
    assert len(seen) == n * (n - 1) // 2


@pytest.mark.parametrize("n,ndiv", [(27, 3), (50, 4), (9, 1)])
def test_pair_indices_follow_for_each_pair(n, ndiv):
    for tile in T.RangedListProduct(n).split(ndiv, ndiv).tiles:
        ii, jj = tile.pair_indices(CPU)
        assert ii.dtype == jj.dtype == torch.int64
        want = []
        T.RangedListProduct(n, [tile]).for_each_pair(
            lambda i, j: want.append((i, j)))
        assert list(zip(ii.tolist(), jj.tolist())) == want
        assert len(want) == tile.pairs


def test_causal_block_mask_matches_the_reference():
    want = J.RangedListProduct(40).split(4, 4).causal_block_mask(4, 4)
    got = T.RangedListProduct(40).split(4, 4).causal_block_mask(4, 4)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# K-Means
# ---------------------------------------------------------------------------
def _assignments(km, dim):
    """Cluster of every point, by global index."""
    out = {}
    for p in km.group.members:
        if not km.points.local_size(p):
            continue
        rows, idx = km.points.to_local_matrix(p)
        out.update(zip(np.asarray(idx).tolist(),
                       np.asarray(rows[:, dim]).tolist()))
    return [out[i] for i in sorted(out)]


def test_kmeans_converges():
    km = TA.KMeans(n_places=4, n_points=1500, dim=3, k=6, seed=0, device=CPU)
    i0 = km.inertia()
    for _ in range(10):
        km.iterate()
    assert km.inertia() < 0.8 * i0


def test_kmeans_teamed_equals_single_place():
    kms = [TA.KMeans(n_places=n, n_points=1000, dim=3, k=5, seed=7,
                     device=CPU) for n in (1, 4)]
    for _ in range(5):
        for km in kms:
            km.iterate()
    np.testing.assert_allclose(kms[0].centroids.numpy(),
                               kms[1].centroids.numpy(), atol=1e-9)


@pytest.mark.parametrize("n_places,k,seed", [(1, 5, 7), (4, 5, 7), (3, 6, 0),
                                             (8, 16, 1)])
def test_kmeans_matches_jax(n_places, k, seed):
    jk = JA.KMeans(n_places=n_places, n_points=1200, dim=3, k=k, seed=seed)
    tk = TA.KMeans(n_places=n_places, n_points=1200, dim=3, k=k, seed=seed,
                   device=CPU)
    np.testing.assert_array_equal(tk.centroids.numpy(), jk.centroids)
    np.testing.assert_allclose(tk.inertia(), jk.inertia(), rtol=1e-12)
    for _ in range(5):
        want = jk.iterate()
        got = tk.iterate()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=0)
    assert _assignments(tk, 3) == _assignments(jk, 3)
    np.testing.assert_allclose(tk.inertia(), jk.inertia(), rtol=1e-12)


@pytest.mark.parametrize("transport,be", [("host", "auto"),
                                          ("device", "fused")])
def test_kmeans_with_the_glb_matches_jax(transport, be):
    speeds = (1, 1, 1, 3)
    jk = JA.KMeans(n_places=4, n_points=2000, k=6, seed=3, speeds=speeds,
                   glb=J.GLBConfig(period=2, transport="host"))
    with backend(be):
        tk = TA.KMeans(n_places=4, n_points=2000, k=6, seed=3, speeds=speeds,
                       glb=T.GLBConfig(period=2, transport=transport),
                       device=CPU)
        for _ in range(6):
            want = jk.iterate()
            got = tk.iterate()
            np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=0)
        jk.finish()
        tk.finish()
    loads = [tk.points.local_size(p) for p in range(4)]
    assert loads == [jk.points.local_size(p) for p in range(4)]
    assert loads[3] > max(loads[:3])          # the fast place took points
    assert tk.balancer.stats.bytes_moved == jk.balancer.stats.bytes_moved
    assert _assignments(tk, 3) == _assignments(jk, 3)


def test_closest_point_picks_the_first_of_tied_points():
    """np.argmin's choice within a chunk; the earlier chunk on a tie."""
    rows = torch.tensor([[1.0, 0.0], [2.0, 0.0], [0.0, 0.0], [-1.0, 1.0],
                         [1.0, 0.0], [5.0, 1.0]], dtype=torch.float64)
    cp = TA.ClosestPoint(2, 1, torch.tensor([[0.0], [5.0]],
                                            dtype=torch.float64))
    st_ = cp.reduce(cp.new_reducer(), rows[:3])
    assert st_["coord"][:, 0].tolist() == [0.0, 0.0]   # cluster 1: empty
    assert st_["best"].tolist() == [0.0, float("inf")]
    a = cp.reduce(cp.new_reducer(), rows[:2])
    b = cp.reduce(cp.new_reducer(), rows[3:])
    both = cp.merge(a, b)
    # rows 0 and 4 tie at distance 1 from 0.0: the earlier chunk wins
    assert both["coord"][:, 0].tolist() == [1.0, 5.0]
    assert both["best"].tolist() == [1.0, 0.0]


# ---------------------------------------------------------------------------
# MolDyn
# ---------------------------------------------------------------------------
def test_moldyn_replicas_stay_in_sync():
    md = TA.MolDyn(n_places=3, n_particles=27, ndivide=3, device=CPU)
    for _ in range(5):
        md.step()
    assert md.replicas_in_sync()


def test_moldyn_matches_single_place():
    mds = [TA.MolDyn(n_places=n, n_particles=27, ndivide=3, seed=2,
                     device=CPU) for n in (1, 4)]
    for _ in range(3):
        for md in mds:
            md.step()
    np.testing.assert_allclose(mds[0].positions().numpy(),
                               mds[1].positions().numpy(), rtol=1e-10)


@pytest.mark.parametrize("n_places,n,ndiv,seed", [(1, 27, 3, 2),
                                                  (4, 27, 3, 2),
                                                  (3, 64, 5, 0),
                                                  (4, 125, 5, 1)])
def test_moldyn_matches_jax(n_places, n, ndiv, seed):
    jm = JA.MolDyn(n_places=n_places, n_particles=n, ndivide=ndiv, seed=seed)
    tm = TA.MolDyn(n_places=n_places, n_particles=n, ndivide=ndiv, seed=seed,
                   device=CPU)
    for _ in range(3):
        jm.step()
        tm.step()
    np.testing.assert_allclose(tm.positions().numpy(), jm.positions(),
                               rtol=1e-10)
    assert tm.allreduce_bytes == jm.allreduce_bytes
    assert tm.replicas_in_sync() and jm.replicas_in_sync()
    np.testing.assert_allclose(tm.energy(), jm.energy(), rtol=1e-10)


def test_moldyn_with_the_glb_matches_jax():
    speeds = (1, 1, 1, 2)
    jm = JA.MolDyn(n_places=4, n_particles=64, ndivide=5, seed=0,
                   glb=J.GLBConfig(period=1), speeds=speeds)
    tm = TA.MolDyn(n_places=4, n_particles=64, ndivide=5, seed=0,
                   glb=T.GLBConfig(period=1), speeds=speeds, device=CPU)
    for _ in range(4):
        jm.step()
        tm.step()
    assert [[_tile_key(t) for t in s.tiles] for s in tm.tiles] == \
        [[_tile_key(t) for t in s.tiles] for s in jm.tiles]
    np.testing.assert_allclose(tm.positions().numpy(), jm.positions(),
                               rtol=1e-10)
    assert tm.allreduce_bytes == jm.allreduce_bytes
    assert tm.balancer.stats.rebalances == jm.balancer.stats.rebalances > 0


# ---------------------------------------------------------------------------
# PlhamJ
# ---------------------------------------------------------------------------
def test_plham_uneven_cluster_gains():
    base = TA.PlhamSim(5, n_agents=400, strategy="none",
                       speeds=(1, 1, 1, 1, 3), seed=0, device=CPU).run(60)
    lb = TA.PlhamSim(5, n_agents=400, strategy="level_extremes",
                     speeds=(1, 1, 1, 1, 3), lb_period=5, seed=0,
                     device=CPU).run(60)
    assert lb < base * 0.95


def test_plham_even_cluster_no_overhead():
    base = TA.PlhamSim(5, n_agents=400, strategy="none", seed=0,
                       device=CPU).run(60)
    lb = TA.PlhamSim(5, n_agents=400, strategy="level_extremes",
                     lb_period=5, seed=0, device=CPU).run(60)
    assert abs(lb - base) / base < 0.05


def test_plham_dispatch_reaches_moved_agents():
    sim = TA.PlhamSim(4, n_agents=200, strategy="level_extremes",
                      speeds=(1, 1, 1, 2), lb_period=3, seed=0, device=CPU)
    sim.run(30)
    assert sim.relocated > 0 and sim.dispatch_s > 0


PLHAM_CASES = {
    "evenA": dict(n_places=5, speeds=(1, 1, 1, 1, 1)),
    "unevenC": dict(n_places=6, speeds=(1, 1, 1, 1, 1, 3)),
    "disturbA": dict(n_places=5, speeds=(1, 1, 1, 1, 1), disturb_period=25),
}


@pytest.mark.parametrize("strategy", ["none", "level_extremes",
                                      "proportional"])
@pytest.mark.parametrize("case", sorted(PLHAM_CASES))
def test_plham_matches_jax(case, strategy):
    kw = dict(PLHAM_CASES[case], n_agents=400, strategy=strategy,
              lb_period=5, seed=1)
    js = JA.PlhamSim(**kw)
    ts = TA.PlhamSim(**kw, device=CPU)
    want = js.run(40)
    got = ts.run(40)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert len(ts.distribution_history) == len(js.distribution_history)
    for a, b in zip(ts.distribution_history, js.distribution_history):
        np.testing.assert_array_equal(a, b)
    assert ts.relocated == js.relocated
    for p in ts.group.members:
        assert ts.agents.ranges(p) == [T.LongRange(r.start, r.end)
                                       for r in js.agents.ranges(p)]


# ---------------------------------------------------------------------------
# entry points: the card unless asked
# ---------------------------------------------------------------------------
def test_apps_default_to_the_card():
    if torch.cuda.is_available():
        assert TA.KMeans(n_places=2, n_points=64).device.type == "cuda"
        return
    for make in (lambda: TA.KMeans(n_places=2, n_points=64),
                 lambda: TA.MolDyn(n_places=2, n_particles=8),
                 lambda: TA.PlhamSim(3, n_agents=40),
                 lambda: TA.AveragePosition(2, 3),
                 lambda: T.Accumulator(T.LongRange(0, 4))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
