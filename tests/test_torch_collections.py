"""The port's collections, distribution, relocation engine and teamed
operations against the JAX package.

Both packages are seeded from one numpy state (through
``repro_torch.core.interop`` on the port's side), run the same
operations, and must end in the same state.  Tolerance: exact
equality — relocation moves bytes; the reductions below sum small
integers in float64, which is exact.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.relocation import (spmd_relocate as j_spmd_relocate,
                                   spmd_relocate_back as j_relocate_back)
from repro_torch.core.interop import (array_state_from_numpy,
                                      array_state_to_numpy,
                                      map_state_from_numpy,
                                      map_state_to_numpy)
from repro_torch.kernels import ops as tops


def cpu_group(n):
    return T.PlaceGroup(n, device="cpu")


def j_array_state(col):
    out = {}
    for p in col.group.members:
        h = col.handle(p)
        out[p] = [(r.start, r.end, np.asarray(h.chunks[r]))
                  for r in h.ranges()]
    return out


def same_state(a, b):
    assert a.keys() == b.keys()
    for p in a:
        assert len(a[p]) == len(b[p]), p
        for (s0, e0, r0), (s1, e1, r1) in zip(a[p], b[p]):
            assert (s0, e0) == (s1, e1)
            assert r0.dtype == r1.dtype and r0.tobytes() == r1.tobytes()


def seed_state(n_places, n_rows, seed, dtype=np.float32, width=3):
    rng = np.random.default_rng(seed)
    rows = (rng.integers(-999, 999, (n_rows, width)) / 3).astype(dtype)
    cut = np.sort(rng.choice(n_rows + 1, n_places - 1, replace=True))
    bounds = np.concatenate([[0], cut, [n_rows]])
    state = {p: [] for p in range(n_places)}
    for p in range(n_places):
        s, e = int(bounds[p]), int(bounds[p + 1])
        if e > s:
            state[p].append((s, e, rows[s:e]))
    return state


# ---------------------------------------------------------------------------
# distribution
# ---------------------------------------------------------------------------
class TestDistribution:
    def test_range_table_ops_match(self):
        ops_ = [((0, 50), 0), ((10, 20), 1), ((15, 30), 2), ((45, 60), 1),
                ((20, 25), 2), ((0, 5), 3)]
        jd, td = J.RangeDistribution(), T.RangeDistribution()
        for (s, e), o in ops_:
            jd.assign(J.LongRange(s, e), o)
            td.assign(T.LongRange(s, e), o)
        jd.remove(J.LongRange(27, 33))
        td.remove(T.LongRange(27, 33))
        assert [((r.start, r.end), o) for r, o in jd.items()] \
            == [((r.start, r.end), o) for r, o in td.items()]
        assert jd.version == td.version
        assert td.loads(4).tolist() == jd.loads(4).tolist()
        keys = np.arange(-3, 65)
        want = np.asarray(jd.lookup(keys))
        assert td.lookup(torch.from_numpy(keys)).numpy().tolist() \
            == want.tolist()
        assert td.lookup_host(keys).tolist() == want.tolist()
        assert T.RangeDistribution().lookup(torch.arange(3)).tolist() \
            == [-1, -1, -1]

    def test_delta_exchange(self):
        a = T.RangeDistribution.block(100, 4)
        b = a.copy()
        v = b.version
        b.assign(T.LongRange(10, 40), 3)
        delta = b.delta_since(v)
        a.apply_delta(delta)
        assert a == b and delta.nbytes == 8 * (3 * len(delta.moves) + 1)


# ---------------------------------------------------------------------------
# collections
# ---------------------------------------------------------------------------
class TestCollections:
    def test_interop_roundtrip_and_device(self):
        state = seed_state(4, 40, seed=1)
        col = array_state_from_numpy(cpu_group(4), state)
        same_state(array_state_to_numpy(col), state)
        rows, idx = col.to_local_matrix(1)
        assert isinstance(rows, torch.Tensor) and rows.device.type == "cpu"
        assert isinstance(idx, np.ndarray)
        bf = torch.arange(6, dtype=torch.float32).to(torch.bfloat16)
        col2 = T.DistArray(cpu_group(2))
        col2.add_chunk(0, T.LongRange(0, 6), bf)
        st = array_state_to_numpy(col2)
        assert st[0][0][2].dtype == np.uint16
        back = array_state_from_numpy(cpu_group(2), st)
        assert torch.equal(
            back.handle(0).chunks[T.LongRange(0, 6)].view(torch.int16),
            bf.view(torch.int16))

    def test_extract_splits_chunks_like_reference(self):
        state = {0: [(0, 30, np.arange(60, dtype=np.int64).reshape(30, 2))],
                 1: [(30, 40, np.arange(20, dtype=np.int64).reshape(10, 2))]}
        jcol = J.DistArray(J.PlaceGroup(2))
        for p, chunks in state.items():
            for s, e, r in chunks:
                jcol.add_chunk(p, J.LongRange(s, e), r)
        tcol = array_state_from_numpy(cpu_group(2), state)
        for c, L in ((jcol, J.LongRange), (tcol, T.LongRange)):
            with pytest.raises(KeyError):
                c.handle(0).extract(L(25, 35))          # partial hold
            c.handle(0).extract(L(10, 20))
        same_state(array_state_to_numpy(tcol), j_array_state(jcol))
        assert tcol.get(0, 25).tolist() == jcol.get(0, 25).tolist()

    def test_bag_moves_match_reference(self):
        def run(pkg, group):
            bag = pkg.DistBag(group)
            for p in group.members:
                bag.handle(p)
            for i in range(6):
                bag.put(0, np.arange(i + 1, dtype=np.float64))
            bag.handle(0).extend([("tup", 1), {"k": 2}])
            mm = pkg.CollectiveMoveManager(group, transport="device")
            bag.move_at_sync_count(0, 5, 1, mm)
            mm.sync()
            items = [np.asarray(x).tolist() if not isinstance(x, (tuple,
                                                                   dict))
                     else x for x in bag.items(1)]
            return items, mm.last_payload_bytes, \
                mm.last_counts_matrix.tolist()

        want = run(J, J.PlaceGroup(2))
        for be in ("fused", "composite"):
            tops.set_backend(be)
            try:
                assert run(T, cpu_group(2)) == want, be
            finally:
                tops.set_backend("auto")

    def test_map_interop_and_relocate(self):
        state = {0: [(k, {"page": np.full((2, 3), k, np.float32),
                          "tag": ("t", k)}) for k in range(8)],
                 1: [], 2: []}
        m = map_state_from_numpy(cpu_group(3), state)
        assert isinstance(m.get(0, 3)["page"], torch.Tensor)
        dist = T.RangeDistribution.block(8, 3)
        m.relocate(dist)
        out = map_state_to_numpy(m)
        assert [k for k, _ in out[1]] == [3, 4, 5]
        assert out[2][0][1]["tag"] == ("t", 6)
        assert np.array_equal(out[2][0][1]["page"],
                              np.full((2, 3), 6, np.float32))

    def test_cachable_collections(self):
        g = cpu_group(3)
        ca = T.CachableArray(g, [np.arange(4, dtype=np.float64)])
        ca.local(0)[0] += 1
        ca.broadcast(lambda v: v.clone(), lambda old, new: new)
        assert all(torch.equal(ca.local(p)[0], torch.arange(4.0,
                   dtype=torch.float64) + 1) for p in g.members)
        cl = T.CachableChunkedList(g)
        cl.add_chunk(0, T.LongRange(0, 4), np.ones((4, 2)))
        cl.share(0, T.LongRange(0, 4))
        cl.allreduce(lambda r: r, lambda old, red: red)
        assert torch.equal(cl.handle(2).chunks[T.LongRange(0, 4)],
                           torch.full((4, 2), 3.0, dtype=torch.float64))


# ---------------------------------------------------------------------------
# relocation engine
# ---------------------------------------------------------------------------
class TestRelocationEngine:
    @pytest.mark.parametrize("seed", range(3))
    def test_range_and_count_moves_match_reference(self, seed):
        state = seed_state(4, 64, seed=seed)
        jcol = J.DistArray(J.PlaceGroup(4))
        for p, chunks in state.items():
            for s, e, r in chunks:
                jcol.add_chunk(p, J.LongRange(s, e), r)
        for p in range(4):
            jcol.handle(p)
        tcol = array_state_from_numpy(cpu_group(4), state)
        rng = np.random.default_rng(seed + 100)
        moves = []
        for _ in range(4):
            src = int(rng.integers(0, 4))
            moves.append(("count", src, int(rng.integers(0, 5)),
                          int(rng.integers(0, 4))))
        moves.append(("range", 5, 20, int(rng.integers(0, 4))))
        results = []
        for pkg, col, mm in ((J, jcol, J.CollectiveMoveManager(
                J.PlaceGroup(4))), (T, tcol, None)):
            if mm is None:
                mm = T.CollectiveMoveManager(col.group, transport="device")
            else:
                mm = J.CollectiveMoveManager(col.group, transport="device")
            # count moves take what the range move leaves behind
            sizes = [col.local_size(p) - sum(
                i.size for i in col.handle(p).intersections(
                    pkg.LongRange(5, 20))) for p in range(4)]
            for kind, a, b, dest in moves:
                if kind == "count":
                    n = min(b, sizes[a])
                    sizes[a] -= n
                    if n:
                        col.move_at_sync_count(a, n, dest, mm)
                else:
                    col.move_range_at_sync(pkg.LongRange(a, b), dest, mm)
            mm.sync()
            results.append((mm.last_counts_matrix.tolist(),
                            mm.last_payload_bytes))
        assert results[0] == results[1]
        same_state(array_state_to_numpy(tcol), j_array_state(jcol))

    def test_depth2_chain_with_after_and_drain(self):
        g = cpu_group(4)
        col = T.DistArray(g)
        col.add_chunk(0, T.LongRange(0, 40), torch.arange(40.0))
        for p in g.members:
            col.handle(p)
        mm_a = T.CollectiveMoveManager(g, transport="device")
        mm_b = T.CollectiveMoveManager(g, transport="device")
        col.move_at_sync_count(0, 10, 1, mm_a)
        ha = mm_a.sync_async(update_dists=(col,), depth=2)
        ha.enqueue()
        col.move_at_sync_count(0, 10, 2, mm_b)
        hb = mm_b.sync_async(update_dists=(col,), depth=2, after=ha)
        assert hb.wait_delivered(timeout=60)
        ha.finish()
        hb.finish()
        assert [col.local_size(p) for p in g.members] == [20, 10, 10, 0]
        mm_a.register_drain(col, 0, (1, 2, 3))
        mm_a.sync()
        assert [col.local_size(p) for p in g.members] == [0, 17, 17, 6]
        assert col.get_distribution().total == 40
        assert ha.trace["t_counts_ready"] >= ha.trace["t_submit"]

    def test_abort_inflight_collects_errors_and_rolls_back(self):
        g = cpu_group(2)
        col = T.DistArray(g)
        col.add_chunk(0, T.LongRange(0, 8), torch.arange(8.0))
        mm = T.CollectiveMoveManager(g)
        col.move_range_at_sync(T.LongRange(0, 3), 1, mm)
        col.move_range_at_sync(T.LongRange(20, 30), 1, mm)   # not held
        mm.sync_async(depth=2)
        errors = mm.abort_inflight()
        assert len(errors) == 1 and isinstance(errors[0], KeyError)
        assert col.local_size(0) == 8 and mm.pending() == 0


# ---------------------------------------------------------------------------
# SPMD half: tensor code over the place dimension vs the JAX vmap body
# ---------------------------------------------------------------------------
class TestSpmdRelocate:
    def test_relocate_and_back_match_jax(self):
        import jax

        P, n, cap = 4, 6, 2
        rng = np.random.default_rng(3)
        x = rng.integers(0, 100, (P, n, 2)).astype(np.float32)
        dest = rng.integers(0, P, (P, n)).astype(np.int32)
        ext = rng.integers(0, 9, (P, n)).astype(np.int32)

        def body(xs, ds, es):
            return j_spmd_relocate(xs, ds, axis_name="p", capacity=cap,
                                   extras=(es,))

        jout = jax.vmap(body, axis_name="p")(x, dest, ext)
        tout = T.spmd_relocate(torch.from_numpy(x), torch.from_numpy(dest),
                               capacity=cap,
                               extras=(torch.from_numpy(ext),))
        for key in ("recv", "recv_valid", "recv_src", "slot"):
            assert np.array_equal(np.asarray(jout[key]),
                                  tout[key].numpy()), key
        assert np.array_equal(np.asarray(jout["recv_extras"][0]),
                              tout["recv_extras"][0].numpy())
        y = rng.integers(0, 50, (P, P * cap, 2)).astype(np.float32)
        jb = jax.vmap(lambda yy, ss: j_relocate_back(
            yy, ss, axis_name="p", capacity=cap, fill=-1.0),
            axis_name="p")(y, jout["slot"])
        tb = T.spmd_relocate_back(torch.from_numpy(y), tout["slot"],
                                  capacity=cap, fill=-1.0)
        assert np.array_equal(np.asarray(jb), tb.numpy())
        counts = T.spmd_counts(torch.from_numpy(dest), P)
        assert counts.sum().item() == P * n

    def test_spmd_rebalance_matches_jax(self):
        import jax
        from repro.core.glb import spmd_rebalance as j_rebalance

        P, n, cap = 3, 5, 4
        rng = np.random.default_rng(9)
        x = rng.integers(0, 100, (P, n, 1)).astype(np.float32)
        valid = rng.random((P, n)) < 0.8
        moves = np.array([[0, 1, 1], [0, 0, 2], [1, 0, 0]], np.int32)
        jx, jv = jax.vmap(lambda a, b: j_rebalance(
            a, b, moves, axis_name="p", capacity=cap),
            axis_name="p")(x, valid)
        tx, tv = T.spmd_rebalance(torch.from_numpy(x),
                                  torch.from_numpy(valid), moves,
                                  capacity=cap)
        assert np.array_equal(np.asarray(jv), tv.numpy())
        assert np.array_equal(np.asarray(jx), tx.numpy())


# ---------------------------------------------------------------------------
# teamed operations and the balancer policies
# ---------------------------------------------------------------------------
class SumReducer:
    additive = True

    def new_reducer(self):
        return torch.zeros((), dtype=torch.float64)

    def reduce(self, state, rows):
        return state + rows.to(torch.float64).sum()

    def merge(self, a, b):
        return a + b


class MaxReducer(SumReducer):
    additive = False

    def new_reducer(self):
        return torch.tensor(-1e300, dtype=torch.float64)

    def reduce(self, state, rows):
        return torch.maximum(state, rows.to(torch.float64).max())

    def merge(self, a, b):
        return torch.maximum(a, b)


class TestTeamed:
    def test_team_reduce_and_spmd_variants(self):
        state = seed_state(4, 50, seed=4, dtype=np.int32)
        col = array_state_from_numpy(cpu_group(4), state)
        total = sum(int(r.astype(np.int64).sum())
                    for chunks in state.values() for _, _, r in chunks)
        assert T.team_reduce(col, SumReducer()).item() == total
        biggest = max(int(r.max()) for chunks in state.values()
                      for _, _, r in chunks)
        assert T.team_reduce(col, MaxReducer()).item() == biggest
        locals_ = torch.stack([T.local_reduce(col, p, SumReducer())
                               for p in range(4)])
        red = T.spmd_team_reduce(locals_, SumReducer())
        assert red.tolist() == [float(total)] * 4
        red = T.spmd_team_reduce(locals_, MaxReducer())
        assert red.tolist() == [float(locals_.max())] * 4
        g = T.spmd_allgather1(torch.arange(3))
        assert g.tolist() == [[0, 1, 2]] * 3

    def test_balancer_policies_match_reference(self):
        rng = np.random.default_rng(2)
        for _ in range(5):
            times = rng.random(6) + 0.1
            loads = rng.integers(1, 100, 6)
            for name in ("LevelExtremes", "Proportional"):
                jd = getattr(J, name)().plan(times, loads)
                td = getattr(T, name)().plan(times, loads)
                assert jd.moves == td.moves
