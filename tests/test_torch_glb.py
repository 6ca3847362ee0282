"""The port's GLB and device steal loop against the JAX package.

* ``run_device_steal`` on both data planes (ids, and codec rows through
  the ``decode_rows`` path) equals the JAX ``run_device_steal``: loads,
  rounds, stolen, hops, and every place's ranges and row bytes;
* the port's host ``steal_pass`` loop equals the JAX device loop's
  loads, rounds, stolen and hops (the policy parity the device loop
  promises);
* the periodic balancer (``ClusterSim``) reproduces the reference's
  makespans.

Inputs come from numpy seeds.  Tolerance: exact equality.
"""
import contextlib

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.core.interop import (array_state_from_numpy,
                                      array_state_to_numpy)
from repro_torch.kernels import ops as tops


@contextlib.contextmanager
def backend(name):
    prev = tops.get_backend()
    tops.set_backend(name)
    try:
        yield
    finally:
        tops.set_backend(prev)


def layout(n_places, total, seed, hot=None, width=2, dtype=np.float64):
    rng = np.random.default_rng(seed)
    rows = (rng.integers(-10**6, 10**6, (total, width)) / 7).astype(dtype)
    if hot is not None:
        return {p: ([(0, total, rows)] if p == hot else [])
                for p in range(n_places)}
    cut = np.sort(rng.choice(total + 1, n_places - 1, replace=True))
    bounds = np.concatenate([[0], cut, [total]])
    return {p: ([(int(bounds[p]), int(bounds[p + 1]),
                  rows[bounds[p]:bounds[p + 1]])]
                if bounds[p + 1] > bounds[p] else [])
            for p in range(n_places)}


def j_col(state, n):
    col = J.DistArray(J.PlaceGroup(n), track=True)
    for p in range(n):
        col.handle(p)
    for p, chunks in state.items():
        for s, e, r in chunks:
            col.add_chunk(p, J.LongRange(s, e), r)
    return col


def j_state(col):
    return {p: [(r.start, r.end, np.asarray(col.handle(p).chunks[r]))
                for r in col.handle(p).ranges()]
            for p in col.group.members}


def assert_same_state(a, b):
    assert a.keys() == b.keys()
    for p in a:
        assert [(s, e) for s, e, _ in a[p]] == [(s, e) for s, e, _ in b[p]]
        for (_, _, x), (_, _, y) in zip(a[p], b[p]):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def det_cfg(topo="hypercube", **kw):
    return dict(lifeline=topo, random_steal_attempts=0, **kw)


STEAL_KW = dict(steal_ratio=0.5, min_keep=1, idle_threshold=0,
                max_rounds=12)
STATS = ("rounds", "attempted", "served", "stolen", "hops", "bytes_moved",
         "terminated")


class TestDeviceSteal:
    @pytest.mark.parametrize("n,total,hot,topo", [
        (4, 240, 0, "hypercube"), (4, 240, 2, "ring"),
        (8, 300, 0, "hypercube"), (5, 97, None, "hypercube"),
        (8, 64, None, "ring")])
    def test_both_planes_match_jax(self, n, total, hot, topo):
        state = layout(n, total, seed=total + n, hot=hot)
        lifelines = (J.hypercube_lifelines if topo == "hypercube"
                     else J.ring_lifelines)(n)
        jc = j_col(state, n)
        jres = J.run_device_steal(jc, lifelines, range(n), **STEAL_KW)
        for ship_rows, be in ((False, "auto"), (True, "fused"),
                              (True, "composite")):
            with backend(be):
                tc = array_state_from_numpy(T.PlaceGroup(n, device="cpu"),
                                            state)
                tres = T.run_device_steal(tc, lifelines, range(n),
                                          ship_rows=ship_rows, **STEAL_KW)
            for k in STATS:
                assert tres[k] == jres[k], (k, ship_rows, be)
            assert_same_state(array_state_to_numpy(tc), j_state(jc))
            assert [((r.start, r.end), o) for r, o in
                    tc.get_distribution().items()] \
                == [((r.start, r.end), o) for r, o in
                    jc.get_distribution().items()]

    @pytest.mark.parametrize("topo", ["ring", "hypercube"])
    def test_host_loop_matches_jax_device_loop(self, topo):
        state = layout(4, 240, seed=1, hot=0)
        jc = j_col(state, 4)
        jglb = J.GlobalLoadBalancer(J.PlaceGroup(4),
                                    J.DistArrayWorkload(jc),
                                    J.GLBConfig(**det_cfg(topo)),
                                    device_loop=True)
        jres = jglb.steal_loop(max_rounds=12)
        for transport in ("host", "device"):
            tc = array_state_from_numpy(T.PlaceGroup(4, device="cpu"),
                                        state)
            tglb = T.GlobalLoadBalancer(
                tc.group, T.DistArrayWorkload(tc),
                T.GLBConfig(transport=transport, **det_cfg(topo)))
            tres = tglb.steal_loop(max_rounds=12)
            assert not tres["device"]
            assert [tc.local_size(p) for p in range(4)] \
                == [jc.local_size(p) for p in range(4)]
            assert (tres["rounds"], tres["stolen"]) \
                == (jres["rounds"], jres["stolen"])
            js, ts = jglb.stats, tglb.stats
            assert (ts.steals_served, ts.entries_stolen, ts.steal_hops) \
                == (js.steals_served, js.entries_stolen, js.steal_hops)
            assert tglb.is_terminated() == jglb.is_terminated()

    def test_device_loop_through_the_balancer(self):
        state = layout(8, 512, seed=3, hot=0, width=4, dtype=np.float32)
        res = {}
        for transport, be in (("host", "auto"), ("device", "fused"),
                              ("device", "composite")):
            with backend(be):
                tc = array_state_from_numpy(T.PlaceGroup(8, device="cpu"),
                                            state)
                glb = T.GlobalLoadBalancer(
                    tc.group, T.DistArrayWorkload(tc),
                    T.GLBConfig(transport=transport, **det_cfg()),
                    device_loop=True)
                out = glb.steal_loop()
                assert out["device"]
                res[(transport, be)] = (out, array_state_to_numpy(tc),
                                        glb.stats.steal_hops)
        base = res[("host", "auto")]
        for key, (out, st, hops) in res.items():
            assert out == base[0] and hops == base[2], key
            assert_same_state(st, base[1])

    def test_evicted_place_and_guards(self):
        state = layout(4, 240, seed=5, hot=0)
        loads = []
        for device_loop in (False, True):
            tc = array_state_from_numpy(T.PlaceGroup(4, device="cpu"),
                                        state)
            glb = T.GlobalLoadBalancer(tc.group, T.DistArrayWorkload(tc),
                                       T.GLBConfig(**det_cfg()),
                                       device_loop=device_loop)
            glb.evict_place(2)
            glb.steal_loop()
            loads.append([tc.local_size(p) for p in range(4)])
        assert loads[0] == loads[1] and loads[1][2] == 0
        tc = array_state_from_numpy(T.PlaceGroup(4, device="cpu"), state)
        with pytest.raises(ValueError, match="random_steal_attempts"):
            T.GlobalLoadBalancer(tc.group, T.DistArrayWorkload(tc),
                                 T.GLBConfig(random_steal_attempts=2),
                                 device_loop=True).steal_loop()
        with pytest.raises(ValueError, match="capacity"):
            T.GlobalLoadBalancer(tc.group, T.DistArrayWorkload(tc),
                                 T.GLBConfig(**det_cfg()), device_loop=True,
                                 device_capacity=50).steal_loop()

    def test_step_api_matches_host_passes_round_by_round(self):
        n, total = 4, 120
        state = layout(n, total, seed=8, hot=0)
        tc = array_state_from_numpy(T.PlaceGroup(n, device="cpu"), state)
        glb = T.GlobalLoadBalancer(tc.group, T.DistArrayWorkload(tc),
                                   T.GLBConfig(**det_cfg()))
        cand, hops = T.steal_candidates(glb.lifelines, n)
        S = total
        x = torch.zeros((n, S, 1), dtype=torch.int32)
        valid = torch.zeros((n, S), dtype=torch.bool)
        gids = torch.full((n, S), -1, dtype=torch.int32)
        valid[0, :total] = True
        gids[0, :total] = torch.arange(total, dtype=torch.int32)
        alive = torch.ones(n, dtype=torch.bool)
        for _ in range(4):
            glb.steal_pass()
            x, valid, gids, info = T.spmd_steal_step(
                x, valid, gids, candidates=cand, hops=hops, alive=alive,
                steal_ratio=0.5, min_keep=1, idle_threshold=0)
            assert valid.sum(1).tolist() \
                == [tc.local_size(p) for p in range(n)]
        got = sorted(gids[valid].tolist())
        assert got == list(range(total))


class TestPeriodicBalancer:
    @pytest.mark.parametrize("policy", ["level_extremes", "proportional"])
    def test_cluster_sim_matches_reference(self, policy):
        kw = dict(n_places=4, n_entries=400, speeds=(1.0, 0.5, 1.0, 2.0),
                  disturb_period=5)
        jsim = J.ClusterSim(glb=J.GLBConfig(period=3, policy=policy), **kw)
        tsim = T.ClusterSim(glb=T.GLBConfig(period=3, policy=policy),
                            device="cpu", **kw)
        assert tsim.run(20) == jsim.run(20)
        assert tsim.makespans == jsim.makespans
        assert tsim.balancer.stats.entries_rebalanced \
            == jsim.balancer.stats.entries_rebalanced

    def test_pipeline_depth2_double_buffers(self):
        tsim = T.ClusterSim(n_places=4, n_entries=200,
                            speeds=(1.0, 0.25, 1.0, 1.0),
                            glb=T.GLBConfig(period=2, pipeline_depth=2,
                                            transport="device"),
                            device="cpu")
        tsim.run(12)
        st = tsim.balancer.stats
        assert st.rebalances > 0 and st.syncs_total > 0
        assert tsim.col.global_size() == 200
