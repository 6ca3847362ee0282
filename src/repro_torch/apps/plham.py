"""PlhamJ-style financial-market simulator (paper §4 / §6.3), in PyTorch.

The full round structure of Fig 2 on the collection substrate:
 (1) market state broadcast (CachableArray),
 (2) parallel order submission (agents → DistBag),
 (3) teamed gather of orders to the master,
 (4) order matching on the master, overlapped with the optional
     level-extremes rebalance of agents (LoadBalancer + relocation),
 (5) contracted-trade dispatch by the tracked agent distribution
     (DistMultiMap.relocate) + parallel agent updates.

The cluster is simulated: each place has a speed factor, and the
"Disturb" parasite periodically slows one host (paper §6.3) — simulated
wall-clock = Σ per-place max of (agent work / speed).

Agent rows live on the group's device.  The random draws stay on the
host's ``self.rng`` in the reference's order (one ``integers`` and one
``normal`` per range, ranges in order), so the simulated times, the
load history and the relocated bytes are the JAX package's.  Each
place's per-range work sums come back in one transfer, and each range's
orders go to the device as one tensor.  The per-key trade updates of
step (5) stay one ``get`` and one ``set`` per trade, as in the
reference; ``dispatch_s`` and ``trades`` count the host time they take
and how many there were.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import (CachableArray, DistArray, DistArrayWorkload, DistBag,
                    DistMultiMap, GLBConfig, GlobalLoadBalancer,
                    LevelExtremes, LongRange, PlaceGroup, Proportional)

__all__ = ["PlhamSim"]


@dataclass
class PlhamSim:
    n_places: int                      # agent-handling places (master = 0)
    n_agents: int = 1200
    lb_period: int = 10
    strategy: str = "level_extremes"   # none | level_extremes | proportional
    speeds: tuple = ()                 # per-place speed factors
    disturb_period: int = 0            # iters between disturb moves (0=off)
    disturb_factor: float = 0.4
    seed: int = 0
    device: object = None              # the card unless the caller asks

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.rng = rng
        self.group = PlaceGroup(self.n_places, device=self.device)
        self.device = self.group.device
        self.agents = DistArray(self.group, track=True)   # DistCol<Agent>
        # agent rows: [cost_weight, wealth]; heterogeneous per-agent cost
        rows = torch.from_numpy(np.stack([0.5 + rng.random(self.n_agents),
                                          np.ones(self.n_agents)],
                                         axis=1)).to(self.device)
        workers = self.group.members[1:] if self.n_places > 1 \
            else self.group.members
        for i, r in enumerate(LongRange(0, self.n_agents).split(len(workers))):
            if r.size:
                self.agents.add_chunk(workers[i], r, rows[r.start:r.end])
        self.markets = CachableArray(self.group,
                                     [np.array([100.0, 0.0])], owner=0)
        strat = {"none": None,
                 "level_extremes": LevelExtremes(),
                 "proportional": Proportional(damping=0.8)}[self.strategy]
        self.workers = list(workers)
        # The GLB replaces the hand-rolled balance loop: it accounts the
        # worker times, plans with the same strategy objects, and runs
        # the relocation asynchronously so it overlaps order matching.
        self.glb = None
        if strat is not None:
            self.glb = GlobalLoadBalancer(
                self.group.subgroup(self.workers),
                DistArrayWorkload(self.agents, members=self.workers),
                GLBConfig(period=self.lb_period, policy=strat,
                          asynchronous=True, seed=self.seed))
        if not self.speeds:
            self.speeds = tuple([1.0] * self.n_places)
        self.iter = 0
        self.sim_time = 0.0
        self.distribution_history: list[np.ndarray] = []
        self.relocated = 0
        self.dispatch_s = 0.0    # host seconds in step (5)'s trade updates
        self.trades = 0          # trade updates applied
        self._unit = torch.ones(2, dtype=torch.float64, device=self.device)

    # ------------------------------------------------------------------
    def _place_speed(self, p: int) -> float:
        s = self.speeds[p]
        if self.disturb_period:
            victim = (self.iter // self.disturb_period) % self.n_places
            if p == victim:
                s *= self.disturb_factor
        return s

    def round(self) -> float:
        """One simulation round; returns its simulated wall time."""
        g = self.group
        # (1) broadcast updated market state
        self.markets.broadcast(lambda m: m.clone(), lambda local, u: u)

        # (2) order submission: per-place parallel produce into a DistBag
        orders = DistBag(g)
        times = np.zeros(self.n_places)
        for p in g.members:
            if p == 0 and self.n_places > 1:
                continue
            h = self.agents.handle(p)
            ranges = h.ranges()
            # per-agent cost: every range's sum in one transfer, added
            # in range order
            sums = torch.stack([h.chunks[r][:, 0].sum() for r in ranges]
                               ).tolist() if ranges else []
            work = 0.0
            for r, s in zip(ranges, sums):
                work += s
                n_ord = max(1, r.size // 4)
                idx = self.rng.integers(r.start, r.end, n_ord)
                batch = torch.from_numpy(np.stack(
                    [idx, self.rng.normal(100, 1, n_ord)], axis=1)
                ).to(self.device)
                orders.put_batch(p, batch.unbind(0))
            times[p] = work / self._place_speed(p)
        submit_time = times.max()                       # barrier: slowest host

        # (3) teamed gather of orders on the master
        orders.team_gather(0)

        # (4) the GLB launches the relocation asynchronously, then the
        # master matches orders while phase 1 (counts + packing) runs in
        # the background (paper §4.5: balance over the agent-handling
        # places only; master holds no agents in Config A)
        decision = None
        if self.glb:
            w_times = np.maximum(times[self.workers], 1e-9)
            self.glb.record_all(w_times)
            bytes_before = self.glb.stats.bytes_moved
            decision = self.glb.step()

        all_orders = orders.items(0)
        match_time = 0.2 * len(all_orders) / 100.0 / self._place_speed(0)
        contracted = DistMultiMap(g)
        half = all_orders[: len(all_orders) // 2]
        if half:
            for key, price in torch.stack(half).tolist():
                contracted.put(0, int(key), np.float32(price))

        lb_time = 0.0
        if self.glb:
            # barrier before dispatch: deliver payloads + updateDist
            self.glb.finish()
            self.relocated += self.glb.stats.bytes_moved - bytes_before
            if decision and decision.moves:
                # relocation overlapped order handling: only the excess
                # over match_time costs wall time
                lb_time = max(0.0, 0.01 - match_time)

        # (5) dispatch contracted updates by the *current* distribution
        dist = self.agents.get_distribution()
        contracted.relocate(dist)
        t0 = time.perf_counter()
        for p in g.members:
            h = self.agents.handle(p)
            for k in contracted.keys(p):
                owner = dist.owner_of(k)
                assert owner == p, "dispatch reached a stale owner"
                for upd in contracted.get(p, k):
                    h.set(k, h.get(k) * self._unit)      # apply trade
                    self.trades += 1
        self.dispatch_s += time.perf_counter() - t0

        self.iter += 1
        t = submit_time + match_time + lb_time
        self.sim_time += t
        self.distribution_history.append(
            dist.loads(self.n_places).copy())
        return t

    def run(self, iters: int) -> float:
        for _ in range(iters):
            self.round()
        return self.sim_time
