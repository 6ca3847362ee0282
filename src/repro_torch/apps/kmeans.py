"""Distributed K-Means (paper §4 Listing 8, Renaissance-derived), in
PyTorch.

Points live in a ``DistArray`` whose chunks are tensors on the group's
device; one iteration = local parallel assignment + two *teamed
reductions* (AveragePosition, ClosestPoint) — the paper's structure,
with tensor ops on the card as the intra-place vector engine.  The data
is drawn on the host from ``np.random.default_rng(seed)`` exactly as
the JAX package draws it and copied to the device once, so both
packages start from the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import (DistArray, DistArrayWorkload, GLBConfig,
                    GlobalLoadBalancer, LongRange, PlaceGroup, team_reduce)
from ..core.device import default_device

__all__ = ["AveragePosition", "ClosestPoint", "KMeans", "draw_points"]


def draw_points(n_points: int, dim: int, k: int, seed: int):
    """The reference's draw from ``np.random.default_rng(seed)``: the
    true centers (k, dim), the point rows (n_points, dim + 1) with a
    zero cluster column, and the indices of the k starting centroids."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(k, dim))
    pts = (centers[rng.integers(0, k, n_points)]
           + rng.normal(size=(n_points, dim)))
    rows = np.concatenate([pts, np.zeros((n_points, 1))], axis=1)
    pick = rng.choice(n_points, k, replace=False)
    return centers, rows, pick


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``((a - b) ** 2).sum(-1)`` with the last axis summed left to
    right — numpy's order for fewer than 8 terms, so the distances are
    the reference's bits at any dim < 8."""
    sq = (a - b) ** 2
    d = sq[..., 0]
    for i in range(1, sq.shape[-1]):
        d = d + sq[..., i]
    return d


class AveragePosition:
    """Per-cluster position sums + counts (additive reducer, §4.7)."""

    additive = True

    def __init__(self, k: int, dim: int, device=None):
        self.k, self.dim = k, dim
        self.device = default_device(device)

    def new_reducer(self):
        z = lambda *s: torch.zeros(s, dtype=torch.float64,  # noqa: E731
                                   device=self.device)
        return {"sum": z(self.k, self.dim), "count": z(self.k)}

    def reduce(self, state, rows):
        pts = rows[:, :self.dim]
        cl = rows[:, self.dim].long()
        state["sum"].index_add_(0, cl, pts)
        state["count"].index_add_(0, cl, torch.ones_like(rows[:, 0]))
        return state

    def merge(self, a, b):
        return {"sum": a["sum"] + b["sum"], "count": a["count"] + b["count"]}

    def centroids(self, state):
        return state["sum"] / state["count"].clamp_min(1.0)[:, None]


class ClosestPoint:
    """Per-cluster closest point to the average (min-merge reducer).

    ``reduce`` picks, for every cluster at once, the first row of the
    chunk at the cluster's smallest distance (``np.argmin``'s choice)
    and keeps it only if strictly closer than the state's: no host
    round trip per cluster."""

    additive = False

    def __init__(self, k: int, dim: int, avg: torch.Tensor):
        self.k, self.dim, self.avg = k, dim, avg

    def new_reducer(self):
        return {"best": torch.full((self.k,), float("inf"),
                                   dtype=torch.float64,
                                   device=self.avg.device),
                "coord": torch.zeros((self.k, self.dim),
                                     dtype=torch.float64,
                                     device=self.avg.device)}

    def reduce(self, state, rows):
        n = rows.shape[0]
        if n == 0:
            return state
        pts = rows[:, :self.dim]
        cl = rows[:, self.dim].long()
        d = _sq_dist(pts, self.avg[cl])
        inf = torch.full((self.k,), float("inf"), dtype=d.dtype,
                         device=d.device)
        dmin = inf.scatter_reduce(0, cl, d, reduce="amin")
        at_min = torch.where(d == dmin[cl],
                             torch.arange(n, device=d.device), n)
        first = torch.full((self.k,), n, dtype=torch.long,
                           device=d.device).scatter_reduce(
            0, cl, at_min, reduce="amin")
        take = (first < n) & (dmin < state["best"])
        pick = pts[first.clamp_max(n - 1)]
        state["best"] = torch.where(take, dmin, state["best"])
        state["coord"] = torch.where(take[:, None], pick, state["coord"])
        return state

    def merge(self, a, b):
        take_b = b["best"] < a["best"]
        return {"best": torch.where(take_b, b["best"], a["best"]),
                "coord": torch.where(take_b[:, None], b["coord"],
                                     a["coord"])}


@dataclass
class KMeans:
    n_places: int
    n_points: int
    dim: int = 3
    k: int = 8
    seed: int = 0
    glb: GLBConfig | None = None  # rebalance points across places
    speeds: tuple = ()            # per-place speed factors (simulated)
    device: object = None         # the card unless the caller asks

    def __post_init__(self):
        self.group = PlaceGroup(self.n_places, device=self.device)
        centers, rows, pick = draw_points(self.n_points, self.dim, self.k,
                                          self.seed)
        self.device = self.group.device
        self.points = DistArray(self.group, track=True)
        dev_rows = torch.from_numpy(rows).to(self.device)
        chunks = LongRange(0, self.n_points).split(self.n_places)
        for p, r in enumerate(chunks):
            if r.size:
                self.points.add_chunk(p, r, dev_rows[r.start:r.end])
        self.centroids = dev_rows[torch.from_numpy(pick).to(self.device),
                                  :self.dim].clone()
        self.true_centers = centers
        if not self.speeds:
            self.speeds = (1.0,) * self.n_places
        self.balancer = None
        if self.glb is not None:
            self.balancer = GlobalLoadBalancer(
                self.group, DistArrayWorkload(self.points), self.glb)

    def assign_step(self):
        """parallelForEach: assign each point to its nearest centroid."""
        c = self.centroids

        def assign(rows):
            d = _sq_dist(rows[:, None, :self.dim], c[None])
            rows[:, self.dim] = d.argmin(dim=1).to(rows.dtype)
            return rows

        for p in self.group.members:
            self.points.map_chunks(p, assign)

    def iterate(self) -> torch.Tensor:
        if self.balancer is not None:
            # barrier for the previous iteration's in-flight relocation:
            # the points must be settled before we touch them again
            self.balancer.finish()
        self.assign_step()
        avg_r = AveragePosition(self.k, self.dim, self.device)
        avg_state = team_reduce(self.points, avg_r)       # teamed reduction 1
        avg = avg_r.centroids(avg_state)
        cp_r = ClosestPoint(self.k, self.dim, avg)
        cp_state = team_reduce(self.points, cp_r)         # teamed reduction 2
        self.centroids = cp_state["coord"]
        if self.balancer is not None:
            # assignment cost ∝ local points / place speed; the launched
            # relocation overlaps whatever the caller does between
            # iterations (convergence checks, logging, inertia)
            loads = np.asarray([self.points.local_size(p)
                                for p in self.group.members], np.float64)
            self.balancer.record_all(
                np.maximum(loads / np.asarray(self.speeds), 1e-9))
            self.balancer.step()
        return self.centroids

    def finish(self) -> None:
        """Drain the in-flight relocation: call before reading
        ``self.points`` directly after the last :meth:`iterate` (the
        launched transfer only settles at the next internal barrier)."""
        if self.balancer is not None:
            self.balancer.finish()

    def inertia(self) -> float:
        self.finish()
        total = 0.0
        for p in self.group.members:
            if not self.points.local_size(p):
                continue
            rows, _ = self.points.to_local_matrix(p)
            d = _sq_dist(rows[:, None, :self.dim], self.centroids[None])
            total += float(d.amin(dim=1).sum())
        return total
