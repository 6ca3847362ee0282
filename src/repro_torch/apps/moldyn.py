"""MolDyn N-body (paper §4.9–4.12, Java Grande-derived), in PyTorch.

Particles replicate on every place (CachableChunkedList.share); each
place computes its teamed-split triangle tiles of pair forces into an
Accumulator; the per-replica partial forces reconcile with the
primitive-typed allreduce; then every replica moves its particles.

A tile's force work is tensor code on the group's device: its pairs
(``Tile.pair_indices``, built once per tile and kept) gather both
particles' positions, ``_lj_force`` runs over all pairs at once, and
``index_add_`` adds ``+f`` at ``i`` and ``-f`` at ``j`` into the tile's
grain buffer.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import (Accumulator, CachableChunkedList, GLBConfig,
                    GlobalLoadBalancer, ListWorkload, LongRange, PlaceGroup,
                    RangedListProduct)

__all__ = ["MolDyn"]


def _lj_force(pi: torch.Tensor, pj: torch.Tensor, eps=1.0, sigma=1.0):
    """Lennard-Jones force on i from j (vectorized over pairs)."""
    d = pi - pj
    dd = d * d
    r2 = ((dd[:, 0] + dd[:, 1]) + dd[:, 2]).clamp_min(1e-3)
    inv6 = (sigma * sigma / r2) ** 3
    mag = 24 * eps * inv6 * (2 * inv6 - 1) / r2
    return mag[:, None] * d


@dataclass
class MolDyn:
    n_places: int
    n_particles: int
    ndivide: int = 5
    seed: int = 0
    dt: float = 1e-4
    glb: GLBConfig | None = None  # rebalance force tiles between places
    speeds: tuple = ()            # per-place speed factors (simulated)
    device: object = None         # the card unless the caller asks
    _pairs: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.group = PlaceGroup(self.n_places, device=self.device)
        self.device = self.group.device
        self.particles = CachableChunkedList(self.group)
        self.range = LongRange(0, self.n_particles)
        side = int(np.ceil(self.n_particles ** (1 / 3)))
        grid = np.stack(np.meshgrid(*[np.arange(side)] * 3),
                        -1).reshape(-1, 3)[: self.n_particles] * 1.2
        state = np.concatenate(
            [grid + 0.05 * rng.standard_normal((self.n_particles, 3)),
             0.1 * rng.standard_normal((self.n_particles, 3)),
             np.zeros((self.n_particles, 3))], axis=1)  # x, v, f
        # particles initialized on place 0, then replicated (Listing 9)
        self.particles.add_chunk(0, self.range, state)
        self.particles.share(0, self.range)
        # teamed split of the pair triangle (Listing 10)
        prod = RangedListProduct.new_product_triangle(self.n_particles)
        self.tiles = prod.teamed_split(self.ndivide, self.ndivide,
                                       self.n_places, self.seed)
        self.allreduce_bytes = 0
        if not self.speeds:
            self.speeds = (1.0,) * self.n_places
        self.balancer = None
        if self.glb is not None:
            # particles replicate everywhere, so the balanced quantity
            # is the *tile schedule*: moving a Tile costs nothing on the
            # wire (pure ownership change), weighted by its pair count
            self.balancer = GlobalLoadBalancer(
                self.group,
                ListWorkload([s.tiles for s in self.tiles],
                             weight=lambda t: t.pairs),
                self.glb)

    def pair_indices(self, tile):
        """``tile``'s pairs on the device, built on first use (a tile
        keeps its pairs wherever the balancer moves it)."""
        pairs = self._pairs.get(tile)
        if pairs is None:
            pairs = self._pairs[tile] = tile.pair_indices(self.device)
        return pairs

    def _local_forces(self, place: int) -> torch.Tensor:
        """Force contribution of this place's tiles via an accumulator."""
        rows = self.particles.handle(place).chunks[self.range]
        pos = rows[:, 0:3]
        acc = Accumulator(self.range, (3,), rows.dtype, device=self.device)
        for tile in self.tiles[place].tiles:
            buf = acc.grain()                   # thread-local accumulator
            ii, jj = self.pair_indices(tile)
            if not len(ii):
                continue
            f = _lj_force(pos[ii], pos[jj])
            buf.index_add_(0, ii, f)
            buf.index_add_(0, jj, -f)           # Newton's third law
        return acc.totals()

    def step(self):
        # per-place force computation into the replicas
        for p in self.group.members:
            rows = self.particles.handle(p).chunks[self.range]
            rows[:, 6:9] = self._local_forces(p)
        if self.balancer is not None:
            # pair-force cost ∝ assigned tile pairs / place speed
            pairs = np.asarray([sum(t.pairs for t in split.tiles)
                                for split in self.tiles], np.float64)
            self.balancer.record_all(
                np.maximum(pairs / np.asarray(self.speeds), 1e-9))
            self.balancer.step()
        # teamed allreduce(SUM) of the force lanes (Listing 11)
        before = self.particles.comm.bytes_moved
        self.particles.allreduce(
            lambda rows: rows[:, 6:9],
            lambda rows, red: rows.__setitem__(
                (slice(None), slice(6, 9)), red),
            op="sum")
        self.allreduce_bytes += self.particles.comm.bytes_moved - before
        # move (every replica applies the same update — stays in sync)
        for p in self.group.members:
            rows = self.particles.handle(p).chunks[self.range]
            rows[:, 3:6] += self.dt * rows[:, 6:9]
            rows[:, 0:3] += self.dt * rows[:, 3:6]

    def positions(self, place: int = 0) -> torch.Tensor:
        return self.particles.handle(place).chunks[self.range][:, 0:3]

    def energy(self, place: int = 0) -> float:
        rows = self.particles.handle(place).chunks[self.range]
        ke = 0.5 * (rows[:, 3:6] ** 2).sum()
        return float(ke)

    def replicas_in_sync(self) -> bool:
        ref = self.particles.handle(0).chunks[self.range]
        return all(torch.allclose(self.particles.handle(p).chunks[self.range],
                                  ref)
                   for p in self.group.members)
