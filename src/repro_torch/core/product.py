"""RangedListProduct (paper §4.10) — pairwise-interaction scheduling, in
PyTorch.

``newProductTriangle(list, list)`` represents the upper triangle of the
pair product of a range with itself; ``teamedSplit(N, N, group, seed)``
tiles it N×N and deterministically assigns tiles to places so that every
tile is processed by exactly one place (no communication — 'teamed'
because all places must call it with identical arguments).

The schedule is host metadata: tiles, pair counts and the seeded
assignment (an explicit ``np.random.default_rng(seed)``, so every seed
gives the reference's tile-to-place lists).  What the card consumes is
a tile's pairs, :meth:`Tile.pair_indices`: the strictly-upper ``(i, j)``
of the tile as two int64 tensors, in row-major order, built on the
device in one pass (the N-body force path gathers and scatters by them).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .distribution import LongRange

__all__ = ["Tile", "RangedListProduct"]


@dataclass(frozen=True)
class Tile:
    rows: LongRange
    cols: LongRange
    diagonal: bool  # tile straddles the diagonal → needs masking

    @property
    def pairs(self) -> int:
        if not self.diagonal:
            return self.rows.size * self.cols.size
        # strictly-upper-triangle pair count within tile (no self pairs)
        n = 0
        for i in self.rows:
            n += max(0, self.cols.end - max(i + 1, self.cols.start))
        return n

    def pair_indices(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The tile's pairs ``i < j`` as int64 tensors ``(ii, jj)`` on
        ``device``, row-major: for each row ``i`` in order, its columns
        ``j`` ascending (the order ``for_each_pair`` visits them)."""
        i = torch.arange(self.rows.start, self.rows.end, device=device)
        j = torch.arange(self.cols.start, self.cols.end, device=device)
        ii = i[:, None].expand(len(i), len(j))
        jj = j[None, :].expand(len(i), len(j))
        if not self.diagonal:
            return ii.reshape(-1), jj.reshape(-1)
        keep = jj > ii
        return ii[keep], jj[keep]


class RangedListProduct:
    """Upper-triangle product of ``[0, n)`` with itself, tiled."""

    def __init__(self, n: int, tiles: list[Tile] | None = None):
        self.n = n
        self.tiles = tiles if tiles is not None else [
            Tile(LongRange(0, n), LongRange(0, n), diagonal=True)]

    @staticmethod
    def new_product_triangle(n: int) -> "RangedListProduct":
        return RangedListProduct(n)

    def split(self, n_div_rows: int, n_div_cols: int) -> "RangedListProduct":
        """Tile the triangle; only tiles intersecting the upper triangle
        (col_end > row_start) are kept."""
        rows = LongRange(0, self.n).split(n_div_rows)
        cols = LongRange(0, self.n).split(n_div_cols)
        tiles = []
        for r in rows:
            if r.size == 0:
                continue
            for c in cols:
                if c.size == 0 or c.end <= r.start + 1:
                    continue  # strictly below the diagonal: no pairs
                diagonal = c.start < r.end  # straddles i<j boundary
                t = Tile(r, c, diagonal)
                if t.pairs > 0:
                    tiles.append(t)
        return RangedListProduct(self.n, tiles)

    def teamed_split(self, n_div_rows: int, n_div_cols: int,
                     n_places: int, seed: int) -> list["RangedListProduct"]:
        """Paper's ``teamedSplit``: split into tiles and deterministically
        assign each tile to exactly one place (seeded shuffle + greedy
        least-loaded assignment by pair count).  Every place must compute
        this with identical arguments — the returned list is indexed by
        place."""
        prod = self.split(n_div_rows, n_div_cols)
        order = sorted(range(len(prod.tiles)),
                       key=lambda i: -prod.tiles[i].pairs)
        rng = np.random.default_rng(seed)
        # seeded tie-shuffle then greedy least-loaded assignment
        perm = list(order)
        rng.shuffle(perm[: max(0, len(perm) // 4)])
        loads = np.zeros(n_places, np.int64)
        assignment: list[list[Tile]] = [[] for _ in range(n_places)]
        for i in perm:
            p = int(np.argmin(loads))
            assignment[p].append(prod.tiles[i])
            loads[p] += prod.tiles[i].pairs
        return [RangedListProduct(self.n, a) for a in assignment]

    # ------------------------------------------------------------------
    def total_pairs(self) -> int:
        return sum(t.pairs for t in self.tiles)

    def for_each_pair(self, fn) -> None:
        """Reference iteration (oracle for tests): fn(i, j) for each
        upper-triangle pair covered by this product's tiles."""
        for t in self.tiles:
            for i in t.rows:
                j0 = max(t.cols.start, i) if t.diagonal else t.cols.start
                for j in range(j0, t.cols.end):
                    if j <= i:
                        continue
                    fn(i, j)

    def causal_block_mask(self, n_div_rows: int,
                          n_div_cols: int) -> np.ndarray:
        """Block-level visit mask for attention-style consumers: entry
        [qi, kj] True iff that tile holds any pair (k <= q causal form
        uses the transpose)."""
        rows = LongRange(0, self.n).split(n_div_rows)
        cols = LongRange(0, self.n).split(n_div_cols)
        mask = np.zeros((len(rows), len(cols)), bool)
        for t in self.tiles:
            for ri, r in enumerate(rows):
                for ci, c in enumerate(cols):
                    if r == t.rows and c == t.cols:
                        mask[ri, ci] = True
        return mask
