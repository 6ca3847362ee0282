"""Range-based distribution tracking (paper §4.6).

The paper tracks entry ownership of ``DistCol``/``DistIdMap`` with
*range descriptions* (``LongRangeDistribution``) rather than per-index
records, and reconciles the per-place views lazily through a teamed
``updateDist`` that exchanges only the deltas since the previous call.

This module is the PyTorch port of ``repro.core.distribution``:

* :class:`LongRange` — half-open ``[start, end)`` index range.
* :class:`RangeDistribution` — an ordered table of disjoint ranges →
  owner (place/shard id), with delta extraction/application so
  ``update_dist`` can exchange only changes, and a device-side
  ``lookup`` (``torch.searchsorted`` over the range starts) so tensor
  code on the card can route entries by key — the mechanism behind
  ``contractedOrders.relocate(agentDistribution)`` in the paper.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np
import torch

__all__ = ["LongRange", "RangeDistribution", "DistributionDelta"]


@dataclass(frozen=True, order=True)
class LongRange:
    """Half-open index range ``[start, end)`` (paper's ``LongRange``)."""

    start: int
    end: int

    def __post_init__(self):
        if self.end < self.start:
            raise ValueError(f"end {self.end} < start {self.start}")

    @property
    def size(self) -> int:
        return self.end - self.start

    def __len__(self) -> int:
        return self.size

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.start, self.end))

    def contains(self, idx: int) -> bool:
        return self.start <= idx < self.end

    def contains_range(self, other: "LongRange") -> bool:
        return self.start <= other.start and other.end <= self.end

    def overlaps(self, other: "LongRange") -> bool:
        return self.start < other.end and other.start < self.end

    def intersection(self, other: "LongRange") -> "LongRange | None":
        s, e = max(self.start, other.start), min(self.end, other.end)
        return LongRange(s, e) if s < e else None

    def split(self, n: int) -> list["LongRange"]:
        """Split into ``n`` contiguous near-equal pieces (may be empty)."""
        base, rem = divmod(self.size, n)
        out, cur = [], self.start
        for i in range(n):
            sz = base + (1 if i < rem else 0)
            out.append(LongRange(cur, cur + sz))
            cur += sz
        return out

    def __repr__(self) -> str:  # compact, used in manifests
        return f"[{self.start},{self.end})"


@dataclass(frozen=True)
class DistributionDelta:
    """A set of ownership changes since a version (paper: the information
    exchanged by ``updateDist`` — only changes, never the full table)."""

    version: int
    moves: tuple[tuple[int, int, int], ...]  # (start, end, new_owner)

    @property
    def nbytes(self) -> int:
        # 3 longs per move + version header, mirroring a compact wire format.
        return 8 * (3 * len(self.moves) + 1)


class RangeDistribution:
    """Ordered table of disjoint ``LongRange`` → owner place id.

    Internally a sorted structure-of-arrays (starts / ends / owners) so
    that (a) host operations are O(log n) and (b) the table can be
    exported to device for jitted routing via ``searchsorted``.
    """

    def __init__(self, entries: Iterable[tuple[LongRange, int]] = ()):  # noqa: D401
        self._starts: list[int] = []
        self._ends: list[int] = []
        self._owners: list[int] = []
        self._version = 0
        self._log: list[tuple[int, int, int, int]] = []  # (version, s, e, owner)
        for r, o in entries:
            self.assign(r, o)

    # ------------------------------------------------------------------
    # construction / mutation
    # ------------------------------------------------------------------
    @staticmethod
    def block(n: int, n_places: int) -> "RangeDistribution":
        """Even block distribution of ``[0, n)`` over ``n_places`` (the
        paper's initial uniform agent distribution)."""
        d = RangeDistribution()
        for p, r in enumerate(LongRange(0, n).split(n_places)):
            if r.size:
                d.assign(r, p)
        return d

    def assign(self, r: LongRange, owner: int) -> None:
        """Set ``owner`` for range ``r``, splitting/overwriting overlaps."""
        if r.size == 0:
            return
        self._remove_span(r.start, r.end)
        i = bisect.bisect_left(self._starts, r.start)
        self._starts.insert(i, r.start)
        self._ends.insert(i, r.end)
        self._owners.insert(i, owner)
        self._version += 1
        self._log.append((self._version, r.start, r.end, owner))
        self._coalesce_around(i)

    def remove(self, r: LongRange) -> None:
        if r.size == 0:
            return
        self._remove_span(r.start, r.end)
        self._version += 1
        self._log.append((self._version, r.start, r.end, -1))

    def _remove_span(self, s: int, e: int) -> None:
        i = bisect.bisect_right(self._ends, s)
        while i < len(self._starts) and self._starts[i] < e:
            cs, ce, co = self._starts[i], self._ends[i], self._owners[i]
            # remove current
            del self._starts[i], self._ends[i], self._owners[i]
            if cs < s:  # left remainder survives
                self._starts.insert(i, cs)
                self._ends.insert(i, s)
                self._owners.insert(i, co)
                i += 1
            if ce > e:  # right remainder survives
                self._starts.insert(i, e)
                self._ends.insert(i, ce)
                self._owners.insert(i, co)
                i += 1

    def _coalesce_around(self, i: int) -> None:
        """Merge adjacent ranges with identical owner (keeps table small —
        the paper's motivation for range descriptions)."""
        j = max(i - 1, 0)
        while j + 1 < len(self._starts):
            if (self._ends[j] == self._starts[j + 1]
                    and self._owners[j] == self._owners[j + 1]):
                self._ends[j] = self._ends[j + 1]
                del self._starts[j + 1], self._ends[j + 1], self._owners[j + 1]
                continue
            if j > i:
                break
            j += 1

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def owner_of(self, idx: int) -> int:
        i = bisect.bisect_right(self._starts, idx) - 1
        if i >= 0 and idx < self._ends[i]:
            return self._owners[i]
        raise KeyError(f"index {idx} not in distribution")

    def ranges_of(self, place: int) -> list[LongRange]:
        return [LongRange(s, e)
                for s, e, o in zip(self._starts, self._ends, self._owners)
                if o == place]

    def items(self) -> list[tuple[LongRange, int]]:
        return [(LongRange(s, e), o)
                for s, e, o in zip(self._starts, self._ends, self._owners)]

    def load_of(self, place: int) -> int:
        return sum(r.size for r in self.ranges_of(place))

    def loads(self, n_places: int) -> np.ndarray:
        out = np.zeros(n_places, dtype=np.int64)
        for s, e, o in zip(self._starts, self._ends, self._owners):
            out[o] += e - s
        return out

    @property
    def total(self) -> int:
        return sum(e - s for s, e in zip(self._starts, self._ends))

    @property
    def version(self) -> int:
        return self._version

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RangeDistribution):
            return NotImplemented
        return self.items() == other.items()

    def __repr__(self) -> str:
        body = ", ".join(f"{LongRange(s, e)}->{o}" for s, e, o in
                         zip(self._starts, self._ends, self._owners))
        return f"RangeDistribution({body})"

    # ------------------------------------------------------------------
    # delta exchange (lazy reconciliation, paper §4.6)
    # ------------------------------------------------------------------
    def delta_since(self, version: int) -> DistributionDelta:
        moves = tuple((s, e, o) for v, s, e, o in self._log if v > version)
        return DistributionDelta(self._version, moves)

    def apply_delta(self, delta: DistributionDelta) -> None:
        for s, e, o in delta.moves:
            if o < 0:
                self.remove(LongRange(s, e))
            else:
                self.assign(LongRange(s, e), o)

    def prune_log(self, keep_from_version: int = None) -> None:
        """Drop delta history (after all peers confirmed reconciliation)."""
        if keep_from_version is None:
            keep_from_version = self._version
        self._log = [t for t in self._log if t[0] > keep_from_version]

    def copy(self) -> "RangeDistribution":
        d = RangeDistribution()
        d._starts = list(self._starts)
        d._ends = list(self._ends)
        d._owners = list(self._owners)
        d._version = self._version
        return d

    # ------------------------------------------------------------------
    # device-side routing
    # ------------------------------------------------------------------
    def as_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (np.asarray(self._starts, np.int64),
                np.asarray(self._ends, np.int64),
                np.asarray(self._owners, np.int32))

    def lookup(self, idx: torch.Tensor) -> torch.Tensor:
        """Vectorized owner lookup on ``idx``'s device: the device-side
        half of ``relocate(distribution)`` — route each key to the place
        owning it. Unowned indices map to -1."""
        starts, ends, owners = self.as_arrays()
        idx = torch.as_tensor(idx)
        if len(starts) == 0:
            return torch.full(idx.shape, -1, dtype=torch.int32,
                              device=idx.device)
        s = torch.from_numpy(starts).to(idx.device)
        e = torch.from_numpy(ends).to(idx.device)
        o = torch.from_numpy(owners).to(idx.device)
        key = idx.to(torch.int64)
        pos = torch.searchsorted(s, key, right=True) - 1
        pos_c = pos.clamp(0, len(starts) - 1)
        ok = (pos >= 0) & (key < e[pos_c])
        return torch.where(ok, o[pos_c], -1).to(torch.int32)

    def lookup_host(self, idx) -> np.ndarray:
        """Numpy twin of :meth:`lookup` (same semantics, same -1 for
        unowned) for host-side routing tables."""
        starts, ends, owners = self.as_arrays()
        idx = np.asarray(idx)
        if len(starts) == 0:
            return np.full(idx.shape, -1, np.int32)
        pos = np.searchsorted(starts, idx, side="right") - 1
        pos_c = np.clip(pos, 0, len(starts) - 1)
        ok = (pos >= 0) & (idx < ends[pos_c])
        return np.where(ok, owners[pos_c], -1).astype(np.int32)
