"""Failure detection and re-homing for in-process place groups.

The port of the parts of ``repro.runtime.fault_tolerance`` that the
elastic serving driver needs: :class:`HeartbeatMonitor` (a place silent
for ``timeout_steps`` is declared dead), :func:`rehome_dead_place` (a
dead place's entries re-home on the survivors through one relocation
window) and :class:`ElasticWorld` (shrink or grow the place group).
``ElasticWorld.resize``, ``StragglerMitigator``, ``recover_dead_ranks``,
the SPMD drain registration and ``FaultTolerantDriver`` wait for the
port of ``core/distributed.py`` (ROADMAP.md queue 1).
"""
from __future__ import annotations

import numpy as np

from ..core import CollectiveMoveManager, PlaceGroup

__all__ = ["HeartbeatMonitor", "ElasticWorld", "rehome_dead_place"]


def rehome_dead_place(group: PlaceGroup, dead: int, collections,
                      *, dests=None, transport=None) -> int:
    """Drain-and-re-home: move every entry held by ``dead`` onto the
    surviving places through one collective relocation window (all
    collections ride the same sync — paper Listing 12), then reconcile
    the tracked distributions.  Returns the number of entries re-homed.
    The window rides the caller's relocation ``transport``."""
    if getattr(group, "process_backed", False):
        raise NotImplementedError(
            "process-backed groups need the distributed slice (ROADMAP.md "
            "queue 1)")
    dests = [p for p in (dests if dests is not None else group.members)
             if p != dead and p in group]
    mm = CollectiveMoveManager(group, transport=transport)
    moved = 0
    for col in collections:
        moved += mm.register_drain(col, dead, dests)
    if mm.pending():
        mm.sync()
    for col in collections:
        if hasattr(col, "update_dist") and getattr(col, "track", True):
            col.update_dist()
    return moved


class HeartbeatMonitor:
    def __init__(self, n_places: int, timeout_steps: int = 3):
        self.n = n_places
        self.timeout = timeout_steps
        self.last_seen = np.zeros(n_places, np.int64)
        self.step = 0
        self.dead: set[int] = set()

    def beat(self, place: int) -> None:
        self.last_seen[place] = self.step

    def tick(self) -> list[int]:
        """Advance one step; return newly-dead places."""
        self.step += 1
        newly = [p for p in range(self.n)
                 if p not in self.dead
                 and self.step - self.last_seen[p] > self.timeout]
        self.dead.update(newly)
        return newly

    def alive(self) -> list[int]:
        return [p for p in range(self.n) if p not in self.dead]


class ElasticWorld:
    """Shrink the place group when a place dies, re-homing its entries."""

    def __init__(self, group: PlaceGroup):
        self.group = group
        self.events: list[tuple[str, int]] = []

    def evict(self, dead: int, collections=(),
              transport=None) -> PlaceGroup:
        """Drop ``dead`` from the group and re-home its entries on the
        survivors via the relocation engine (one collective window for
        all collections, on the caller's relocation ``transport``)."""
        if dead not in self.group.members:
            return self.group
        survivors = [p for p in self.group.members if p != dead]
        if not survivors:
            raise ValueError("cannot evict the last place")
        rehome_dead_place(self.group, dead, collections,
                          transport=transport)
        new_group = self.group.subgroup(survivors)
        for col in collections:
            col.group = new_group
            col._handles.pop(dead, None)
        self.events.append(("evict", dead))
        self.group = new_group
        return new_group
