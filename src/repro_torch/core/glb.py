"""Global load balancer (GLB) on the relocation engine, in PyTorch.

The paper's headline capability — "programs adapt to uneven or evolving
cluster performance" (§4.5, §6.3) — shipped in this repo only as
one-shot move *plans* (``balancer.py``) that callers had to drive by
hand.  This module turns it into a library feature:

* **Accounting** — per-place compute time exchanged with
  ``teamed.allgather1`` (the paper's load-balancer cost exchange),
  optionally EMA-smoothed across windows.
* **Policy slot** — any object with ``plan(times, loads) ->
  BalanceDecision``; :class:`~repro_torch.core.balancer.LevelExtremes` and
  :class:`~repro_torch.core.balancer.Proportional` plug in unchanged.
* **Asynchronous relocation** — decisions execute through
  :meth:`CollectiveMoveManager.sync_async`, so the counts Alltoall and
  payload packing overlap the caller's critical-path compute; the next
  ``step()`` (or an explicit ``finish()``) is the reconciling barrier.
* **Lifeline work stealing** — an idle place first tries a few random
  victims, then walks its *lifeline graph* (ring or hypercube, after
  Saraswat et al.'s lifeline-based GLB); termination is detected when a
  whole steal pass acquires nothing and every place is idle.
* **SPMD mirror** — :func:`spmd_rebalance` applies a
  :class:`BalanceDecision` as tensor code over the place dimension, a
  capacity-masked shuffle reusing :func:`spmd_relocate`.
* **Device steal loop** — ``device_loop=True`` makes
  :meth:`GlobalLoadBalancer.steal_loop` run all steal rounds on the
  group's device (``core/spmd_glb.py``): outstanding-work counters,
  lifeline-masked victim selection, one hand-off over the place
  dimension, with the tracked distribution reconciled once at the end
  and final loads matching the host ``steal_pass`` policy exactly.
* **Double-buffered windows** — ``GLBConfig(pipeline_depth=2)`` holds
  two in-flight ``sync_async`` windows: window N's delivery (and
  distribution reconciliation) runs on a background thread while window
  N+1 packs and the caller computes; stats account each window
  individually as it commits.
* **Failure awareness** — :meth:`GlobalLoadBalancer.evict_place`
  removes a dead member: the lifeline graph is rebuilt over the
  survivors, and planning/stealing mask the dead member out so no move
  ever targets it (the serving runtime and
  ``runtime/fault_tolerance.py`` call this from the heartbeat path).

Work sources are abstracted behind a two-method protocol (``loads`` /
``transfer``) so the same balancer drives relocatable collections
(PlhamJ agents, K-Means points), plain per-place work lists (MolDyn
force tiles), and traffic-keyed pools (loads may be any integer cost
units: entries, KV token pages, or EWMA-weighted traffic).
:class:`MultiCollectionWorkload` carries several co-partitioned
collections through one ``sync_async`` window (paper Listing 12).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, fields
from typing import Any, Callable, Protocol, Sequence

import numpy as np
import torch

from . import telemetry
from .balancer import BalanceDecision, LevelExtremes, Proportional
from .collections import DistArray, PlaceGroup
from .relocation import AsyncRelocation, CollectiveMoveManager
from .teamed import allgather1

__all__ = [
    "GLBConfig",
    "GLBStats",
    "GlobalLoadBalancer",
    "Workload",
    "DistArrayWorkload",
    "ListWorkload",
    "MultiCollectionWorkload",
    "ring_lifelines",
    "hypercube_lifelines",
    "lifeline_bfs",
    "moves_to_matrix",
    "spmd_rebalance",
    "ClusterSim",
]


# ---------------------------------------------------------------------------
# Lifeline graphs
# ---------------------------------------------------------------------------
def ring_lifelines(n: int) -> dict[int, tuple[int, ...]]:
    """Directed ring: place i's lifeline is (i+1) mod n.  Diameter n-1 —
    simple, but steal requests can take O(n) hops to find work."""
    if n <= 1:
        return {0: ()} if n else {}
    return {i: ((i + 1) % n,) for i in range(n)}


def hypercube_lifelines(n: int) -> dict[int, tuple[int, ...]]:
    """Hypercube lifelines: neighbors differ in one bit of the member
    index (clipped to [0, n)).  log2(n) links per place, diameter
    ceil(log2 n) — the topology the lifeline-GLB literature recommends
    for fast work diffusion."""
    if n <= 1:
        return {0: ()} if n else {}
    bits = max(1, (n - 1).bit_length())
    out = {}
    for i in range(n):
        nbrs = []
        for b in range(bits):
            j = i ^ (1 << b)
            if j < n:
                nbrs.append(j)
        out[i] = tuple(nbrs)
    return out


_LIFELINES: dict[str, Callable[[int], dict[int, tuple[int, ...]]]] = {
    "ring": ring_lifelines,
    "hypercube": hypercube_lifelines,
}


def lifeline_bfs(lifelines: dict[int, tuple[int, ...]],
                 start: int) -> list[tuple[int, int]]:
    """Victim candidates of a thief at ``start``, as (victim, hops) in
    breadth-first order over the lifeline graph (hop-1 neighbors first,
    in adjacency order).  The single source of the steal candidate
    order: the host :meth:`GlobalLoadBalancer.steal` walks it directly,
    and the device loop bakes it into static tables
    (:func:`repro_torch.core.spmd_glb.steal_candidates`) — host/device parity
    depends on both consuming this one definition."""
    seen, frontier, hops = {start}, [start], 0
    out: list[tuple[int, int]] = []
    while frontier:
        hops += 1
        nxt = []
        for u in frontier:
            for v in lifelines.get(u, ()):
                if v not in seen:
                    seen.add(v)
                    nxt.append(v)
                    out.append((v, hops))
        frontier = nxt
    return out


# ---------------------------------------------------------------------------
# Work sources
# ---------------------------------------------------------------------------
class Workload(Protocol):
    """What the GLB balances: anything that can report per-member loads
    and transfer entries between members."""

    def loads(self) -> np.ndarray:  # int64 (n_members,)
        ...

    def transfer(self, moves: Sequence[tuple[int, int, int]], *,
                 asynchronous: bool = False,
                 after: AsyncRelocation | None = None
                 ) -> AsyncRelocation | None:
        """Execute (src_member, dest_member, count) moves; async mode
        returns an :class:`AsyncRelocation` to finish later.  ``after``
        chains the window behind a predecessor (pipeline_depth >= 2)."""
        ...


class DistArrayWorkload:
    """A :class:`DistArray` balanced over ``members`` (defaults to its
    whole group).  Transfers ride the §5.3 relocation engine and
    reconcile the tracked distribution on finish."""

    def __init__(self, col: DistArray, members: Sequence[int] | None = None,
                 *, min_keep: int = 1, transport=None):
        self.col = col
        self.members = tuple(members) if members is not None \
            else col.group.members
        self.min_keep = min_keep
        # Alltoallv back end for the per-window move managers; None
        # inherits the balancer's GLBConfig(transport=...) at attach
        from .transport import make_transport
        self.transport = None if transport is None \
            else make_transport(transport)
        self.last_transfer_count = 0   # entries actually moved (clamped)

    def loads(self) -> np.ndarray:
        return np.asarray([self.col.local_size(p) for p in self.members],
                          np.int64)

    def transfer(self, moves, *, asynchronous: bool = False, after=None):
        mm = CollectiveMoveManager(self.col.group, transport=self.transport)
        moved = 0
        for src_i, dest_i, count in moves:
            src, dest = self.members[src_i], self.members[dest_i]
            avail = self.col.local_size(src)
            n = min(int(count), max(avail - self.min_keep, 0))
            if n > 0:
                self.col.move_at_sync_count(src, n, dest, mm)
                moved += n
        self.last_transfer_count = moved
        if not mm.pending():
            return None
        update = (self.col,) if self.col.track else ()
        handle = mm.sync_async(update_dists=update, after=after)
        if not asynchronous:
            handle.finish()
        return handle


class MultiCollectionWorkload(DistArrayWorkload):
    """Several co-partitioned collections balanced as one unit (paper
    Listing 12: multiple collections registered under a single
    ``CollectiveMoveManager`` sync).

    The ``primary`` collection drives planning (its entry counts are the
    loads); every companion must hold the *same range layout* so the
    lazily-resolved count moves pick identical ranges — which makes one
    ``sync_async`` window carry, e.g., KV pages and sequence metadata
    together, keeping them co-resident across migrations.
    """

    def __init__(self, primary: DistArray, companions: Sequence[DistArray],
                 members: Sequence[int] | None = None, *, min_keep: int = 1,
                 transport=None):
        super().__init__(primary, members, min_keep=min_keep,
                         transport=transport)
        self.companions = tuple(companions)

    def layouts_consistent(self) -> bool:
        """True when every companion mirrors the primary's range layout
        (the co-partitioning invariant transfers preserve)."""
        return all(
            all(comp.ranges(p) == self.col.ranges(p) for p in self.members)
            for comp in self.companions)

    def transfer(self, moves, *, asynchronous: bool = False, after=None):
        # count moves resolve lazily from each collection's own chunks —
        # a drifted companion would silently ship different entries, so
        # check the invariant once per window (registration below does
        # not mutate layouts, so per-move re-checks would be redundant)
        if moves and not self.layouts_consistent():
            raise ValueError(
                "companion layout diverged from primary; co-partitioned "
                "collections must hold identical range layouts")
        mm = CollectiveMoveManager(self.col.group, transport=self.transport)
        moved = 0
        for src_i, dest_i, count in moves:
            src, dest = self.members[src_i], self.members[dest_i]
            avail = self.col.local_size(src)
            n = min(int(count), max(avail - self.min_keep, 0))
            if n > 0:
                self.col.move_at_sync_count(src, n, dest, mm)
                for comp in self.companions:
                    comp.move_at_sync_count(src, n, dest, mm)
                moved += n
        self.last_transfer_count = moved
        if not mm.pending():
            return None
        update = tuple(c for c in (self.col, *self.companions) if c.track)
        handle = mm.sync_async(update_dists=update, after=after)
        if not asynchronous:
            handle.finish()
        return handle


class ListWorkload:
    """Per-member Python lists of work items (e.g. MolDyn force tiles).
    ``weight`` maps an item to its cost in load units; transfers pop
    items from the source until the requested load has moved."""

    def __init__(self, lists: Sequence[list], *,
                 weight: Callable[[Any], int] = lambda item: 1,
                 min_keep: int = 0):
        self.lists = list(lists)
        self.weight = weight
        self.min_keep = min_keep
        self.last_transfer_count = 0

    def loads(self) -> np.ndarray:
        return np.asarray([sum(self.weight(it) for it in lst)
                           for lst in self.lists], np.int64)

    def transfer(self, moves, *, asynchronous: bool = False, after=None):
        del asynchronous, after  # host lists: transfer is immediate
        total = 0
        for src_i, dest_i, count in moves:
            src = self.lists[src_i]
            moved = 0
            while src and len(src) > self.min_keep and moved < count:
                item = src.pop()
                self.lists[dest_i].append(item)
                moved += self.weight(item)
            total += moved
        self.last_transfer_count = total
        return None


# ---------------------------------------------------------------------------
# Config / stats
# ---------------------------------------------------------------------------
@dataclass
class GLBConfig:
    period: int = 10             # iterations between policy rebalances
    policy: Any = "level_extremes"  # name or plan(times, loads) object
    ema: float = 0.0             # smooth timings across windows
    asynchronous: bool = True    # overlap relocation with caller compute
    pipeline_depth: int = 1      # in-flight migration windows (2 = double
    #                              buffer: window N delivers in the
    #                              background while N+1 packs)
    lifeline: str = "hypercube"  # "ring" | "hypercube"
    transport: Any = "host"      # relocation data plane: "host"
    #                              (in-process loopback), "device" (codec
    #                              rows exchanged on the group's device),
    #                              or a RelocationTransport instance
    random_steal_attempts: int = 2
    steal_ratio: float = 0.5     # fraction of victim surplus per steal
    idle_threshold: int = 0      # idle when load <= this
    min_keep: int = 1            # victim never drops below this
    seed: int = 0
    sanitize: bool = False       # enable the relocation sanitizer
    #                              (repro_torch.analysis.sanitizer) for
    #                              this process: race detector +
    #                              transport invariants on every window

    def make_policy(self):
        if not isinstance(self.policy, str):
            return self.policy
        return {"level_extremes": LevelExtremes,
                "proportional": Proportional}[self.policy]()


@dataclass
class GLBStats:
    rebalances: int = 0
    entries_rebalanced: int = 0
    steals_attempted: int = 0
    steals_served: int = 0
    entries_stolen: int = 0
    steal_hops: int = 0
    steal_latency_us: float = 0.0   # accumulated wall time in steal()
    bytes_moved: int = 0            # relocation payload bytes (rebalances)
    syncs_overlapped: int = 0
    syncs_total: int = 0
    places_evicted: int = 0         # dead members removed from the graph

    @property
    def overlap_fraction(self) -> float:
        return self.syncs_overlapped / max(self.syncs_total, 1)

    def as_dict(self, prefix: str = "glb.") -> dict:
        """Flat ``{name: number}`` view (bench JSON / registry shape)."""
        d = {f"{prefix}{f.name}": getattr(self, f.name)
             for f in fields(self)}
        d[f"{prefix}overlap_fraction"] = self.overlap_fraction
        return d

    def publish(self, registry=None) -> None:
        """Push the current totals into the metrics registry as
        ``glb.*`` gauges (the fields are already cumulative, so gauges
        — republishing overwrites rather than double counts)."""
        reg = registry if registry is not None else telemetry.metrics()
        for name, v in self.as_dict().items():
            reg.gauge(name).set(v)


# ---------------------------------------------------------------------------
# The balancer
# ---------------------------------------------------------------------------
class GlobalLoadBalancer:
    """Periodic policy-driven rebalancing + lifeline work stealing.

    Usage (the paper's Listing 7 loop, now one call per iteration)::

        glb = GlobalLoadBalancer(group, DistArrayWorkload(col), GLBConfig())
        for it in range(iters):
            t = compute(...)          # per-place compute times
            glb.record_all(t)
            glb.step()                # relocation overlaps next compute
        glb.finish()                  # drain the in-flight relocation

    ``step()`` first *finishes* the previous window's in-flight
    relocation (the reconciling barrier), then — every ``period``
    iterations — exchanges times via ``allgather1``, asks the policy for
    a plan, and launches it with ``sync_async`` so packing overlaps the
    caller's next compute phase.
    """

    def __init__(self, group: PlaceGroup | int, workload: Workload,
                 config: GLBConfig | None = None, *,
                 on_finish: Callable[[AsyncRelocation], None] | None = None,
                 device_loop: bool = False,
                 device_capacity: int | None = None):
        if isinstance(group, int):
            group = PlaceGroup(group)
        self.group = group
        self.workload = workload
        self.cfg = config or GLBConfig()
        if self.cfg.sanitize:
            # process-wide switch: every migration window this balancer
            # (or anything else in the process) launches is checked —
            # managers constructed with sanitize=None inherit it
            from ..analysis import sanitizer as _san
            _san.enable()
        # device_loop: steal_loop() runs the device steal loop
        # (core/spmd_glb.py) instead of the host steal_pass loop
        self.device_loop = device_loop
        self.device_capacity = device_capacity
        # fires after a migration window's delivery + distribution
        # reconciliation — the hook consumers (e.g. the serving Router's
        # dispatch table) use to refresh exactly once per window
        self.on_finish = on_finish
        self.n = group.size()
        # cfg.min_keep is the victim floor for BOTH paths: steal uses it
        # directly; rebalance transfers clamp in the workload, so push
        # the (stricter) config floor down to it.
        if hasattr(workload, "min_keep"):
            workload.min_keep = max(workload.min_keep, self.cfg.min_keep)
        # one transport instance for every migration window of this
        # balancer.  A workload constructed with its
        # own transport keeps it — and the balancer adopts it, so the
        # steal loop's data plane always matches the migration windows'.
        # A transport a *previous* balancer injected does not count as
        # user-supplied: `_transport_from_glb` remembers the injected
        # *instance*, so re-attaching under a new config re-resolves,
        # while a transport the user assigned directly (a different
        # object) is always respected.
        from .transport import make_transport
        if getattr(workload, "transport", None) is not None \
                and workload.transport \
                is not getattr(workload, "_transport_from_glb", None):
            self.transport = workload.transport
        else:
            self.transport = make_transport(self.cfg.transport)
            if hasattr(workload, "transport"):
                workload.transport = self.transport
                workload._transport_from_glb = self.transport
        self.policy = self.cfg.make_policy()
        self._alive: list[int] = list(range(self.n))
        self.lifelines = _LIFELINES[self.cfg.lifeline](self.n)
        self.rng = np.random.default_rng(self.cfg.seed)
        self.stats = GLBStats()
        self.history: list[BalanceDecision] = []
        self.iter = 0
        self._acc = np.zeros(self.n, np.float64)
        self._smoothed: np.ndarray | None = None
        # FIFO of in-flight migration windows; cfg.pipeline_depth bounds
        # its length (1 = the classic single pending window)
        self._pending: list[AsyncRelocation] = []
        self._terminated = False
        self.last_trace: dict[str, float] | None = None

    # -- time accounting (the allGather1 feed, paper §4.5) ---------------
    def record(self, member: int, seconds: float) -> None:
        self._acc[member] += seconds

    def record_all(self, seconds) -> None:
        self._acc += np.asarray(seconds, np.float64)

    # -- failure awareness (heartbeat → eviction, ROADMAP FT-GLB item) ----
    def alive_members(self) -> tuple[int, ...]:
        return tuple(self._alive)

    def evict_place(self, member: int) -> None:
        """Remove a dead member: settle any in-flight relocation, rebuild
        the lifeline graph over the survivors, and zero its accumulated
        timings so planning and stealing never target it again.  The
        caller is responsible for re-homing its entries first
        (``CollectiveMoveManager.register_drain``)."""
        if member not in self._alive:
            return
        self.finish()
        self._alive.remove(member)
        self._rebuild_lifelines()
        self._acc[member] = 0.0
        if self._smoothed is not None:
            self._smoothed[member] = 0.0
        self.stats.places_evicted += 1

    def _rebuild_lifelines(self) -> None:
        base = _LIFELINES[self.cfg.lifeline](len(self._alive))
        self.lifelines = {
            self._alive[i]: tuple(self._alive[j] for j in nbrs)
            for i, nbrs in base.items()}

    # -- the periodic loop ------------------------------------------------
    def step(self) -> BalanceDecision | None:
        """Advance one iteration; every ``period`` iterations exchange
        times, plan, and launch the relocation.  Returns the decision on
        trigger iterations (possibly with zero moves), else None.

        With ``cfg.pipeline_depth == 1`` the previous window is finished
        here — the classic reconciling barrier.  With ``depth >= 2`` the
        pipeline only drains down to ``depth - 1`` windows (committing
        the oldest, whose delivery already ran in the background), and
        planning waits on the newest window's *counts* only — so window
        N's delivery overlaps the caller's compute and window N+1's
        packing."""
        depth = max(1, int(self.cfg.pipeline_depth))
        if depth <= 1:
            self.finish()
        else:
            while len(self._pending) >= depth:
                self._finish_oldest()
        self.iter += 1
        if self.iter % self.cfg.period != 0:
            return None
        if self._pending:
            # the newest in-flight window must *deliver* before loads
            # are read: extracted-but-undelivered entries are visible at
            # neither source nor destination, so the policy would see a
            # phantom deficit and over-ship into the in-flight target.
            # Delivery has been running in the background since launch,
            # so by the next trigger this wait is normally instant; only
            # the cheap accounting commit stays deferred.
            self._pending[-1].wait_delivered()
        if telemetry.enabled():
            # registry polls these cumulative totals at read time
            telemetry.metrics().add_publisher(id(self.stats),
                                              self.stats.publish)
        with telemetry.span("glb.plan") as sp:
            times = allgather1(self.group, self._acc)  # teamed cost exchange
            if self.cfg.ema > 0:
                if self._smoothed is None:
                    self._smoothed = times
                else:
                    self._smoothed = (self.cfg.ema * self._smoothed
                                      + (1 - self.cfg.ema) * times)
                times = self._smoothed
            loads = np.asarray(self.workload.loads())
            if len(self._alive) < self.n:
                # compact to the surviving members, plan, remap the move
                # indices back — a dead place is never a source or target
                alive = self._alive
                sub = self.policy.plan(np.asarray(times)[alive],
                                       loads[alive])
                decision = BalanceDecision(tuple(
                    (alive[s], alive[d], c) for s, d, c in sub.moves))
            else:
                decision = self.policy.plan(times, loads)
            self._acc[:] = 0.0
            self.history.append(decision)
            if decision.moves:
                self.stats.rebalances += 1
                kw = {}
                if depth > 1 and self._pending:
                    # chain the new window behind the newest in-flight
                    # one: extraction and delivery stay FIFO
                    kw["after"] = self._pending[-1]
                handle = self.workload.transfer(
                    decision.moves, asynchronous=self.cfg.asynchronous,
                    **kw)
                if handle is not None:
                    self._pending.append(handle)
                    if depth > 1:
                        # double buffer: delivery starts as soon as
                        # phase 1 completes, overlapping the caller's
                        # next compute
                        handle.enqueue()
                # account what actually moved after min_keep/
                # availability clamping, not the policy's planned total
                self.stats.entries_rebalanced += getattr(
                    self.workload, "last_transfer_count",
                    decision.total_moved)
            if sp:
                sp.set(iter=self.iter, moves=len(decision.moves))
            return decision

    def has_pending(self) -> bool:
        """True while a launched migration window has not been committed
        (its delivery barrier — and the ``on_finish`` hook — are still
        ahead)."""
        return bool(self._pending)

    def wait_extracted(self, timeout: float | None = None) -> bool:
        """Block until every in-flight window's phase 1 — the counts
        exchange plus payload *extraction* — has completed (and, by
        FIFO chaining, every predecessor's delivery).  After a True
        return, entries still resident in the workload's collections
        are provably not in any in-flight payload, so the caller may
        mutate them without racing a background transport encode — the
        guarantee device-plane consumers (the serving driver's decode
        rounds) need before touching resident state.  No-op when idle;
        False when ``timeout`` expires first."""
        if not self._pending:
            return True
        # the newest window's phase 1 only starts after its predecessor
        # delivered, so waiting on it covers the whole pipeline
        return self._pending[-1].wait_counts(timeout) is not None

    def _finish_oldest(self) -> None:
        """Commit the oldest in-flight window, accounting its stats
        per window (overlap, bytes, trace) — with ``pipeline_depth >= 2``
        several handles are in flight at once and each one is accounted
        individually as it commits.

        The handle is detached *before* the barrier: if phase 1 raised on
        the background thread the exception propagates here, but the
        balancer is left consistent so the caller can keep stepping
        after handling it.  A failed window still lands in the overlap
        *denominator* as not-overlapped (``overlapped`` is False for an
        errored handle) — silently dropping it would overstate
        ``overlap_fraction``; only the bytes accounting and the
        ``on_finish`` hook are success-only, since a failed window
        published nothing."""
        pending = self._pending.pop(0)
        try:
            pending.finish()
        finally:
            self.stats.syncs_total += 1
            if pending.overlapped:
                self.stats.syncs_overlapped += 1
            self.last_trace = dict(pending.trace)
        self.stats.bytes_moved += pending.manager.last_payload_bytes
        if self.on_finish is not None:
            self.on_finish(pending)

    def finish(self) -> None:
        """Barrier for every in-flight migration window (no-op when
        idle): commits the whole pipeline, FIFO."""
        while self._pending:
            self._finish_oldest()

    # -- lifeline stealing ------------------------------------------------
    def _serve(self, victim: int, thief: int) -> int:
        """How much ``victim`` can give ``thief`` right now."""
        load = int(self.workload.loads()[victim])
        surplus = load - self.cfg.min_keep
        if surplus <= 0:
            return 0
        return max(1, int(surplus * self.cfg.steal_ratio))

    def steal(self, thief: int) -> int:
        """Acquire work for an idle ``thief``: first
        ``random_steal_attempts`` random victims, then a breadth-first
        walk of the lifeline graph.  Returns entries acquired (0 means
        the thief hangs on its lifelines — with every place in that
        state, the computation has terminated)."""
        if thief not in self._alive:
            return 0
        self.finish()   # never race an in-flight rebalance
        with telemetry.span("glb.steal", thief=thief) as sp:
            got = self._steal(thief)
            if sp:
                sp.set(acquired=got)
            return got

    def _steal(self, thief: int) -> int:
        t0 = time.perf_counter()
        self.stats.steals_attempted += 1
        loads = self.workload.loads()
        candidates: list[tuple[int, int]] = []  # (victim, hops)
        others = [p for p in self._alive if p != thief]
        if others and self.cfg.random_steal_attempts > 0:
            picks = self.rng.choice(
                others, size=min(self.cfg.random_steal_attempts, len(others)),
                replace=False)
            candidates += [(int(v), 1) for v in picks]
        # lifeline BFS (termination-safe: bounded by graph size); shared
        # with the device loop's static candidate tables
        candidates += lifeline_bfs(self.lifelines, thief)
        for victim, nhops in candidates:
            if loads[victim] <= self.cfg.min_keep:
                continue
            count = self._serve(victim, thief)
            if count <= 0:
                continue
            handle = self.workload.transfer(((victim, thief, count),))
            if handle is not None:
                self.stats.bytes_moved += handle.manager.last_payload_bytes
            count = getattr(self.workload, "last_transfer_count", count)
            if count <= 0:
                continue
            self.stats.steals_served += 1
            self.stats.entries_stolen += count
            self.stats.steal_hops += nhops
            self.stats.steal_latency_us += (time.perf_counter() - t0) * 1e6
            return count
        self.stats.steal_latency_us += (time.perf_counter() - t0) * 1e6
        return 0

    def steal_pass(self) -> int:
        """One round of stealing: every idle place tries to acquire
        work.  Sets the terminated flag when nothing moved and every
        place is idle (distributed termination detection, host model —
        device-side this is a test over the outstanding-work counters)."""
        if telemetry.enabled():
            # registry polls these cumulative totals at read time
            telemetry.metrics().add_publisher(id(self.stats),
                                              self.stats.publish)
        with telemetry.span("glb.steal_round") as sp:
            self.finish()
            loads = self.workload.loads()
            total = 0
            for p in self._alive:
                if loads[p] <= self.cfg.idle_threshold:
                    total += self.steal(p)
            if total == 0 and bool(
                    np.all(np.asarray(self.workload.loads())[self._alive]
                           <= self.cfg.idle_threshold)):
                self._terminated = True
            if sp:
                sp.set(stolen=total, terminated=self._terminated)
            return total

    def is_terminated(self) -> bool:
        return self._terminated

    def steal_loop(self, max_rounds: int = 12) -> dict:
        """Run steal rounds until a whole round acquires nothing (or
        ``max_rounds``).  Host mode: a Python loop of
        :meth:`steal_pass`, one relocation window per steal.  With
        ``device_loop=True`` (constructor): the device steal loop
        (``core/spmd_glb.py``) — outstanding-work counters,
        lifeline-masked victim selection, one hand-off over the place
        dimension — runs all rounds on the group's device, then
        reconciles the tracked distribution once at the end.  The device loop implements the
        host ``steal_pass`` policy exactly (it requires
        ``random_steal_attempts == 0`` — the deterministic lifeline-only
        policy), so the final per-place load vector, round count, and
        steal stats match the host path exactly; which specific entries
        land where may differ (count moves let the library pick the
        entries on both paths).  Returns ``{"rounds", "stolen",
        "device"}``."""
        self.finish()
        if not self.device_loop:
            rounds = stolen = 0
            while rounds < max_rounds:
                moved = self.steal_pass()
                rounds += 1
                stolen += moved
                if moved == 0:
                    break
            return {"rounds": rounds, "stolen": stolen, "device": False}
        if self.cfg.random_steal_attempts != 0:
            raise ValueError(
                "device_loop runs the deterministic lifeline-only steal "
                "policy; configure GLBConfig(random_steal_attempts=0)")
        if type(self.workload) is not DistArrayWorkload:
            raise TypeError(
                "device_loop currently balances a DistArrayWorkload "
                f"(got {type(self.workload).__name__})")
        if self.workload.min_keep != self.cfg.min_keep:
            raise ValueError(
                "device_loop needs one victim floor: workload.min_keep "
                f"({self.workload.min_keep}) != cfg.min_keep "
                f"({self.cfg.min_keep})")
        from .spmd_glb import run_device_steal
        t0 = time.perf_counter()
        res = run_device_steal(
            self.workload.col, self.lifelines, self._alive,
            steal_ratio=self.cfg.steal_ratio, min_keep=self.cfg.min_keep,
            idle_threshold=self.cfg.idle_threshold, max_rounds=max_rounds,
            capacity=self.device_capacity,
            # device-plane transports (DeviceTransport or any custom
            # backend declaring device_plane=True): codec rows ride the
            # loop's hand-off instead of materializing by id
            ship_rows=bool(getattr(self.transport, "device_plane",
                                   False)))
        dt_us = (time.perf_counter() - t0) * 1e6
        st = self.stats
        st.steals_attempted += res["attempted"]
        st.steals_served += res["served"]
        st.entries_stolen += res["stolen"]
        st.steal_hops += res["hops"]
        st.steal_latency_us += dt_us
        st.bytes_moved += res["bytes_moved"]
        if res["terminated"]:
            self._terminated = True
        return {"rounds": res["rounds"], "stolen": res["stolen"],
                "device": True}


# ---------------------------------------------------------------------------
# SPMD mirror — apply a BalanceDecision over the place dimension
# ---------------------------------------------------------------------------
def moves_to_matrix(decision: BalanceDecision, n: int) -> np.ndarray:
    """(n, n) int32 matrix M with M[s, d] = entries s ships to d."""
    m = np.zeros((n, n), np.int32)
    for s, d, c in decision.moves:
        m[s, d] += c
    return m


def spmd_rebalance(x, valid, move_matrix, *, capacity: int,
                   extras: tuple = ()):
    """Device-side GLB: shuffle rows between places per ``move_matrix``.

    ``x``: (P, n, ...) rows of every place, ``valid``: (P, n).  Each
    place reads its row of the (P, P) move matrix, assigns its first
    ``sum(row)`` valid rows to the planned destinations (in rank order),
    keeps the rest, and runs one capacity-masked exchange via
    :func:`spmd_relocate`.  The input validity mask rides along as an
    extra so padding rows never materialize as real entries.  Returns
    ``(new_rows, new_valid)`` with shapes ``(P, P*capacity, ...)`` /
    ``(P, P*capacity)``; with ``extras`` it returns ``(new_rows,
    new_valid, new_extras)``.
    """
    from .relocation import spmd_relocate

    P = x.shape[0]
    dev = x.device
    mm = torch.as_tensor(move_matrix).to(dev, torch.int64)
    bounds = mm.cumsum(1)                                  # (P, P)
    total_out = bounds[:, -1]
    validb = valid.to(torch.bool)
    rank = validb.to(torch.int64).cumsum(1) - 1            # rank among valid
    planned = torch.searchsorted(bounds, rank, right=True)
    outgoing = validb & (rank < total_out[:, None])
    me = torch.arange(P, device=dev)[:, None].expand_as(rank)
    # padding rows route to the out-of-range destination P, which the
    # pack drops — they must not compete with real rows for capacity
    dest = torch.where(outgoing, planned.clamp(max=P - 1),
                       torch.where(validb, me, torch.full_like(me, P)))
    out = spmd_relocate(x, dest, capacity=capacity,
                        extras=(validb.to(torch.int32),) + tuple(extras))
    new_valid = out["recv_valid"] & (out["recv_extras"][0] > 0)
    if not extras:
        return out["recv"], new_valid
    return out["recv"], new_valid, tuple(out["recv_extras"][1:])


# ---------------------------------------------------------------------------
# Synthetic-cluster harness (paper §6.3: even / uneven / disturbed)
# ---------------------------------------------------------------------------
@dataclass
class ClusterSim:
    """A simulated cluster driving a GLB over a DistArray of work items.

    Place p processes an entry in ``1/speeds[p]`` time units; the
    "Disturb" parasite (paper §6.3) slows one host by ``disturb_factor``
    and moves to the next every ``disturb_period`` iterations.  One
    ``run()`` iteration = parallel compute (makespan = slowest place) +
    GLB accounting/step — the loop structure of the paper's Listing 7.
    """

    n_places: int
    n_entries: int = 1200
    speeds: tuple = ()
    disturb_period: int = 0
    disturb_factor: float = 0.4
    glb: GLBConfig | None = None
    seed: int = 0
    device: Any = None           # PlaceGroup device (cuda unless given)

    def __post_init__(self):
        from .distribution import LongRange
        self.group = PlaceGroup(self.n_places, device=self.device)
        self.col = DistArray(self.group, track=True)
        rows = torch.arange(self.n_entries, dtype=torch.float64)[:, None]
        for p, r in enumerate(
                LongRange(0, self.n_entries).split(self.n_places)):
            if r.size:
                self.col.add_chunk(p, r, rows[r.start:r.end])
        if not self.speeds:
            self.speeds = (1.0,) * self.n_places
        self.balancer = None
        if self.glb is not None:
            self.balancer = GlobalLoadBalancer(
                self.group, DistArrayWorkload(self.col), self.glb)
        self.iter = 0
        self.makespans: list[float] = []

    def _speed(self, p: int) -> float:
        s = self.speeds[p]
        if self.disturb_period:
            victim = (self.iter // self.disturb_period) % self.n_places
            if p == victim:
                s *= self.disturb_factor
        return s

    def run(self, iters: int) -> float:
        """Simulated wall time of ``iters`` iterations."""
        for _ in range(iters):
            if self.balancer is not None:
                # settle the previous window before reading loads (its
                # phase 1 extracts entries on a background thread)
                self.balancer.finish()
            loads = np.asarray(
                [self.col.local_size(p) for p in self.group.members],
                np.float64)
            t = loads / np.asarray([self._speed(p)
                                    for p in self.group.members])
            self.makespans.append(float(t.max()))
            if self.balancer is not None:
                self.balancer.record_all(np.maximum(t, 1e-9))
                self.balancer.step()
            self.iter += 1
        if self.balancer is not None:
            self.balancer.finish()
        return float(np.sum(self.makespans[-iters:]))
