"""Entry relocation — the paper's core mechanism (§3.4, §5.2, §5.3), in PyTorch.

Two halves, mirroring the paper's design:

* **Host half** — :class:`CollectiveMoveManager`: entries of any number
  of collections are *registered* for relocation (by range, by count,
  or by key→destination rule) and transferred when every participating
  place calls :meth:`CollectiveMoveManager.sync`.  The wire protocol is
  the paper's §5.3 two-phase exchange — Alltoall on byte counts, then
  Alltoallv on payload — which we account explicitly so benchmarks can
  report the communication volume.  *How* the Alltoallv payload crosses
  places is pluggable (``CollectiveMoveManager(transport=...)``,
  ``core/transport.py``): the default ``HostTransport`` is the
  in-process loopback; ``DeviceTransport`` encodes each payload's rows
  into fixed-width byte buffers on the group's device via the owning
  collection's row codec and exchanges them over the place dimension —
  both produce bit-identical final collection state.  ``sync_async(depth=2)`` double
  buffers the exchange: phase 2 is split into background *delivery*
  (:meth:`AsyncRelocation.enqueue`) and a cheap *commit*
  (:meth:`AsyncRelocation.finish`), so window N delivers while window
  N+1 runs its counts+packing — windows are chained so extraction and
  delivery stay FIFO-deterministic over the same collections.

* **SPMD half** — :func:`spmd_relocate` / :func:`spmd_relocate_back`:
  the same operation as tensor code over an explicit leading place
  dimension.  Raggedness becomes *capacity + validity mask*: each
  shard packs its outgoing rows into a ``(n_shards, capacity, ...)``
  buffer, the exchange over the place dimension (``transpose(0, 1)`` on
  one card) plays the role of Alltoallv, and masks carry the true
  counts — the MoE token-dispatch idiom.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..analysis import sanitizer as _san
from . import telemetry
from .collections import DistArray, DistBag, DistMap, PlaceGroup
from .distribution import LongRange
from .transport import TransportStats, make_transport

__all__ = [
    "AsyncRelocation",
    "CollectiveMoveManager",
    "spmd_relocate",
    "spmd_relocate_back",
    "spmd_counts",
]


# ---------------------------------------------------------------------------
# Host half
# ---------------------------------------------------------------------------
@dataclass
class _RangeMove:
    collection: DistArray
    r: LongRange
    dest: int


@dataclass
class _BagMove:
    collection: DistBag
    src: int
    count: int
    dest: int


@dataclass
class _ArrayCountMove:
    collection: DistArray
    src: int
    count: int
    dest: int


@dataclass
class _KeyMove:
    collection: DistMap
    src: int
    rule: Callable[[Any], int]


class CollectiveMoveManager:
    """Paper's ``CollectiveMoveManager``.

    Registration methods queue moves; ``sync()`` is the teamed barrier
    that executes them.  Multiple collections may participate in one
    sync (paper Listing 12), and the destination of an entry is free —
    any place of the group.
    """

    def __init__(self, group: PlaceGroup, transport=None, *,
                 sanitize: bool | None = None):
        self.group = group
        # the Alltoallv back end: None/"host" = in-process loopback
        # (verbatim pass-through), "device" = codec + exchange over the
        # place dimension, or any RelocationTransport instance
        self.transport = make_transport(transport)
        # sanitize=None defers to the process-wide switch (REPRO_SANITIZE
        # / repro_torch.analysis.sanitizer.enable()); an explicit True turns
        # the sanitizer on for the whole process — the race detector's
        # mutation hooks are global, a per-manager subset would miss
        # exactly the unsynchronized call sites it exists to catch
        if sanitize is None:
            sanitize = _san.active()
        elif sanitize and not _san.active():
            _san.enable()
        self.sanitize = bool(sanitize)
        self._range_moves: list[_RangeMove] = []
        self._bag_moves: list[_BagMove] = []
        self._key_moves: list[_KeyMove] = []
        self._array_count_moves: list[_ArrayCountMove] = []
        self._inflight: list["AsyncRelocation"] = []
        self.last_counts_matrix: np.ndarray | None = None
        self.last_payload_bytes = 0
        self.last_transport_stats: TransportStats | None = None
        self.syncs = 0

    # -- registration ----------------------------------------------------
    def register_range_move(self, col: DistArray, r: LongRange, dest: int) -> None:
        if dest not in self.group:
            raise KeyError(f"destination {dest} not in group")
        self._range_moves.append(_RangeMove(col, r, dest))

    def register_bag_move(self, col: DistBag, src: int, count: int, dest: int) -> None:
        if dest not in self.group:
            raise KeyError(f"destination {dest} not in group")
        self._bag_moves.append(_BagMove(col, src, count, dest))

    def register_array_count_move(self, col: DistArray, src: int, count: int,
                                  dest: int) -> None:
        """Bulk relocation resolved lazily at sync (so several count-based
        moves from one source compose — the library picks the entries)."""
        if dest not in self.group:
            raise KeyError(f"destination {dest} not in group")
        self._array_count_moves.append(_ArrayCountMove(col, src, count, dest))

    def register_key_moves(self, col: DistMap, src: int,
                           rule: Callable[[Any], int]) -> None:
        self._key_moves.append(_KeyMove(col, src, rule))

    def register_drain(self, col, src: int, dests: "Sequence[int]", *,
                       rule: Callable[[Any], int] | None = None) -> int:
        """Failure recovery: register moves that take *every* entry off
        ``src`` and spread them across ``dests`` (round-robin for keyed
        collections, near-equal counts for arrays/bags), unless ``rule``
        overrides the key→destination placement.  Composes with other
        registrations — the whole drain rides one sync window.  Returns
        the number of entries registered."""
        dests = [d for d in dests if d != src]
        if not dests:
            raise ValueError("drain needs at least one destination != src")
        if isinstance(col, DistMap):
            keys = col.keys(src)
            try:
                # deterministic round-robin: handle dicts are insertion-
                # ordered, and insertion order depends on how background
                # deliveries interleaved with admissions — sorting makes
                # the re-homing independent of that history
                keys = sorted(keys)
            except TypeError:
                pass   # unorderable key mix: keep insertion order
            if rule is None:
                assign = {k: dests[i % len(dests)]
                          for i, k in enumerate(keys)}
                rule = lambda k: assign.get(k, src)  # noqa: E731
            if keys:
                self.register_key_moves(col, src, rule)
            return len(keys)
        if isinstance(col, DistArray):
            total = col.local_size(src)
            share, rem = divmod(total, len(dests))
            for i, d in enumerate(dests):
                n = share + (1 if i < rem else 0)
                if n > 0:
                    self.register_array_count_move(col, src, n, d)
            return total
        if isinstance(col, DistBag):
            total = col.local_size(src)
            share, rem = divmod(total, len(dests))
            for i, d in enumerate(dests):
                n = share + (1 if i < rem else 0)
                if n > 0:
                    self.register_bag_move(col, src, n, d)
            return total
        raise TypeError(f"cannot drain collection type {type(col).__name__}")

    def pending(self) -> int:
        return (len(self._range_moves) + len(self._bag_moves)
                + len(self._key_moves) + len(self._array_count_moves))

    # -- the teamed sync ---------------------------------------------------
    def sync(self) -> None:
        """Execute all registered moves synchronously.

        Phase 1 (Alltoall): build the place×place byte-count matrix.
        Phase 2 (Alltoallv): move the payloads and insert at destination.
        """
        self.sync_async().finish()

    def sync_async(self, update_dists: tuple = (), *, depth: int = 1,
                   after: "AsyncRelocation | None" = None) -> "AsyncRelocation":
        """Split the §5.3 two-phase exchange so phase 1 — the counts
        Alltoall plus payload extraction/packing — runs on a background
        thread while the caller keeps computing (the paper's 'relocation
        overlaps the master's critical path', §4.5).

        Registered moves are snapshotted and cleared, so the caller may
        register the *next* window's moves immediately.  Call
        :meth:`AsyncRelocation.finish` to run phase 2 (delivery) and, if
        ``update_dists`` collections were given, reconcile their
        distributions via ``update_dist``.

        ``depth`` bounds the number of in-flight windows on this manager
        (double buffering): with ``depth=2`` the *previous* window's
        phase-2 delivery is enqueued on a background thread — so window
        N delivers while window N+1 runs phase-1 counts+packing — and
        only the window before that is committed (the cheap barrier).
        Windows are chained: a window's extraction never starts before
        its predecessor's extraction completed, and deliveries commit in
        FIFO order, so two live windows over the same collections stay
        deterministic.  ``after`` chains this window behind a window of
        *another* manager (the GLB pipelines its per-window managers
        this way); in-manager predecessors are chained automatically.
        """
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        moves = (tuple(self._range_moves), tuple(self._array_count_moves),
                 tuple(self._bag_moves), tuple(self._key_moves))
        self._range_moves = []
        self._array_count_moves = []
        self._bag_moves = []
        self._key_moves = []
        self._inflight = [h for h in self._inflight if not h.finished]
        prev = after if after is not None else (
            self._inflight[-1] if self._inflight else None)
        handle = AsyncRelocation(self, moves, tuple(update_dists),
                                 after=prev)
        self._inflight.append(handle)
        if telemetry.enabled():
            telemetry.observe(
                "reloc.queue_depth",
                len([h for h in self._inflight if not h.finished]))
        if prev is not None and not prev.finished:
            # start the predecessor's delivery: it overlaps this
            # window's phase 1 (and the caller's compute)
            prev.enqueue()
        while len([h for h in self._inflight if not h.finished]) > depth:
            # detach before the barrier (like GLB.finish): an error in the
            # oldest window propagates here without wedging the pipeline
            self._inflight.pop(0).finish()
        return handle

    def drain(self) -> None:
        """Commit every in-flight window of this manager, FIFO."""
        while self._inflight:
            self._inflight.pop(0).finish()

    def abort_inflight(self) -> list[BaseException]:
        """Tear down every in-flight window after a peer failure.

        Each window's ``finish()`` barrier is driven to completion —
        rolled-back windows re-raise their failure here — and the
        errors are *collected* rather than propagated, so recovery can
        quiesce the manager without losing the first error it already
        holds.  Phase-1 and delivery rollbacks have re-inserted every
        extracted payload at its source by the time this returns."""
        errors: list[BaseException] = []
        while self._inflight:
            try:
                self._inflight.pop(0).finish()
            except BaseException as e:
                errors.append(e)
        self._range_moves = []
        self._array_count_moves = []
        self._bag_moves = []
        self._key_moves = []
        return errors

    def _phase1(self, moves) -> tuple[np.ndarray, list]:
        """Counts Alltoall + payload packing (runs off-thread under
        :meth:`sync_async`).  Extraction happens here: entries leave the
        source handles as soon as phase 1 runs, exactly like the eager
        serialization of the paper's implementation.

        The counts matrix only records bytes that cross places: a move
        whose destination equals its source never reaches the wire, and
        ``_deliver_payloads`` excludes it from ``last_payload_bytes`` — keeping
        the diagonal zero is what makes the two §5.3 accounting surfaces
        agree (``last_counts_matrix.sum() == last_payload_bytes``)."""
        payloads: list[tuple[Any, int, int, Any]] = []  # (col, src, dest, payload)
        try:
            return self._phase1_extract(moves, payloads)
        except BaseException:
            # a failed window must not destroy what it already pulled
            # out of the source handles: re-insert every extracted
            # payload at its *source* before the error surfaces at the
            # finish() barrier — global_size() is conserved
            self._rollback_payloads(payloads)
            raise

    @staticmethod
    def _rollback_payloads(payloads: list) -> None:
        for col, src, _dest, payload in reversed(payloads):
            with col._lock:
                col._insert_payload(src, payload)

    def _phase1_extract(self, moves, payloads) -> tuple[np.ndarray, list]:
        range_moves, array_count_moves, bag_moves, key_moves = moves
        group = self.group
        n = group.size()
        place_index = {p: i for i, p in enumerate(group.members)}
        counts = np.zeros((n, n), dtype=np.int64)
        local_places = group.local_places()

        # Range moves: extract the locally-held pieces, splitting the
        # registered range per holder (a range may span several places'
        # chunks).  In-process the pieces must tile the whole range; on
        # a process-backed group each rank covers what it holds and the
        # claims exchange below validates global coverage.
        claims: list[int] = []
        for m in range_moves:
            with m.collection._lock:
                spans: list[tuple[int, LongRange]] = []
                for p in local_places:
                    h = m.collection.handle(p)
                    prev = None
                    for inter in h.intersections(m.r):
                        if prev is not None and prev.end == inter.start:
                            spans[-1] = (p, LongRange(spans[-1][1].start,
                                                      inter.end))
                            prev = spans[-1][1]
                        else:
                            spans.append((p, inter))
                            prev = inter
                spans.sort(key=lambda t: t[1].start)
                covered = sum(s.size for _, s in spans)
                if not group.process_backed:
                    if covered == 0:
                        raise KeyError(
                            f"range {m.r} not held by any place in group")
                    if covered != m.r.size \
                            or spans[0][1].start != m.r.start:
                        raise KeyError(
                            f"range {m.r} only partially held: "
                            f"{covered}/{m.r.size} entries present")
                claims.append(covered)
                for p, span in spans:
                    rows = m.collection._extract_range(span, p)
                    payload = (span, rows)
                    payloads.append((m.collection, p, m.dest, payload))
                    if p != m.dest:
                        nb = m.collection._payload_nbytes(payload)
                        counts[place_index[p], place_index[m.dest]] += nb

        for m in array_count_moves:
            if not group.is_local(m.src):
                continue   # the owning rank extracts (SPMD registration)
            remaining = m.count
            with m.collection._lock:
                for r in list(m.collection.ranges(m.src)):
                    if remaining <= 0:
                        break
                    take = min(remaining, r.size)
                    rr = LongRange(r.start, r.start + take)
                    rows = m.collection._extract_range(rr, m.src)
                    payload = (rr, rows)
                    if m.src != m.dest:
                        nb = m.collection._payload_nbytes(payload)
                        counts[place_index[m.src], place_index[m.dest]] += nb
                    payloads.append((m.collection, m.src, m.dest, payload))
                    remaining -= take
            if remaining > 0:
                raise ValueError(
                    f"place {m.src} holds fewer than {m.count} entries")

        for m in bag_moves:
            if not group.is_local(m.src):
                continue
            with m.collection._lock:
                payload = m.collection._extract_count(m.src, m.count)
            if m.src != m.dest:
                nb = m.collection._payload_nbytes(payload)
                counts[place_index[m.src], place_index[m.dest]] += nb
            payloads.append((m.collection, m.src, m.dest, payload))

        for m in key_moves:
            if not group.is_local(m.src):
                continue
            by_dest: dict[int, list] = {}
            for k in m.collection.keys(m.src):
                d = m.rule(k)
                if d not in self.group:
                    raise KeyError(f"rule sent key {k!r} to non-member {d}")
                if d != m.src:
                    by_dest.setdefault(d, []).append(k)
            for d, keys in by_dest.items():
                with m.collection._lock:
                    payload = m.collection._extract_keys(m.src, keys)
                nb = m.collection._payload_nbytes(payload)
                counts[place_index[m.src], place_index[d]] += nb
                payloads.append((m.collection, m.src, d, payload))

        # process-backed groups: the counts Alltoall really crosses
        # processes (allreduce-sum of the per-rank matrices), and range
        # coverage is validated globally — extraction already happened,
        # so a coverage failure rolls back via the caller
        counts = group.exchange_counts(counts)
        if group.process_backed and range_moves:
            totals = group.exchange_range_claims(claims)
            for m, got in zip(range_moves, totals):
                if got != m.r.size:
                    raise KeyError(
                        f"range {m.r} only partially held: {got}/"
                        f"{m.r.size} entries present across all ranks")
        return counts, payloads

    def _deliver_payloads(self, payloads: list,
                          counts: np.ndarray | None = None
                          ) -> tuple[int, TransportStats]:
        """Phase 2a: run the transport's Alltoallv and insert the
        delivered payloads at their destinations (may run on a window's
        background delivery thread — insertion takes each collection's
        lock so it never races a successor window's extraction).
        Returns the off-place payload bytes + the window's wire stats."""
        try:
            delivered, tstats = self.transport.exchange(self.group, counts,
                                                        payloads)
        except BaseException:
            # the exchange failed before any insertion happened (a peer
            # died mid-Alltoallv, a codec blew up): re-home every
            # extracted payload at its source so global_size() is
            # conserved across the failed window — the delivery-stage
            # twin of the _phase1 rollback
            self._rollback_payloads(payloads)
            raise
        moved_bytes = 0
        for col, src, dest, payload in delivered:
            # one accounting walk per payload: the alias-aware dedup
            # tree-flattens every value, too costly to run twice on the
            # background delivery thread
            nb = col._payload_nbytes(payload) if src != dest else 0
            moved_bytes += nb
            with col._lock:
                col._insert_payload(dest, payload)
            col.comm.record(nb)
        return moved_bytes, tstats

    def _commit(self, counts: np.ndarray, moved_bytes: int,
                tstats: TransportStats | None = None) -> None:
        """Phase 2b: publish the window's accounting (FIFO with respect
        to delivery — runs at the commit barrier on the caller thread)."""
        self.last_counts_matrix = counts
        self.last_payload_bytes = moved_bytes
        self.last_transport_stats = tstats
        self.syncs += 1



# process-wide window ordinal: every span/event a window emits carries
# ``window=<id>`` (via the tracer's thread-local context), so a Perfetto
# timeline correlates a reloc.window span with its phase1/deliver/
# transport.exchange children even across the three threads involved
_WINDOW_IDS = itertools.count()


class AsyncRelocation:
    """An in-flight teamed relocation started by
    :meth:`CollectiveMoveManager.sync_async`.

    Phase 1 (counts Alltoall + payload packing) runs on a daemon thread.
    Phase 2 is split in two so windows can double-buffer:

    * :meth:`enqueue` starts *delivery* — payload insertion plus the
      ``update_dists`` reconciliation — on a background thread (after
      phase 1, and after the predecessor window's delivery when chained
      via ``after=``);
    * :meth:`finish` is the *commit* barrier: it joins delivery and
      publishes the window's accounting on the manager.  When
      :meth:`enqueue` was never called, :meth:`finish` runs both halves
      — the original synchronous-barrier semantics.

    ``trace`` holds host-side timestamps so benchmarks can verify the
    overlap: ``t_counts_ready`` (phase 1 done), ``t_enqueue`` (delivery
    requested), ``t_delivered`` (payloads landed + distributions
    reconciled), ``t_finish_enter`` (commit barrier reached).
    """

    def __init__(self, manager: CollectiveMoveManager, moves,
                 update_dists: tuple, *,
                 after: "AsyncRelocation | None" = None):
        self.manager = manager
        self._update_dists = update_dists
        self._after = after
        self._counts: np.ndarray | None = None
        self._payloads: list | None = None
        self._moved_bytes = 0
        self.transport_stats: TransportStats | None = None
        self._exc: BaseException | None = None
        self._counts_ready = threading.Event()
        self._delivered = threading.Event()
        self._enqueue_lock = threading.Lock()
        self._phase2_claimed = False
        self._delivery_thread: threading.Thread | None = None
        self.finished = False
        self.window_id = next(_WINDOW_IDS)
        # host-side overlap stamps; the structured telemetry spans
        # (reloc.phase1 / reloc.deliver / reloc.commit / reloc.window,
        # all tagged window=<id>) supersede these for timeline analysis,
        # but `overlapped` and the benchmarks keep reading them
        self.trace: dict[str, float] = {"t_submit": time.perf_counter()}
        if telemetry.enabled():
            # announce the window *before* phase 1 can run: the
            # sanitizer's race detector opens its danger zone for the
            # participating collections here, on the submitting thread,
            # so a mutation racing even the first instants of
            # extraction is already covered
            gids = sorted({m.collection.global_id
                           for group in moves for m in group})
            telemetry.event("reloc.submit", window=self.window_id,
                            gids=tuple(gids))
        self._thread = threading.Thread(
            target=self._run_phase1, args=(moves,), daemon=True)
        self._thread.start()

    def _run_phase1(self, moves) -> None:
        try:
            # chained windows extract strictly after the predecessor
            # *delivered*: key-rule moves enumerate the source's keys at
            # extraction time, so entries still in the predecessor's
            # flight must have landed first or the move would silently
            # miss them (extraction ordering alone is not enough) — the
            # idle wait stays outside the span so reloc.phase1 times
            # only the counts exchange + extraction/packing
            if self._after is not None:
                self._after._delivered.wait()
            with telemetry.context(window=self.window_id), \
                    telemetry.span("reloc.phase1") as sp:
                self._counts, self._payloads = self.manager._phase1(moves)
                if sp:
                    sp.set(payloads=len(self._payloads),
                           counts_bytes=int(self._counts.sum()))
        except BaseException as e:  # re-raised at the finish() barrier
            self._exc = e
        finally:
            self.trace["t_counts_ready"] = time.perf_counter()
            self._counts_ready.set()

    # -- phase-1 observers -------------------------------------------------
    def counts_ready(self) -> bool:
        """True once the counts exchange completed (non-blocking)."""
        return self._counts_ready.is_set()

    def wait_counts(self, timeout: float | None = None) -> np.ndarray | None:
        """Block until the place×place byte-count matrix is available —
        the phase-1 Alltoall result, usable for flow control before the
        payload exchange lands.  Returns ``None`` when ``timeout``
        expires first (the window stays in flight and a later
        :meth:`wait_counts` or :meth:`finish` still succeeds)."""
        self._counts_ready.wait(timeout)
        if self._exc is not None:
            raise self._exc
        return self._counts

    @property
    def overlapped(self) -> bool:
        """Did this window's relocation work overlap the caller's
        compute?  For a plain barrier window: phase 1 completed before
        the caller reached :meth:`finish`.  For a double-buffered window
        (delivery enqueued before the commit barrier): delivery also
        completed before the commit was requested — i.e. the commit was
        free.  Accounted per window, so overlapping handles each report
        their own overlap.  A failed window (phase-1 raise + rollback)
        is never overlapped — it did no useful work off the critical
        path, and stats that skip it entirely would overstate the
        pipeline (see ``GLBStats.overlap_fraction``)."""
        t_fin = self.trace.get("t_finish_enter")
        if t_fin is None or "t_counts_ready" not in self.trace \
                or self._exc is not None:
            return False
        if self.trace.get("t_enqueue", t_fin) < t_fin \
                and "t_delivered" in self.trace:
            return self.trace["t_delivered"] <= t_fin
        return self.trace["t_counts_ready"] <= t_fin

    # -- phase 2a: delivery ------------------------------------------------
    def enqueue(self) -> "AsyncRelocation":
        """Start phase-2 delivery on a background thread (idempotent).
        Delivery waits for this window's phase 1 and for the predecessor
        window's delivery (FIFO), inserts the payloads, and reconciles
        the ``update_dists`` distributions — all off the caller's
        critical path.  :meth:`finish` remains the commit barrier."""
        with self._enqueue_lock:
            if self.finished or self._phase2_claimed:
                return self
            self._phase2_claimed = True
            self.trace["t_enqueue"] = time.perf_counter()
            if telemetry.enabled():
                telemetry.event("reloc.enqueue", window=self.window_id)
            self._delivery_thread = threading.Thread(
                target=self._run_phase2, daemon=True)
            self._delivery_thread.start()
        return self

    def _run_phase2(self) -> None:
        """Delivery body, shared by the background thread and the
        synchronous :meth:`finish` path (which runs it inline on the
        caller thread — no thread spawn for plain barrier windows)."""
        try:
            self._thread.join()
            if self._exc is not None:
                return
            if self._after is not None:
                self._after._delivered.wait()
            # the transport.exchange span opens on this same thread, so
            # it nests inside reloc.deliver and inherits the window tag
            with telemetry.context(window=self.window_id), \
                    telemetry.span("reloc.deliver") as sp:
                if self.manager.sanitize:
                    # before the transport consumes them: a broken codec
                    # should fail the window, not corrupt the landing
                    _san.check_codec_roundtrip(self._payloads,
                                               self.window_id)
                self._moved_bytes, self.transport_stats = \
                    self.manager._deliver_payloads(self._payloads,
                                                   self._counts)
                if self.manager.sanitize:
                    _san.check_commit_invariants(
                        self.manager, self._counts, self._moved_bytes,
                        self.window_id)
                for col in self._update_dists:
                    col.update_dist()
                if sp:
                    sp.set(moved_bytes=self._moved_bytes)
        except BaseException as e:  # re-raised at the finish() barrier
            self._exc = e
        finally:
            # the chain link is only needed for the ordering waits above;
            # dropping it here keeps a long-running pipeline from pinning
            # every predecessor handle (and its payload refs) forever
            self._after = None
            self.trace["t_delivered"] = time.perf_counter()
            self._delivered.set()

    def wait_delivered(self, timeout: float | None = None) -> bool:
        """Block until this window's background delivery — payload
        insertion plus distribution reconciliation — completed
        (enqueueing it if needed).  Chained predecessors deliver first
        (FIFO), so a True return means every window up to this one has
        landed and ``loads``-style reads are fully consistent; only the
        cheap accounting commit (:meth:`finish`) remains.  Returns False
        when ``timeout`` expires first."""
        self.enqueue()
        done = self._delivered.wait(timeout)
        if self._exc is not None:
            raise self._exc
        return done

    # -- the barrier -------------------------------------------------------
    def finish(self) -> "AsyncRelocation":
        """Commit barrier: join phase 1 + delivery, publish the window's
        accounting on the manager.  Synchronous path (no prior
        :meth:`enqueue`): delivery runs inline on this thread — exactly
        the original barrier semantics, with no thread spawn."""
        if self.finished:
            return self
        self.trace["t_finish_enter"] = time.perf_counter()
        with telemetry.span("reloc.commit", window=self.window_id):
            with self._enqueue_lock:
                claimed = not self._phase2_claimed
                if claimed:
                    self._phase2_claimed = True
            if claimed:
                self._run_phase2()
            else:
                self._delivered.wait()
            if self._exc is not None:
                raise self._exc
            self.manager._commit(self._counts, self._moved_bytes,
                                 self.transport_stats)
        self._payloads = None   # a chained successor must not pin them
        self.trace["t_done"] = time.perf_counter()
        self.finished = True
        if telemetry.enabled():
            # the whole window as one span, submit → done: it ran on
            # three threads, so it is assembled from the trace stamps
            # rather than a single context manager
            now = telemetry.now_us()
            dur_us = (self.trace["t_done"]
                      - self.trace["t_submit"]) * 1e6
            telemetry.complete("reloc.window", now - dur_us, now,
                               window=self.window_id,
                               overlapped=self.overlapped,
                               moved_bytes=self._moved_bytes)
            telemetry.observe("reloc.window_s", dur_us / 1e6)
            telemetry.observe("reloc.window_bytes", self._moved_bytes)
        return self


# ---------------------------------------------------------------------------
# SPMD half — relocation as tensor code over an explicit place dimension
#
# The JAX package writes these per shard under ``vmap``/``shard_map``
# with a named axis; here every argument carries a leading place
# dimension ``P`` and the ``all_to_all`` over it is a transpose of the
# first two dimensions (one card holds every place).
# ---------------------------------------------------------------------------
def spmd_counts(dest: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Per-destination row counts (phase-1 Alltoall payload): ``dest``
    ``(..., n)`` → ``(..., n_shards)`` int32.  Destinations outside
    ``[0, n_shards)`` count nowhere."""
    shards = torch.arange(n_shards, device=dest.device)
    return (dest.unsqueeze(-1) == shards).sum(-2).to(torch.int32)


def _pack_by_dest(x: torch.Tensor, dest: torch.Tensor, n_shards: int,
                  capacity: int):
    """Pack each shard's rows into a (P, n_shards, capacity, ...) send
    buffer.

    ``x``: (P, n, ...) rows, ``dest``: (P, n) destinations.  Returns
    (buffer, valid, slot) where ``slot[p, i]`` is the flat position row
    i of shard p was packed into (or -1 if dropped by capacity
    overflow) — kept so the inverse routing can restore order.  Rows
    that do not fit, or whose destination lies outside the group, land
    in a dump slot past the end, which is cut off.
    """
    P, n = dest.shape
    dev = dest.device
    dest = dest.to(torch.int64)
    flat = n_shards * capacity
    sort_idx = torch.argsort(dest, dim=1, stable=True)
    sorted_dest = dest.gather(1, sort_idx)
    counts = spmd_counts(dest, n_shards).to(torch.int64)
    offsets = counts.cumsum(1) - counts
    # out-of-range destinations read the last group's offset, as the
    # JAX gather clamps; their slots fall past the buffer either way
    pos_sorted = torch.arange(n, device=dev) \
        - offsets.gather(1, sorted_dest.clamp(0, n_shards - 1))
    rank = torch.zeros((P, n), dtype=torch.int64, device=dev) \
        .scatter_(1, sort_idx, pos_sorted)
    keep = rank < capacity
    slot = torch.where(keep, dest * capacity + rank,
                       torch.full_like(rank, flat))
    put = torch.where((slot >= 0) & (slot < flat), slot,
                      torch.full_like(slot, flat))
    rows = torch.arange(P, device=dev)[:, None].expand(P, n)
    buf = x.new_zeros((P, flat + 1) + tuple(x.shape[2:]))
    buf[rows, put] = x
    valid = torch.zeros((P, flat + 1), dtype=torch.bool, device=dev)
    valid[rows, put] = keep
    buf = buf[:, :-1].reshape((P, n_shards, capacity) + tuple(x.shape[2:]))
    valid = valid[:, :-1].reshape(P, n_shards, capacity)
    slot = torch.where(keep, slot, torch.full_like(slot, -1))
    return buf, valid, slot


def _all_to_all(buf: torch.Tensor) -> torch.Tensor:
    """The place-dimension ``all_to_all`` on one card: block ``[s, d]``
    of the send buffer lands at ``[d, s]`` of the receive buffer."""
    return buf.transpose(0, 1)


def spmd_relocate(x: torch.Tensor, dest: torch.Tensor, *, capacity: int,
                  extras: tuple = ()):
    """Teamed relocation of rows over the place dimension (the
    device-side ``CollectiveMoveManager.sync``).

    Args:
      x: (P, n, ...) rows of every shard.
      dest: (P, n) destination shard of each row.
      capacity: max rows any shard pair exchanges (overflow rows are
        dropped and flagged).
      extras: additional (P, n, ...) tensors relocated with the same
        routing.

    Returns dict with:
      recv: (P, P*capacity, ...) received rows (zeros where invalid)
      recv_valid: mask of real rows
      recv_src: source shard of each received row
      slot: (P, n) flat slot each local row was packed into (-1 = dropped)
      recv_extras: relocated extras
    """
    P = x.shape[0]
    flat = P * capacity
    buf, valid, slot = _pack_by_dest(x, dest, P, capacity)
    recv = _all_to_all(buf)
    recv_valid = _all_to_all(valid)
    recv_extras = []
    rows = torch.arange(P, device=x.device)[:, None].expand_as(slot)
    put = torch.where((slot >= 0) & (slot < flat), slot,
                      torch.full_like(slot, flat))
    for e in extras:
        ebuf = e.new_zeros((P, flat + 1) + tuple(e.shape[2:]))
        ebuf[rows, put] = e
        ebuf = ebuf[:, :-1].reshape((P, P, capacity) + tuple(e.shape[2:]))
        recv_extras.append(_all_to_all(ebuf).reshape(
            (P, flat) + tuple(e.shape[2:])))
    src = torch.arange(P, dtype=torch.int32, device=x.device)[:, None] \
        .expand(P, capacity).reshape(flat)
    return {
        "recv": recv.reshape((P, flat) + tuple(x.shape[2:])),
        "recv_valid": recv_valid.reshape(P, flat),
        "recv_src": src.expand(P, flat),
        "slot": slot,
        "recv_extras": tuple(recv_extras),
    }


def spmd_relocate_back(y: torch.Tensor, slot: torch.Tensor, *,
                       capacity: int, fill=0.0) -> torch.Tensor:
    """Inverse relocation: route processed rows back to their source
    shard and original order.  ``y`` is (P, P*capacity, ...) in the
    layout produced by :func:`spmd_relocate`; ``slot`` is the slot map
    it returned."""
    P = y.shape[0]
    flat = P * capacity
    buf = y.reshape((P, P, capacity) + tuple(y.shape[2:]))
    back = _all_to_all(buf).reshape((P, flat) + tuple(y.shape[2:]))
    safe = torch.where(slot >= 0, slot, torch.zeros_like(slot)) \
        .clamp(0, flat - 1)
    rows = torch.arange(P, device=y.device)[:, None].expand_as(slot)
    out = back[rows, safe]
    mask = (slot >= 0).reshape(tuple(slot.shape) + (1,) * (out.dim() - 2))
    return torch.where(mask, out, torch.full_like(out, fill))
