"""Front-end request router over the live sequence distribution (the
port of ``repro.serving.router``; the dispatch table's device mirror is
a tensor on the group's device).

The paper's §4.4/§4.6 dispatch pattern applied to serving: follow-up
decode requests for a sequence are routed by the *tracked distribution*
of the sequence ``DistIdMap``, which ``update_dist`` reconciles after
every migration window — so the router keeps dispatching correctly
while the GLB moves KV shards underneath it.

Router at scale: per-request Python routing (``dispatch``) doesn't
survive a hot path.  ``refresh()`` therefore also rebuilds a *dispatch
table* — a dense owner array indexed by sequence id, computed through
the distribution's ``lookup_host`` (a ``searchsorted`` over the range
starts, §4.6) and masked by residency and liveness — and
``dispatch_batch`` routes whole request vectors with one table take plus
a stable grouping sort.  The table refreshes once per migration window
(the elastic driver wires it to the GLB's window barrier), so the data
plane reads a consistent snapshot while the relocation engine works
underneath it.

Failure handling: :meth:`Router.mark_dead` drains the dead replica's
request queue back into a retry buffer; once the eviction path re-homes
the sequences (``rehome_dead_place``) and :meth:`Router.refresh` picks
up the new distribution, the drained requests re-dispatch to the
surviving owners.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import DistIdMap

__all__ = ["Router"]


class Router:
    """Admission/dispatch front end for a replicated serving pool."""

    def __init__(self, seqs: DistIdMap, *, max_retries: int = 8):
        self.seqs = seqs
        self._dist = seqs.get_distribution()
        self.dead: set[int] = set()
        self.queues: dict[int, list] = {p: [] for p in seqs.group.members}
        self.max_retries = max_retries
        self.routed = 0
        self.rerouted = 0
        self.dropped = 0
        self.batches = 0
        self.retries: list[tuple[int, object, int]] = []  # (sid, payload, n)
        self._table = np.zeros(0, np.int32)      # owner of sid (base+i), -1 = none
        self._base = 0                           # lowest sid the table covers
        self._table_dev = None                   # device mirror (lazy)
        self._rebuild_table()

    # -- distribution consistency ----------------------------------------
    def refresh(self) -> None:
        """Re-snapshot the tracked distribution and rebuild the dispatch
        table (call after a migration window reconciles via
        ``update_dist`` — the elastic driver does this once per window),
        then re-drive any requests that were parked while their sequence
        had no live owner."""
        self._dist = self.seqs.get_distribution()
        for p in self.seqs.group.members:
            self.queues.setdefault(p, [])
        self._rebuild_table()
        retries, self.retries = self.retries, []
        for sid, payload, attempts in retries:
            self.dispatch(sid, payload, _attempts=attempts + 1)

    def _rebuild_table(self) -> None:
        """Dense owner array over the live sid window ``[base, end)`` —
        the distribution's host-side ``lookup_host`` (same searchsorted
        semantics as the device ``lookup``), masked to -1 where the
        owner is dead/evicted or the sequence is not resident (mid-
        migration or retired — the same answer :meth:`owner` gives).
        Anchoring at the lowest tracked sid keeps the table bounded by
        the live window, not by every sid ever admitted; built in numpy
        because the length changes every refresh, with
        :meth:`device_table` as the device mirror."""
        starts, ends, _ = self._dist.as_arrays()
        if len(starts) == 0:
            self._table = np.zeros(0, np.int32)
            self._base = 0
            self._table_dev = None
            return
        base, n = int(starts[0]), int(ends[-1])
        owners = self._dist.lookup_host(np.arange(base, n, dtype=np.int64))
        alive = [p for p in self.seqs.group.members if p not in self.dead]
        ok = np.isin(owners, np.asarray(alive, np.int32))
        resident = np.zeros(n - base, bool)
        for p in alive:
            # snapshot the handle: an async window's background thread
            # may pop keys from the live dict while we scan
            ks = np.asarray([k - base for k in list(self.seqs.handle(p))
                             if base <= k < n], np.int64)
            if len(ks):
                resident[ks] = owners[ks] == p
        self._table = np.where(ok & resident, owners, -1).astype(np.int32)
        self._base = base
        self._table_dev = None   # re-mirrored lazily on device use

    @property
    def table(self) -> np.ndarray:
        """The current dispatch table (-1 = unroutable); entry ``i``
        routes sid ``base + i``."""
        return self._table

    @property
    def base(self) -> int:
        """Lowest sid the dispatch table covers (retired prefixes are
        compacted away on refresh)."""
        return self._base

    def device_table(self) -> torch.Tensor:
        """Mirror of the dispatch table on the group's device (owner =
        table[sid - base] inside device code); re-uploaded only after a
        refresh changed it."""
        if self._table_dev is None:
            self._table_dev = torch.from_numpy(self._table).to(
                self.seqs.group.device)
        return self._table_dev

    def owner(self, sid: int) -> int | None:
        """Current owner of ``sid`` per the routing table; None when the
        sequence is unknown, retired, or stranded on a dead replica."""
        try:
            o = self._dist.owner_of(int(sid))
        except KeyError:
            return None
        if o in self.dead or o not in self.seqs.group:
            return None
        if int(sid) not in self.seqs.handle(o):
            return None   # retired, or mid-migration (table lags one sync)
        return o

    # -- dispatch ---------------------------------------------------------
    def dispatch(self, sid: int, payload=None, *,
                 _attempts: int = 0) -> int | None:
        """Route a decode request to its sequence's replica.  Requests
        with no live owner (mid-migration or mid-eviction) park in the
        retry buffer and re-route on the next :meth:`refresh`; after
        ``max_retries`` refreshes without a live owner (sequence retired
        or never existed) the request is dropped, not re-parked."""
        o = self.owner(sid)
        if o is None:
            if _attempts >= self.max_retries:
                self.dropped += 1
            else:
                self.retries.append((sid, payload, _attempts))
            return None
        self.queues[o].append((sid, payload))
        self.routed += 1
        return o

    def dispatch_batch(self, sids, payloads=None) -> np.ndarray:
        """Vectorized dispatch against the per-window table: one take
        over the owner array replaces per-request Python routing on the
        hot path.  Returns the owner per request (-1 = parked in the
        retry buffer, as the scalar path would).  Queue order within a
        replica matches arrival order.  The table is a per-window
        snapshot: a request routed to a replica its sequence just
        migrated away from bounces back to the retry buffer at
        :meth:`drain` time."""
        sids = np.asarray(sids, np.int64)
        if payloads is None:
            payloads = [None] * len(sids)
        if len(payloads) != len(sids):
            raise ValueError("payloads length must match sids")
        table, base = self._table, self._base
        off = sids - base
        in_range = (off >= 0) & (off < len(table))
        owners = np.where(
            in_range,
            table[np.clip(off, 0, max(len(table) - 1, 0))]
            if len(table) else -1,
            -1).astype(np.int32)
        for j, o in enumerate(owners.tolist()):
            if o < 0:
                self.retries.append((int(sids[j]), payloads[j], 0))
            else:
                self.queues[o].append((int(sids[j]), payloads[j]))
        n_routed = int((owners >= 0).sum())
        self.routed += n_routed
        self.batches += 1
        return owners

    def drain(self, place: int) -> list:
        """Take the pending requests queued at ``place`` (a replica's
        per-step batch pull).  Requests whose sequence is no longer
        resident — retired, or extracted into a migration window after
        they were queued — bounce to the retry buffer instead of being
        handed to a replica that cannot serve them (the replica noticing
        it doesn't own the sequence and sending it back)."""
        q = self.queues.get(place, [])
        self.queues[place] = []
        if not q:
            return q
        h = self.seqs.handle(place) if place in self.seqs.group else {}
        out = []
        for sid, payload in q:
            if sid in h:
                out.append((sid, payload))
            else:
                self.retries.append((sid, payload, 0))
                self.rerouted += 1
        return out

    # -- failure ----------------------------------------------------------
    def mark_dead(self, place: int) -> None:
        """Stop routing to ``place``; its queued requests move to the
        retry buffer until the eviction re-homes their sequences.  The
        dispatch table masks the dead replica immediately."""
        self.dead.add(place)
        stranded = self.queues.pop(place, [])
        self.retries.extend((sid, payload, 0) for sid, payload in stranded)
        self.rerouted += len(stranded)
        if len(self._table):
            self._table = np.where(self._table == place, -1, self._table)
            self._table_dev = None
