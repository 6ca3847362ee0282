"""Traffic-keyed GLB workload for the serving tier (the port of
``repro.serving.workload``, unchanged but for its imports).

The batch GLB balances *entry counts*; a serving replica's pressure is
better described by its **request traffic** — how long its decode steps
take times how much state it keeps resident.  :class:`TrafficWorkload`
implements the GLB ``Workload`` protocol with

    load(replica) = decode-time EWMA(replica) × resident sequences,
                    each sequence weighted by its KV token budget

so the policy's move plans are denominated in *traffic units*, and the
transfer path converts them back into whole sequences via the
:class:`TokenCostModel` (KV pages per sequence).  Sequence metadata and
KV pages are two co-partitioned ``DistIdMap`` collections keyed by
sequence id; one ``sync_async`` window migrates both together (paper
Listing 12), so a sequence and its cache never separate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence as SequenceT

import numpy as np

from ..core import CollectiveMoveManager, DistIdMap
from ..core.relocation import AsyncRelocation

__all__ = ["TokenCostModel", "TrafficWorkload"]


@dataclass
class TokenCostModel:
    """Token-budget cost of a resident sequence: the number of KV pages
    its tokens occupy (vLLM-style paging; one page = ``page_tokens``
    cache slots).  Migrating a sequence costs its page count on the
    wire, so the balancer prefers shipping few hot sequences over many
    cold ones."""

    page_tokens: int = 16

    def tokens(self, seq) -> int:
        return int(seq.prompt_len) + int(seq.generated)

    def pages(self, seq) -> int:
        return max(1, -(-self.tokens(seq) // self.page_tokens))


class TrafficWorkload:
    """GLB ``Workload`` keyed by per-replica request traffic.

    ``observe(decode_times)`` feeds the per-replica decode-time EWMA;
    ``loads()`` returns EWMA-weighted resident KV-page budgets (integer
    traffic units); ``transfer`` turns planned traffic into whole
    sequences (hottest-first) and migrates ``seqs`` + ``kv`` through one
    relocation window, reconciling both distributions on finish.
    """

    def __init__(self, seqs: DistIdMap, kv: DistIdMap | None = None, *,
                 cost_model: TokenCostModel | None = None, ema: float = 0.5,
                 min_keep: int = 1, transport=None):
        self.seqs = seqs
        self.kv = kv
        # relocation data plane for the migration windows; None inherits
        # the attached balancer's GLBConfig(transport=...).  "device"
        # ships SeqKV pages through the device exchange — tensors never
        # bounce through host memory
        from ..core.transport import make_transport
        self.transport = None if transport is None \
            else make_transport(transport)
        # retirement runs concurrently with async-window extraction
        seqs.tolerate_missing_keys = True
        if kv is not None:
            kv.tolerate_missing_keys = True
        self.members = tuple(seqs.group.members)  # snapshot: GLB index space
        self.cost = cost_model or TokenCostModel()
        self.ema = ema
        self.min_keep = min_keep
        self._ewma = np.ones(len(self.members), np.float64)
        self.last_transfer_count = 0   # traffic units actually moved
        self.last_moved_seqs = 0
        self.migrated_pages = 0

    # -- traffic accounting ----------------------------------------------
    def observe(self, decode_times) -> None:
        """Fold one round of per-replica decode times (aligned to the
        initial member order; entries for dead replicas are ignored)."""
        t = np.asarray(decode_times, np.float64)
        mask = np.isfinite(t) & (t > 0)
        self._ewma[mask] = (self.ema * self._ewma[mask]
                            + (1 - self.ema) * t[mask])

    def pages_of(self, member: int) -> int:
        if member not in self.seqs.group:
            return 0
        # an async migration window may be extracting keys on its
        # background thread while we read — tolerate concurrent pops
        h = self.seqs.handle(member)
        total = 0
        for k in list(h):
            s = h.get(k)
            if s is not None:
                total += self.cost.pages(s)
        return total

    def resident(self, member: int) -> int:
        return (self.seqs.local_size(member)
                if member in self.seqs.group else 0)

    def kv_bytes_of(self, member: int) -> int:
        """Bytes of KV payload resident at ``member`` — counted without
        pulling device tensors to host (real data plane: the values are
        ``SeqKV`` pytrees of tensors)."""
        if self.kv is None or member not in self.kv.group:
            return 0
        from ..core.collections import _value_nbytes
        h = self.kv.handle(member)
        total = 0
        for k in list(h):
            v = h.get(k)
            if v is not None:
                total += _value_nbytes(v)
        return total

    def loads(self) -> np.ndarray:
        """Integer traffic units per member: EWMA × resident KV pages,
        normalized so an even cluster reports plain page budgets."""
        pages = np.asarray([self.pages_of(m) for m in self.members],
                           np.float64)
        alive = np.asarray([m in self.seqs.group for m in self.members])
        norm = self._ewma / max(float(self._ewma[alive].mean())
                                if alive.any() else 1.0, 1e-12)
        return np.round(np.where(alive, norm * pages, 0)).astype(np.int64)

    # -- the transfer path ------------------------------------------------
    def transfer(self, moves: SequenceT[tuple[int, int, int]], *,
                 asynchronous: bool = False,
                 after: AsyncRelocation | None = None
                 ) -> AsyncRelocation | None:
        group = self.seqs.group
        loads = self.loads().astype(np.float64)
        assign: dict[int, dict[int, int]] = {}   # src -> {sid: dest}
        moved_traffic = 0.0
        moved_pages = 0
        for src_i, dest_i, want in moves:
            src, dest = self.members[src_i], self.members[dest_i]
            if src not in group or dest not in group or src == dest:
                continue
            if loads[src_i] <= 0:
                continue
            taken = assign.setdefault(src, {})
            pool = [k for k in self.seqs.keys(src) if k not in taken]
            # chosen sequences extract lazily at sync, so the full
            # resident page budget still backs the planned traffic
            per_page = loads[src_i] / max(self.pages_of(src), 1)
            # hottest-first: the fewest migrations satisfy the budget
            pool.sort(key=lambda k: -self.cost.pages(self.seqs.get(src, k)))
            budget = float(want)
            for k in pool:
                if budget <= 0:
                    break
                if self.resident(src) - len(taken) <= self.min_keep:
                    break
                pg = self.cost.pages(self.seqs.get(src, k))
                taken[k] = dest
                budget -= per_page * pg
                moved_traffic += per_page * pg
                moved_pages += pg
        mm = CollectiveMoveManager(group, transport=self.transport)
        n_moved = 0
        for src, mapping in assign.items():
            if not mapping:
                continue
            n_moved += len(mapping)
            rule = (lambda k, m=mapping, s=src: m.get(k, s))
            self.seqs.move_at_sync(src, rule, mm)
            if self.kv is not None:
                self.kv.move_at_sync(src, rule, mm)
        self.last_transfer_count = int(round(moved_traffic))
        self.last_moved_seqs = n_moved
        self.migrated_pages += moved_pages
        if not mm.pending():
            return None
        update = (self.seqs,) + ((self.kv,) if self.kv is not None else ())
        handle = mm.sync_async(update_dists=update, after=after)
        if not asynchronous:
            handle.finish()
        return handle
