"""Serving-side KV/state management as relocatable collections.

The port of ``repro.serving.cache``.  Sequences in flight are entries of
a ``DistIdMap`` keyed by sequence id; their cache pages are the entry
payloads.  :class:`SeqKV` is the device-resident payload of the real
decode data plane: one sequence's batch-1 slice of the model's decode
state plus its current token, registered with ``torch.utils._pytree`` so
the relocation engine's tree codec ships its tensors as device leaves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import (CollectiveMoveManager, DistIdMap, LevelExtremes,
                    LoadBalancer, PlaceGroup)
from ..core.collections import tree_leaves, unique_leaves_nbytes

__all__ = ["ServingPool", "Sequence", "SeqKV"]


class SeqKV:
    """One sequence's decode state + current token.

    ``state`` is a batch-1 slice of the model's decode-state pytree, each
    leaf a tensor that owns its storage (never a view into a batch);
    ``token`` is the ``(1, 1)`` int32 token the next decode step
    consumes.  The decode engine rebinds these fields after every step,
    so an entry extracted into an in-flight migration window still
    carries the latest pages when it lands at its destination.
    """

    __slots__ = ("state", "token")

    def __init__(self, state, token):
        self.state = state
        self.token = token

    @property
    def nbytes(self) -> int:
        """Payload size, each distinct tensor counted once (the
        relocation engine's dedup definition), without a device→host
        transfer."""
        return unique_leaves_nbytes(tree_leaves(self), set())

    def on_device(self, device=None) -> bool:
        """True when every leaf is a tensor (on ``device`` when given):
        the entry rides relocation windows as device leaves, not as host
        arrays."""
        leaves = tree_leaves(self)
        if not all(isinstance(x, torch.Tensor) for x in leaves):
            return False
        if device is None:
            return True
        dev = torch.device(device)
        return all(x.device.type == dev.type for x in leaves)


pytree.register_pytree_node(
    SeqKV,
    lambda kv: ([kv.state, kv.token], None),
    lambda children, _: SeqKV(*children),
    serialized_type_name="repro_torch.serving.cache.SeqKV")


@dataclass
class Sequence:
    seq_id: int
    prompt_len: int
    generated: int = 0
    max_new: int = 64
    state_ref: Optional[object] = None

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new


class ServingPool:
    """Continuous-batching pool across replicas with relocation."""

    def __init__(self, group: PlaceGroup, *, slots_per_replica: int,
                 lb_period: int = 8):
        self.group = group
        self.slots = slots_per_replica
        self.seqs = DistIdMap(group)
        self.balancer = LoadBalancer(group.size(),
                                     strategy=LevelExtremes(), period=lb_period)
        self.next_id = 0
        self.completed: list[int] = []
        self.relocations = 0

    # -- admission ------------------------------------------------------
    def admit(self, prompt_len: int, max_new: int = 64) -> int | None:
        """Place a new sequence on the least-loaded replica alive in the
        current place group."""
        members = list(self.group.members)
        loads = [self.seqs.local_size(p) for p in members]
        i = int(np.argmin(loads))
        if loads[i] >= self.slots:
            return None
        p = members[i]
        sid = self.next_id
        self.next_id += 1
        self.seqs.put(p, sid, Sequence(sid, prompt_len, max_new=max_new))
        return sid

    def evict(self, dead: int) -> None:
        """Drop a dead replica: re-home its sequences on the survivors
        through the relocation engine and shrink the place group."""
        from ..runtime.fault_tolerance import ElasticWorld
        self.group = ElasticWorld(self.group).evict(dead, (self.seqs,))
        self.balancer = LoadBalancer(self.group.size(),
                                     strategy=self.balancer.strategy,
                                     period=self.balancer.period)

    def replica_of(self, sid: int) -> int:
        return self.seqs.get_distribution().owner_of(sid)

    def loads(self) -> np.ndarray:
        return np.array([self.seqs.local_size(p) for p in self.group.members])

    # -- decode round ---------------------------------------------------
    def step(self, decode_times: np.ndarray) -> None:
        """One decode round: advance every live sequence, retire finished
        ones, and (periodically) rebalance using measured replica times."""
        for p in self.group.members:
            for sid in list(self.seqs.keys(p)):
                s = self.seqs.get(p, sid)
                s.generated += 1
                if s.done:
                    h = self.seqs.handle(p)
                    del h[sid]
                    self.completed.append(sid)
        self.balancer.record_all(decode_times)
        decision = self.balancer.step(self.loads())
        if decision and decision.moves:
            members = list(self.group.members)
            mm = CollectiveMoveManager(self.group)
            for src_i, dest_i, count in decision.moves:
                src, dest = members[src_i], members[dest_i]
                sids = self.seqs.keys(src)[:count]
                moved = set(sids)
                if moved:
                    # bind per-move: rules evaluate lazily at sync
                    self.seqs.move_at_sync(
                        src, lambda k, m=moved, d=dest, s=src:
                        d if k in m else s, mm)
            mm.sync()
            self.relocations += mm.last_payload_bytes
            self.seqs.update_dist()

    def live(self) -> int:
        return self.seqs.global_size()
