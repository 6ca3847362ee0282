"""Deterministic synthetic token pipeline backed by a DistArray.

The port of ``repro.data.pipeline``.  The batch rows of the training
stream are entries of a tracked :class:`~repro_torch.core.DistArray`
(paper: agents of PlhamJ) on the group's device: the straggler balancer
relocates row ranges between data shards and ``update_dist`` keeps the
ownership table consistent; the training loop reads whatever its local
handle holds.

:class:`TokenSource` stays numpy, so every (seed, epoch, row) gives the
reference's token bits; :meth:`ShardedBatches.local_batch` hands back
numpy and the train step moves it to the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import (CollectiveMoveManager, DistArray, LongRange, PlaceGroup,
                    RangeDistribution)

__all__ = ["TokenSource", "ShardedBatches", "make_global_batch"]


@dataclass
class TokenSource:
    vocab_size: int
    seq_len: int
    seed: int = 0

    def row(self, epoch: int, idx: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        # Zipf-flavored marginal over the vocab, mixed with short repeats
        z = rng.zipf(1.3, size=self.seq_len).astype(np.int64)
        tok = (z + rng.integers(0, 97, self.seq_len)) % self.vocab_size
        rep = rng.integers(0, self.seq_len, self.seq_len // 8)
        tok[rep] = tok[(rep - 3) % self.seq_len]
        return tok.astype(np.int32)


def _with_labels(rows: np.ndarray) -> dict:
    labels = np.concatenate([rows[:, 1:], rows[:, :1]], axis=1)
    return {"tokens": rows, "labels": labels}


def make_global_batch(src: TokenSource, epoch: int, start_row: int,
                      batch: int):
    return _with_labels(np.stack([src.row(epoch, start_row + i)
                                  for i in range(batch)]))


class ShardedBatches:
    """Per-place batch-row assignment as a relocatable collection.

    Each data shard owns a range of the global batch's row indices; the
    balancer can relocate ranges (straggler mitigation), after which
    ``local_batch(place)`` reflects the new ownership.
    """

    def __init__(self, group: PlaceGroup, global_batch: int,
                 src: TokenSource):
        self.group = group
        self.global_batch = global_batch
        self.src = src
        self.assign = DistArray(group, track=True)
        for p, r in enumerate(LongRange(0, global_batch).split(group.size())):
            if r.size:
                # entries are just the row ids (relocatable payload)
                self.assign.add_chunk(p, r,
                                      np.arange(r.start, r.end)[:, None])
        self.epoch = 0
        self.cursor = 0

    def distribution(self) -> RangeDistribution:
        return self.assign.get_distribution()

    def loads(self) -> np.ndarray:
        return self.distribution().loads(self.group.size())

    def local_batch(self, place: int) -> dict:
        rows, _ = self.assign.to_local_matrix(place)
        row_ids = rows[:, 0].cpu().numpy().astype(int) if len(rows) else []
        if not len(row_ids):
            toks = np.zeros((0, self.src.seq_len), np.int32)
            return {"tokens": toks, "labels": toks,
                    "rows": np.asarray(row_ids)}
        out = _with_labels(np.stack([
            self.src.row(self.epoch, self.cursor + int(i)) for i in row_ids]))
        out["rows"] = np.asarray(row_ids)
        return out

    def advance(self) -> None:
        self.cursor += self.global_batch
        if self.cursor >= 10_000_000:
            self.cursor = 0
            self.epoch += 1

    def apply_balance(self, decision, mm=None) -> None:
        """Relocate batch rows per a BalanceDecision + update_dist."""
        own = mm is None
        if own:
            mm = CollectiveMoveManager(self.group)
        for src_p, dest_p, count in decision.moves:
            avail = self.assign.local_size(src_p)
            n = min(count, max(avail - 1, 0))
            if n > 0:
                self.assign.move_at_sync_count(src_p, n, dest_p, mm)
        if own:
            mm.sync()
            self.assign.update_dist()
