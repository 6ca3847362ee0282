"""Accumulators (paper §4.11) — contention-free parallel contributions,
in PyTorch.

The paper's accumulator hands each thread a private shadow buffer
indexed like the target collection; after the parallel phase, the shadow
buffers are *accepted* (reduced) into the collection.  This removes
write contention when multiple workers contribute to the same entry
(MolDyn: both particles of a pair receive force).

On the card "threads" are parallel grains (tiles / lanes): each grain's
buffer is a tensor on the accumulator's device, and :meth:`totals` sums
the grains in a fixed order, so two calls give the same bits.
:func:`segment_accept` is the tensor-side accept; it scatters through
``index_put_(accumulate=True)`` on the card, which sorts the ids and
sums each segment's rows in their original order (``index_add_``'s
atomics would leave that order to the hardware).
"""
from __future__ import annotations

from typing import Callable

import torch

from .device import default_device
from .distribution import LongRange

__all__ = ["Accumulator", "segment_accept"]


class Accumulator:
    """Factory of per-grain shadow buffers over a ``LongRange``.

    Lifecycle (paper §4.11): (1) create, (2) parallel accumulation into
    per-grain buffers via :meth:`grain`, (3) :meth:`accept` reduces all
    buffers and hands the per-index totals to the caller's closure.

    ``AccumulatorCompleteRange`` semantics: each grain's buffer covers
    the complete range (simple, what the paper ships); see
    ``sparse=True`` for the per-need allocation the paper lists as
    future work — buffers are dicts of touched blocks, reducing memory
    from O(grains*range) to O(grains*touched).

    Buffers are tensors of ``dtype`` (``torch.float64`` by default) on
    ``device``: the CUDA card unless the caller asks for the CPU.
    """

    def __init__(self, r: LongRange, entry_shape: tuple[int, ...] = (),
                 dtype: torch.dtype = torch.float64, *, sparse: bool = False,
                 block: int = 256, device=None):
        self.range = r
        self.entry_shape = tuple(entry_shape)
        self.dtype = dtype
        self.sparse = sparse
        self.block = block
        self.device = default_device(device)
        self._dense: list[torch.Tensor] = []
        self._sparse: list[dict[int, torch.Tensor]] = []

    def _zeros(self, n: int) -> torch.Tensor:
        return torch.zeros((n,) + self.entry_shape, dtype=self.dtype,
                           device=self.device)

    # -- phase 2: accumulation -----------------------------------------
    def grain(self):
        """Allocate one grain's shadow buffer; returns the buffer (dense
        mode) or an ``add(idx, value)`` view object (sparse mode)."""
        if not self.sparse:
            buf = self._zeros(self.range.size)
            self._dense.append(buf)
            return buf
        store: dict[int, torch.Tensor] = {}
        self._sparse.append(store)
        acc = self

        class _SparseView:
            def add(self, idx: int, value) -> None:
                off = idx - acc.range.start
                b = off // acc.block
                buf = store.get(b)
                if buf is None:
                    buf = acc._zeros(acc.block)
                    store[b] = buf
                buf[off - b * acc.block] += value

        return _SparseView()

    def add(self, buf: torch.Tensor, idx: int, value) -> None:
        buf[idx - self.range.start] += value

    # -- phase 3: accept --------------------------------------------------
    def totals(self) -> torch.Tensor:
        """Deterministic reduction of all grains (fixed grain order)."""
        out = self._zeros(self.range.size)
        for buf in self._dense:
            out += buf
        for store in self._sparse:
            for b, buf in sorted(store.items()):
                lo = b * self.block
                hi = min(lo + self.block, self.range.size)
                out[lo:hi] += buf[: hi - lo]
        return out

    def accept(self, apply_fn: Callable[[int, torch.Tensor], None]) -> None:
        """paper's ``parallelAccept``: apply per-index totals."""
        tot = self.totals()
        for i in range(self.range.size):
            apply_fn(self.range.start + i, tot[i])
        self.reset()

    def accept_into(self, target: torch.Tensor) -> torch.Tensor:
        target = target + self.totals()
        self.reset()
        return target

    def reset(self) -> None:
        self._dense.clear()
        self._sparse.clear()

    @property
    def buffers_allocated(self) -> int:
        dense = len(self._dense) * self.range.size
        sparse = sum(len(s) * self.block for s in self._sparse)
        return dense + sparse


def segment_accept(partials: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Tensor-side accept: deterministic segment-sum of per-grain partial
    contributions (grains = leading axis; ``segment_ids`` indexes the
    second).  Ids outside ``[0, num_segments)`` are dropped, as
    ``jax.ops.segment_sum`` drops them.  Each segment sums its rows in
    grain-major order on either device, so two calls give the same
    bits."""
    flat = partials.reshape((-1,) + tuple(partials.shape[2:]))
    seg = segment_ids.to(device=partials.device, dtype=torch.long)
    seg = seg[None, :].expand(partials.shape[:2]).reshape(-1)
    # out-of-range ids land in one spare row, cut off at the end (no
    # host sync to filter them)
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(flat.shape[1:]),
                      dtype=partials.dtype, device=partials.device)
    if out.device.type == "cuda":
        out.index_put_((seg,), flat, accumulate=True)
    else:
        out.index_add_(0, seg, flat)
    return out[:num_segments]
