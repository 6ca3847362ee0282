"""Teamed operations (paper §3.4, §4.7, §4.8) in PyTorch.

A *teamed operation* involves one activity per place of a group and acts
as both communication and synchronization.  Host-side (the collection
runtime) they operate across local handles directly, with byte
accounting; the ``spmd_*`` variants are tensor code over an explicit
leading place dimension, where every place receives the result.

The ``Reducer`` protocol is the paper's §4.7 contract: ``new_reducer``
(fresh identity), ``reduce`` (fold one/multiple entries in), ``merge``
(associative combine of two reducers).  Teamed reduction = local fold on
each handle, then an allreduce-style merge (§4.8) — a sum over the place
dimension for additive reducers, an in-order fold for arbitrary monoids.
"""
from __future__ import annotations

from typing import Any, Callable, Protocol, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .collections import DistArray, PlaceGroup, _value_nbytes

__all__ = [
    "Reducer",
    "local_reduce",
    "team_reduce",
    "spmd_team_reduce",
    "allgather1",
    "spmd_allgather1",
    "broadcast_from",
]


class Reducer(Protocol):
    """User-defined reduction (paper §4.7)."""

    def new_reducer(self) -> Any:  # identity state (a pytree)
        ...

    def reduce(self, state: Any, rows: torch.Tensor) -> Any:  # fold in
        ...

    def merge(self, a: Any, b: Any) -> Any:  # associative+commutative
        ...

    # additive reducers may set this True to enable the sum fast path
    additive: bool = False


def local_reduce(col: DistArray, place: int, reducer: Reducer) -> Any:
    """Parallel local reduction (paper §4.7): each chunk (the parallel
    grain) folds independently, then the states merge in range order."""
    states = []
    h = col.handle(place)
    for r in h.ranges():
        states.append(reducer.reduce(reducer.new_reducer(), h.chunks[r]))
    if not states:
        return reducer.new_reducer()
    acc = states[0]
    for s in states[1:]:
        acc = reducer.merge(acc, s)
    return acc


def team_reduce(col: DistArray, reducer: Reducer) -> Any:
    """Teamed reduction (paper §4.8): local reduce per handle, then a
    global merge in place order.  Every place receives the same result
    (allreduce semantics)."""
    group = col.group
    locals_ = [local_reduce(col, p, reducer) for p in group.members]
    acc = locals_[0]
    for s in locals_[1:]:
        acc = reducer.merge(acc, s)
    payload = sum(_value_nbytes(leaf)
                  for st in locals_ for leaf in pytree.tree_leaves(st))
    col.comm.record(payload, messages=group.size())
    col.comm.syncs += 1
    return acc


def spmd_team_reduce(local_state: Any, reducer: Reducer) -> Any:
    """Teamed reduction over the place dimension: ``local_state`` is a
    pytree whose leaves carry a leading place dimension ``P`` (each
    place's folded state).  Additive reducers sum over it; general
    monoids fold the places in order.  Returns the same pytree with the
    reduced state broadcast back to every place."""
    leaves, spec = pytree.tree_flatten(local_state)
    P = leaves[0].shape[0]
    if getattr(reducer, "additive", False):
        red = [x.sum(0) for x in leaves]
    else:
        def pick(i):
            return pytree.tree_unflatten([x[i] for x in leaves], spec)

        acc = pick(0)
        for i in range(1, P):
            acc = reducer.merge(acc, pick(i))
        red = pytree.tree_leaves(acc)
    return pytree.tree_unflatten(
        [torch.as_tensor(r).expand((P,) + tuple(torch.as_tensor(r).shape))
         .clone() for r in red], spec)


def allgather1(group: PlaceGroup, values: Sequence[float]) -> np.ndarray:
    """Paper §4.5's ``allGather1``: every place contributes one scalar and
    receives the full vector (the load-balancer's cost exchange)."""
    if len(values) != group.size():
        raise ValueError("one value per place required")
    return np.asarray(list(values), dtype=np.float64)


def spmd_allgather1(x: torch.Tensor) -> torch.Tensor:
    """Allgather of one scalar per place: ``x`` (P,) → (P, P), every
    place holding the full vector."""
    return x.unsqueeze(0).expand(x.shape[0], x.shape[0]).clone()


def broadcast_from(group: PlaceGroup, owner: int, value,
                   sinks: dict[int, Callable[[Any], None]]) -> None:
    """One-producer broadcast (CachableArray.broadcast's transport):
    every non-owner sink receives its own copy of ``value``."""
    for p in group.members:
        if p == owner:
            continue
        sinks[p](value.clone() if isinstance(value, torch.Tensor)
                 else np.copy(value))
