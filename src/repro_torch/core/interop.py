"""Carrying collection state across packages, through numpy only.

A collection's state is exported as plain numpy structures, so another
implementation of the same collections (or a checkpoint, or a test) can
seed from it without either side importing the other:

* arrays: ``{place: [(start, end, rows), ...]}`` with ``rows`` a numpy
  array of the chunk's rows;
* maps: ``{place: [(key, value), ...]}`` with every tensor leaf of a
  value exported as a numpy array;
* model parameters and decode states: the reference's pytree (dicts
  and tuples, stacked ``scan`` leaves with a leading period axis) with
  numpy leaves — what ``jax.tree_util.tree_map(np.asarray, params)``
  gives.  The port keeps the same leaf paths and shapes (a dense weight
  is ``(d_in, d_out)`` on both sides), so the converter is a copy;
* AdamW state: ``{"m", "v", "count"}`` with the parameters' tree under
  each moment (f32 or bfloat16 leaves, or an int8 ``{"q", "scale"}``
  pair per parameter) and a scalar int32 step count.

bfloat16 has no numpy dtype here: its bytes cross as a ``uint16`` view,
and a bfloat16 array of an extension dtype (``dtype.name ==
"bfloat16"``) is read through the same view.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .collections import DistArray, DistIdMap, DistMap, PlaceGroup
from .distribution import LongRange

__all__ = ["array_state_from_numpy", "array_state_to_numpy",
           "map_state_from_numpy", "map_state_to_numpy",
           "tensor_from_numpy", "tensor_to_numpy",
           "params_from_numpy", "params_to_numpy",
           "decode_state_from_numpy", "decode_state_to_numpy",
           "opt_state_from_numpy", "opt_state_to_numpy"]


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array → a tensor on ``device`` with the same bytes (an
    extension-dtype bfloat16 array through its ``uint16`` view)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor → a host numpy copy (bfloat16 as its ``uint16`` view)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
        return t.numpy().view(np.uint16).copy()
    return t.numpy().copy()


def array_state_from_numpy(group: PlaceGroup, state: dict, *,
                           track: bool = True) -> DistArray:
    """Build a :class:`DistArray` on ``group`` from ``{place: [(start,
    end, rows), ...]}``."""
    col = DistArray(group, track=track)
    for p in group.members:
        col.handle(p)
    for place, chunks in state.items():
        for start, end, rows in chunks:
            col.add_chunk(place, LongRange(int(start), int(end)),
                          tensor_from_numpy(rows, group.device))
    return col


def array_state_to_numpy(col: DistArray) -> dict:
    """``{place: [(start, end, rows), ...]}`` of ``col``, chunks in
    range order."""
    out = {}
    for p in col.group.members:
        h = col.handle(p)
        out[p] = [(r.start, r.end, tensor_to_numpy(h.chunks[r]))
                  for r in h.ranges()]
    return out


def map_state_from_numpy(group: PlaceGroup, state: dict, *,
                         id_map: bool = True) -> DistMap:
    """Build a :class:`DistIdMap` (or, for non-integer keys, a plain
    :class:`DistMap`) on ``group`` from ``{place: [(key, value), ...]}``.
    Every numpy-array leaf of a value becomes a tensor on the group's
    device; numpy scalars and other leaves stay as they are."""
    col = DistIdMap(group) if id_map else DistMap(group)
    for p in group.members:
        col.handle(p)

    def leaf(x):
        if isinstance(x, np.ndarray) and not x.dtype.hasobject:
            return tensor_from_numpy(x, group.device)
        return x

    for place, entries in state.items():
        for key, value in entries:
            col.put(place, key, pytree.tree_map(leaf, value))
    return col


def map_state_to_numpy(col: DistMap) -> dict:
    """``{place: [(key, value), ...]}`` of ``col`` with tensor leaves
    as numpy arrays, keys in sorted order where they sort."""
    out = {}
    for p in col.group.members:
        keys = col.keys(p)
        try:
            keys = sorted(keys)
        except TypeError:
            pass
        out[p] = [(k, pytree.tree_map(
            lambda x: tensor_to_numpy(x) if isinstance(x, torch.Tensor)
            else x, col.get(p, k))) for k in keys]
    return out


# ---------------------------------------------------------------------------
# model parameters and decode states
# ---------------------------------------------------------------------------
def _tree_from_numpy(tree, device):
    def leaf(x):
        if x is None or isinstance(x, torch.Tensor):
            return x
        return tensor_from_numpy(x, device)
    return pytree.tree_map(leaf, tree)


def _tree_to_numpy(tree):
    return pytree.tree_map(
        lambda x: tensor_to_numpy(x) if isinstance(x, torch.Tensor) else x,
        tree)


def params_from_numpy(cfg, tree, *, device):
    """The port's parameters on ``device`` from the JAX package's
    parameter pytree exported as numpy; leaf paths, shapes and dtypes are
    kept as they are."""
    from ..models.transformer import _check_supported
    _check_supported(cfg)
    return _tree_from_numpy(tree, device)


def params_to_numpy(params):
    """Parameters → the reference's pytree with numpy leaves."""
    return _tree_to_numpy(params)


def decode_state_from_numpy(cfg, tree, *, device):
    """A decode state on ``device`` from the JAX package's decode-state
    pytree exported as numpy (bfloat16 caches included)."""
    from ..models.transformer import _check_supported
    _check_supported(cfg)
    return _tree_from_numpy(tree, device)


def decode_state_to_numpy(state):
    """A decode state → numpy pytree (bfloat16 leaves as ``uint16``
    views)."""
    return _tree_to_numpy(state)


def opt_state_from_numpy(tree, *, device):
    """An AdamW state on ``device`` from the JAX package's
    ``adamw_init`` / ``adamw_update`` state exported as numpy (the int8
    ``{"q", "scale"}`` leaves and the 0-d step count included)."""
    if set(tree) != {"m", "v", "count"}:
        raise ValueError(f"an AdamW state has m, v and count, got "
                         f"{sorted(tree)}")
    return _tree_from_numpy(tree, device)


def opt_state_to_numpy(state):
    """An AdamW state → the reference's pytree with numpy leaves."""
    return _tree_to_numpy(state)
