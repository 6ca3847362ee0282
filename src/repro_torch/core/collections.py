"""Relocatable distributed collections (paper §3, Table 1) in PyTorch.

Local-handle semantics: a distributed collection is a set of *local
handles*, one per place, linked by a global id.  All reads/writes go
through a place's own handle; anything that crosses places is a *teamed
operation* (relocation, gather, broadcast, reduction — see
``relocation.py`` / ``teamed.py``).

On one card a "place" is a shard of the group's device: a place's
handle holds its chunks as tensors on ``group.device`` (``cuda`` unless
the caller asks for the CPU), so a relocation window moves rows from
chunk to send buffer to chunk without a host bounce.  Lazy handle
allocation (paper §5.1) is preserved: handles materialize on first
touch of a place, not at construction.
"""
from __future__ import annotations

import pickle
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..analysis import sanitizer as _san
from .distribution import LongRange, RangeDistribution

__all__ = [
    "PlaceGroup",
    "DistArray",
    "DistBag",
    "DistMap",
    "DistIdMap",
    "DistMultiMap",
    "CachableArray",
    "CachableChunkedList",
]

_GLOBAL_ID_LOCK = threading.Lock()
_NEXT_GLOBAL_ID = [0]

def _fresh_global_id() -> int:
    with _GLOBAL_ID_LOCK:
        _NEXT_GLOBAL_ID[0] += 1
        return _NEXT_GLOBAL_ID[0]


# ---------------------------------------------------------------------------
# dtypes: manifest tokens are the JAX package's, so both packages write
# the same manifests (numpy ``.str`` spelling for chunk manifests and
# host leaves, numpy ``.name`` for device leaves; bfloat16 by name)
# ---------------------------------------------------------------------------
_TORCH_DTYPES = {
    torch.float64: ("<f8", "float64"), torch.float32: ("<f4", "float32"),
    torch.float16: ("<f2", "float16"), torch.bfloat16: ("bfloat16",
                                                        "bfloat16"),
    torch.int64: ("<i8", "int64"), torch.int32: ("<i4", "int32"),
    torch.int16: ("<i2", "int16"), torch.int8: ("|i1", "int8"),
    torch.uint8: ("|u1", "uint8"), torch.bool: ("|b1", "bool"),
}
_TOKEN_DTYPE = {tok: dt for dt, toks in _TORCH_DTYPES.items()
                for tok in toks}


def _dtype_token(dt) -> str:
    """Manifest-safe dtype spelling: numpy's ``.str`` (endianness-exact)
    when it round-trips, else its ``.name``; torch dtypes map to the
    same spelling (bfloat16 by name)."""
    if isinstance(dt, torch.dtype):
        try:
            return _TORCH_DTYPES[dt][0]
        except KeyError:
            raise TypeError(f"no manifest token for {dt}") from None
    dt = np.dtype(dt)
    return dt.str if np.dtype(dt.str) == dt else dt.name


def _torch_dtype(token) -> torch.dtype:
    """Manifest token (either spelling) → torch dtype."""
    if isinstance(token, torch.dtype):
        return token
    try:
        return _TOKEN_DTYPE[token]
    except KeyError:
        raise TypeError(f"no torch dtype for manifest token {token!r}") \
            from None


# ---------------------------------------------------------------------------
# pytrees: ``None`` is structure, not a leaf
#
# ``torch.utils._pytree`` flattens ``None`` as a leaf; ``jax.tree_util``
# (the reference) keeps it in the structure with no payload.  Every
# flatten of a payload goes through these two, so a value such as
# ``{"k": page, "v": page, "pos": pos, "cross_kv": None}`` takes the tree
# codec, ships the same unique-leaf bytes and reports the same sizes as
# in the JAX package.
# ---------------------------------------------------------------------------
def tree_flatten(v) -> tuple[list, tuple]:
    """Leaves of ``v`` without its ``None`` s, and the spec that puts
    them back (:func:`tree_unflatten`)."""
    leaves, treedef = pytree.tree_flatten(v)
    none_at = tuple(i for i, x in enumerate(leaves) if x is None)
    if none_at:
        leaves = [x for x in leaves if x is not None]
    return leaves, (treedef, none_at, len(leaves) + len(none_at))


def tree_unflatten(leaves, spec):
    treedef, none_at, n = spec
    if none_at:
        it = iter(leaves)
        nones = set(none_at)
        leaves = [None if i in nones else next(it) for i in range(n)]
    return pytree.tree_unflatten(list(leaves), treedef)


def tree_leaves(v) -> list:
    """The leaves of ``v``, ``None`` s left out (as ``jax.tree_util``)."""
    return [x for x in pytree.tree_leaves(v) if x is not None]


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------
def unique_leaves_nbytes(leaves, seen: set) -> int:
    """Total bytes of ``leaves`` counting each distinct buffer once
    (dedup by object identity — the single definition the §5.3 byte
    accounting rests on)."""
    total = 0
    for leaf in leaves:
        if id(leaf) in seen:
            continue
        seen.add(id(leaf))
        lb = getattr(leaf, "nbytes", None)
        total += int(lb) if lb is not None else int(np.asarray(leaf).nbytes)
    return total


def _value_nbytes(x, _seen: set | None = None) -> int:
    """Payload size without a device→host transfer: tensors and arrays
    report their size directly.  Pytree values count each distinct
    buffer **once** (two leaves aliasing one tensor are one buffer on
    any real wire); ``_seen`` extends the dedup across the values of
    one payload."""
    if _seen is None:
        nb = getattr(x, "nbytes", None)
        if nb is not None:
            return int(nb)
    elif isinstance(x, (np.ndarray, np.generic, torch.Tensor)):
        if id(x) in _seen:
            return 0
        _seen.add(id(x))
        return int(x.nbytes)
    leaves = tree_leaves(x)
    if len(leaves) == 1 and leaves[0] is x:
        if _seen is not None:
            if id(x) in _seen:
                return 0
            _seen.add(id(x))
        nb = getattr(x, "nbytes", None)
        return int(nb) if nb is not None else int(np.asarray(x).nbytes)
    return unique_leaves_nbytes(leaves,
                                _seen if _seen is not None else set())


# ---------------------------------------------------------------------------
# Row codecs (transport layer, §5.3 Alltoallv payload encoding)
#
# A *row codec* maps each payload to byte rows + a host-side manifest,
# so any transport can ship them without knowing the collection's
# internals, and the receiver rebuilds a bit-identical payload.
# Tensor leaves are the "device leaves": their bytes are viewed and
# concatenated on their own device (no host bounce).  Encoding is
# alias-aware: leaves that alias one tensor encode (and ship) once, and
# decoding rebinds them.
# ---------------------------------------------------------------------------
def _np_bytes(a) -> np.ndarray:
    """1-D uint8 copy of an array's bytes (any layout/dtype)."""
    a = np.ascontiguousarray(np.asarray(a))
    return np.frombuffer(a.tobytes(), np.uint8)


def _host_u8(row) -> np.ndarray:
    """A byte row (tensor or array-like) as a host uint8 array."""
    if isinstance(row, torch.Tensor):
        return row.detach().to("cpu", torch.uint8).numpy()
    return np.asarray(row, np.uint8)


def _np_from_bytes(row, dtype, shape) -> np.ndarray:
    nb = int(np.dtype(dtype).itemsize * np.prod(shape, dtype=np.int64))
    buf = _host_u8(row)[:nb]
    return np.frombuffer(buf.tobytes(), dtype=dtype).reshape(shape).copy()


def _tensor_bytes(x: torch.Tensor) -> torch.Tensor:
    """1-D uint8 view of a tensor's bytes, on its own device."""
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _tensor_from_bytes(row, dtype, shape) -> torch.Tensor:
    """Inverse of :func:`_tensor_bytes`, in a fresh tensor on ``row``'s
    device (the receive buffer is not pinned by the decoded leaf)."""
    dt = _torch_dtype(dtype)
    nb = int(dt.itemsize * np.prod(shape, dtype=np.int64))
    if not isinstance(row, torch.Tensor):
        row = torch.from_numpy(np.array(_host_u8(row)[:nb]))
    u8 = row[:nb].to(torch.uint8).clone()
    return u8.view(dt).reshape(tuple(shape))


def _is_host_array(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic)) \
        and not np.asarray(x).dtype.hasobject


def _encode_value(v) -> tuple[Any, tuple]:
    """One map/bag value → (1-D byte row, spec).

    * plain host array → raw bytes (``("arr", dtype, shape, nbytes)``);
      a numpy scalar → ``("num", dtype, nbytes)``;
    * pytree of tensor/array leaves (KV page dicts, decode-state dicts,
      multimap lists) → unique-leaf bytes concatenated, on the device
      when any leaf is a tensor (``("tree", treedef, leafspecs, alias,
      nbytes)``, tensor leaves as ``("dev", dtype name, shape, nbytes)``);
    * anything else → pickle.
    """
    leaves, treedef = tree_flatten(v)
    plain_leaf = len(leaves) == 1 and leaves[0] is v
    if plain_leaf and isinstance(v, np.generic) and _is_host_array(v):
        # numpy scalars decode back to scalars, not 0-d arrays —
        # receivers may hash or compare them
        row = _np_bytes(v)
        return row, ("num", _dtype_token(np.asarray(v).dtype), len(row))
    if plain_leaf and isinstance(v, np.ndarray) and _is_host_array(v):
        row = _np_bytes(v)
        return row, ("arr", _dtype_token(v.dtype), v.shape, len(row))
    # object-dtype arrays hold pointers, not bytes — pickle those whole
    arrayish = all(isinstance(x, torch.Tensor) or _is_host_array(x)
                   for x in leaves)
    if leaves and arrayish and (not plain_leaf
                                or isinstance(v, torch.Tensor)):
        uniq: list = []
        index: dict[int, int] = {}
        alias: list[int] = []
        for x in leaves:
            j = index.get(id(x))
            if j is None:
                j = len(uniq)
                index[id(x)] = j
                uniq.append(x)
            alias.append(j)
        specs, pieces = [], []
        device = None
        for x in uniq:
            if isinstance(x, torch.Tensor):
                pieces.append(_tensor_bytes(x))
                device = device or x.device
                specs.append(("dev", _TORCH_DTYPES[x.dtype][1],
                              tuple(x.shape), int(x.nbytes)))
            else:
                a = np.asarray(x)
                pieces.append(_np_bytes(a))
                specs.append(("nps" if isinstance(x, np.generic) else "np",
                              _dtype_token(a.dtype), a.shape,
                              int(a.nbytes)))
        total = int(sum(s[3] for s in specs))
        if device is not None:
            row = torch.cat([p if isinstance(p, torch.Tensor)
                             else torch.from_numpy(p).to(device)
                             for p in pieces])
        else:
            row = np.concatenate(pieces) if pieces \
                else np.zeros((0,), np.uint8)
        return row, ("tree", treedef, tuple(specs), tuple(alias), total)
    blob = pickle.dumps(v)
    return np.frombuffer(blob, np.uint8), ("pkl", len(blob))


def _decode_value(row, spec):
    """Inverse of :func:`_encode_value`; ``row`` may be longer than the
    encoded width (transport padding) and may be a device tensor."""
    kind = spec[0]
    if kind == "arr":
        _, dt, shape, _ = spec
        return _np_from_bytes(row, np.dtype(dt), shape)
    if kind == "num":
        _, dt, _ = spec
        return _np_from_bytes(row, np.dtype(dt), ())[()]
    if kind == "pkl":
        _, nb = spec
        return pickle.loads(_host_u8(row)[:nb].tobytes())
    _, treedef, specs, alias, _ = spec
    uniq, off = [], 0
    host_row = None
    for lkind, dt, shape, nb in specs:
        if lkind == "dev":
            uniq.append(_tensor_from_bytes(row[off:off + nb], dt, shape))
        else:
            if host_row is None:
                host_row = _host_u8(row)
            leaf = _np_from_bytes(host_row[off:off + nb],
                                  np.dtype(dt), shape)
            uniq.append(leaf[()] if lkind == "nps" else leaf)
        off += nb
    return tree_unflatten([uniq[j] for j in alias], treedef)


def _as_rows(rows, device) -> torch.Tensor:
    """Chunk rows as a tensor on ``device``; host arrays are copied (a
    collection never aliases its caller's numpy buffer)."""
    if isinstance(rows, torch.Tensor):
        return rows.to(device)
    return torch.tensor(np.asarray(rows), device=device)


class PlaceGroup:
    """Paper's ``TeamedPlaceGroup``: an ordered set of places.

    ``device`` is where every collection of the group keeps its chunks
    and values.  It defaults to ``cuda``; with no card present the
    caller must ask for the CPU (``device="cpu"``) — the group never
    picks it on its own.
    """

    def __init__(self, n_places: int, *, device=None,
                 members: Sequence[int] | None = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "PlaceGroup defaults to the CUDA device and none is "
                    "available; pass device='cpu' to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.n_places = int(n_places)
        self.members = tuple(members) if members is not None \
            else tuple(range(n_places))
        if len(self.members) != self.n_places:
            raise ValueError("members length must equal n_places")

    #: single-process groups: every place is local and rank 0 owns all
    process_backed = False

    @staticmethod
    def world(n_places: int, **kw) -> "PlaceGroup":
        return PlaceGroup(n_places, **kw)

    def subgroup(self, members: Sequence[int]) -> "PlaceGroup":
        """Paper §3.4: teamed ops over a subset of the world."""
        members = tuple(members)
        return PlaceGroup(len(members), device=self.device, members=members)

    def size(self) -> int:
        return self.n_places

    # -- process topology (trivial for in-process groups) -----------------
    def rank_of(self, place: int) -> int:
        """OS-process rank owning ``place`` (always 0 in-process)."""
        return 0

    def is_local(self, place: int) -> bool:
        """Does ``place``'s handle live in this process?"""
        return True

    def local_places(self) -> tuple:
        """The members whose handles live in this process."""
        return self.members

    def exchange_counts(self, counts: np.ndarray) -> np.ndarray:
        """Phase-1 Alltoall of the place×place byte-count matrix: the
        in-process group already sees the global matrix."""
        return counts

    def exchange_range_claims(self, claims: Sequence[int]) -> list[int]:
        """Per-range-move locally-covered entry counts (identity
        in-process)."""
        return [int(c) for c in claims]

    def __contains__(self, place: int) -> bool:
        return place in self.members

    def __repr__(self) -> str:
        return f"PlaceGroup({list(self.members)}, device={self.device})"


class _CommStats:
    """Communication accounting shared by teamed operations so the
    benchmarks can report Alltoall/Alltoallv-equivalent volumes."""

    def __init__(self):
        self.bytes_moved = 0
        self.messages = 0
        self.syncs = 0

    def record(self, nbytes: int, messages: int = 1) -> None:
        self.bytes_moved += int(nbytes)
        self.messages += int(messages)

    def reset(self) -> None:
        self.bytes_moved = 0
        self.messages = 0
        self.syncs = 0


class DistCollection:
    """Base: global id, place group, lazily-allocated local handles.

    ``_lock`` serializes structural mutation of the handles across the
    relocation engine's background threads: with double-buffered windows
    (``sync_async(depth=2)``) window N's *delivery* runs concurrently
    with window N+1's *extraction* — both against the same handles.
    Pure reads stay lock-free: they tolerate concurrent pops/inserts by
    snapshotting (``list(h)``) and ``get``-ing.
    """

    def __init__(self, group: PlaceGroup):
        self.group = group
        self.global_id = _fresh_global_id()
        self._handles: dict[int, Any] = {}
        self._lock = threading.RLock()
        self.comm = _CommStats()

    @property
    def device(self) -> torch.device:
        return self.group.device

    # -- lazy allocation (paper §5.1) ---------------------------------
    def _new_handle(self) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    def handle(self, place: int):
        """The local handle of ``place``; allocated on first touch."""
        if place not in self.group:
            raise KeyError(f"place {place} not in {self.group}")
        h = self._handles.get(place)
        if h is None:
            h = self._new_handle()
            self._handles[place] = h
        return h

    def allocated_places(self) -> list[int]:
        return sorted(self._handles)


# ---------------------------------------------------------------------------
# DistArray : DistChunkedList / DistCol
# ---------------------------------------------------------------------------
class _ChunkHandle:
    """A place's chunks: disjoint ``LongRange`` → tensor of rows."""

    def __init__(self):
        self.chunks: dict[LongRange, torch.Tensor] = {}

    def ranges(self) -> list[LongRange]:
        return sorted(self.chunks, key=lambda r: r.start)

    def size(self) -> int:
        return sum(r.size for r in self.chunks)

    def get(self, idx: int) -> torch.Tensor:
        for r, arr in self.chunks.items():
            if r.contains(idx):
                return arr[idx - r.start]
        raise KeyError(idx)

    def set(self, idx: int, value) -> None:
        for r, arr in self.chunks.items():
            if r.contains(idx):
                arr[idx - r.start] = torch.as_tensor(value).to(arr.device)
                return
        raise KeyError(idx)

    def add_chunk(self, r: LongRange, arr: torch.Tensor) -> None:
        if r.size != len(arr):
            raise ValueError(f"chunk {r} size != array length {len(arr)}")
        for existing in self.chunks:
            if existing.overlaps(r):
                raise ValueError(f"chunk {r} overlaps existing {existing}")
        self.chunks[r] = arr

    def intersections(self, r: LongRange) -> list[LongRange]:
        """Locally-held sub-ranges of ``r``, sorted by start."""
        inters = [cr.intersection(r) for cr in self.chunks]
        return sorted((i for i in inters if i is not None),
                      key=lambda i: i.start)

    def extract(self, r: LongRange) -> torch.Tensor:
        """Remove and return rows covering ``r`` (splits chunks as needed,
        paper §5.2).  Coverage is validated *before* any chunk is popped:
        a partial hold raises with the handle untouched.  Split pieces
        are views of the chunk they came from (no copy); a range that
        spans several chunks is concatenated."""
        inters = self.intersections(r)
        if not inters:
            raise KeyError(f"range {r} not held locally")
        covered = sum(i.size for i in inters)
        if covered != r.size or inters[0].start != r.start:
            raise KeyError(f"range {r} only partially held locally")
        taken = []
        for cr in list(self.chunks):
            inter = cr.intersection(r)
            if inter is None:
                continue
            arr = self.chunks.pop(cr)
            lo = inter.start - cr.start
            hi = inter.end - cr.start
            taken.append((inter.start, arr[lo:hi]))
            if lo > 0:
                self.chunks[LongRange(cr.start, inter.start)] = arr[:lo]
            if hi < cr.size:
                self.chunks[LongRange(inter.end, cr.end)] = arr[hi:]
        taken.sort(key=lambda t: t[0])
        if len(taken) == 1:
            return taken[0][1]
        return torch.cat([a for _, a in taken], dim=0)


class DistArray(DistCollection):
    """Paper's ``DistChunkedList`` / ``DistCol``: a long-indexed array
    whose rows live in per-place chunks on the group's device; with
    tracked distribution.

    ``track=True`` gives ``DistCol`` semantics (ownership table kept &
    reconciled through :meth:`update_dist`); ``track=False`` is the
    plain ``DistChunkedList``.
    """

    def __init__(self, group: PlaceGroup, *, track: bool = True):
        super().__init__(group)
        self.track = track
        self._dist = RangeDistribution() if track else None
        self.update_bytes = 0  # delta traffic accounting for updateDist

    def _new_handle(self) -> _ChunkHandle:
        return _ChunkHandle()

    # -- local access ---------------------------------------------------
    def add_chunk(self, place: int, r: LongRange, rows) -> None:
        with self._lock:
            self.handle(place).add_chunk(r, _as_rows(rows, self.device))
            if self.track:
                self._dist.assign(r, place)

    def get(self, place: int, idx: int):
        return self.handle(place).get(idx)

    def set(self, place: int, idx: int, value) -> None:
        if _san._ACTIVE:
            _san.check_mutation(self, "set", idx)
        self.handle(place).set(idx, value)

    def ranges(self, place: int) -> list[LongRange]:
        return self.handle(place).ranges()

    def local_size(self, place: int) -> int:
        return self.handle(place).size()

    def global_size(self) -> int:
        return sum(self.handle(p).size() for p in self.group.members)

    # -- parallel patterns (intra-node parallelism, paper §3.5) ---------
    def for_each(self, place: int,
                 fn: Callable[[int, torch.Tensor], None]) -> None:
        for r in self.ranges(place):
            arr = self.handle(place).chunks[r]
            for i in range(r.size):
                fn(r.start + i, arr[i])

    def map_chunks(self, place: int,
                   fn: Callable[[torch.Tensor], torch.Tensor]) -> None:
        """`parallelForEach` analogue: fn is applied per chunk (one
        tensor op per chunk instead of per-thread scheduling)."""
        if _san._ACTIVE:
            _san.check_mutation(self, "map_chunks")
        h = self.handle(place)
        for r in list(h.chunks):
            h.chunks[r] = _as_rows(fn(h.chunks[r]), self.device)

    def to_local_matrix(self, place: int) -> tuple[torch.Tensor, np.ndarray]:
        """Pack the place's rows into one dense (n, ...) tensor on the
        device + the global indices (numpy)."""
        h = self.handle(place)
        rs = h.ranges()
        if not rs:
            return (torch.zeros((0,), dtype=torch.float64,
                                device=self.device),
                    np.zeros((0,), np.int64))
        rows = h.chunks[rs[0]] if len(rs) == 1 \
            else torch.cat([h.chunks[r] for r in rs], dim=0)
        idx = np.concatenate([np.arange(r.start, r.end) for r in rs])
        return rows, idx

    # -- device bridge (collection runtime ↔ tensor compute) -------------
    def to_device(self, place: int):
        """The place's rows as one device tensor plus their global
        indices (host); :meth:`from_device` writes results back into
        the same chunk layout."""
        return self.to_local_matrix(place)

    def from_device(self, place: int, rows, idx=None) -> None:
        """Write a shard's rows back into the place's chunks (the
        inverse of :meth:`to_device`; the chunk layout must not have
        changed in between).  Pass the ``idx`` array :meth:`to_device`
        returned to verify the layout exactly."""
        if _san._ACTIVE:
            _san.check_mutation(self, "from_device")
        h = self.handle(place)
        rows = _as_rows(rows, self.device)
        if len(rows) != h.size():
            raise ValueError(
                f"device shard holds {len(rows)} rows but place {place} "
                f"holds {h.size()} — layout changed under the bridge")
        if idx is not None:
            cur = np.concatenate(
                [np.arange(r.start, r.end) for r in h.ranges()]) \
                if h.ranges() else np.zeros((0,), np.int64)
            if len(idx) != len(cur) or not np.array_equal(idx, cur):
                raise ValueError(
                    f"place {place} holds different indices than the "
                    f"device shard — layout changed under the bridge")
        off = 0
        for r in h.ranges():
            h.chunks[r] = rows[off:off + r.size]
            off += r.size

    # -- relocation registration (paper §5.2, RangeRelocatable) ---------
    def move_range_at_sync(self, r: LongRange, dest: int, mm) -> None:
        mm.register_range_move(self, r, dest)

    def move_at_sync_count(self, place: int, count: int, dest: int,
                           mm) -> None:
        """Bulk relocation: library picks the entries at sync time
        (paper §5.2) — several count moves from one source compose."""
        mm.register_array_count_move(self, place, count, dest)

    # -- distribution tracking (paper §4.6) ------------------------------
    def get_distribution(self) -> RangeDistribution:
        if not self.track:
            raise ValueError("distribution tracking disabled for this "
                             "collection")
        with self._lock:
            return self._dist.copy()

    def update_dist(self) -> None:
        """Teamed reconciliation: rebuild from handles while accounting
        the delta bytes the wire protocol would move (paper §4.6).  May
        run on a double-buffered window's delivery thread, so the whole
        rebuild-and-swap holds the collection lock."""
        if not self.track:
            raise ValueError("distribution tracking disabled")
        with self._lock:
            old = self._dist
            new = RangeDistribution()
            for p in self.group.local_places():
                for r in self.ranges(p):
                    new.assign(r, p)
            changed = 0
            for r, o in new.items():
                try:
                    prev_owner = old.owner_of(r.start)
                except KeyError:
                    prev_owner = -2
                if prev_owner != o:
                    changed += 1
            self.update_bytes += 8 * 3 * changed * self.group.size()
            self.comm.record(8 * 3 * changed * self.group.size(),
                             messages=self.group.size())
            self._dist = new

    # -- relocation execution hooks (called by CollectiveMoveManager) ----
    def _extract_range(self, r: LongRange, src: int) -> torch.Tensor:
        return self.handle(src).extract(r)

    def _insert_payload(self, dest: int, payload) -> None:
        r, rows = payload
        self.handle(dest).add_chunk(r, _as_rows(rows, self.device))

    def _payload_nbytes(self, payload) -> int:
        _, rows = payload
        return int(rows.nbytes) + 16

    # -- row codec (transport layer) -------------------------------------
    def encode_rows(self, payload, *, donate: bool = False):
        """Chunk payload → ``(m, width)`` uint8 row tensor + manifest
        (range, dtype token, trailing shape) — the §5.3 Alltoallv wire
        format a :class:`~repro_torch.core.transport.DeviceTransport`
        ships.  ``donate=True``: the caller promises not to mutate the
        payload while the rows are live, so the rows are a zero-copy
        byte view of the chunk instead of a copy."""
        r, rows = payload
        a = _as_rows(rows, self.device)
        m = int(a.shape[0]) if a.dim() else 0
        manifest = ("chunk", r, _dtype_token(a.dtype), tuple(a.shape[1:]))
        if not m:
            return torch.zeros((0, 0), dtype=torch.uint8,
                               device=a.device), manifest
        u8 = a.contiguous().reshape(m, -1).view(torch.uint8).reshape(m, -1)
        if not donate and u8.data_ptr() == a.data_ptr():
            u8 = u8.clone()
        return u8, manifest

    def encode_rows_raw(self, payload):
        """Typed ``(m, k)`` chunk matrix + manifest for the fused kernel
        codec — the byte view happens *in-kernel*
        (``kernels.reloc_codec.encode_pack``).  Every dtype of the
        manifest table rides this path (float64/int64 included: torch
        keeps them exact).  Returns ``None`` for an empty payload."""
        r, rows = payload
        a = _as_rows(rows, self.device)
        if a.dim() == 0 or a.shape[0] == 0 or a.numel() == 0 \
                or a.dtype not in _TORCH_DTYPES:
            return None
        m = int(a.shape[0])
        return (a.reshape(m, -1),
                ("chunk", r, _dtype_token(a.dtype), tuple(a.shape[1:])))

    def decode_rows(self, rows, manifest):
        """Inverse of :meth:`encode_rows`; ``rows`` may be wider than
        the encoded width (transport padding).  On the fused codec
        backend the block decodes through the ``decode_rows`` kernel
        (trim + dtype view in one pass); the result lands on the
        group's device."""
        from ..kernels import ops

        _, r, dt, trail = manifest
        dtype = _torch_dtype(dt)
        m = r.size
        nb = int(dtype.itemsize * np.prod(trail, dtype=np.int64))
        if m == 0:
            return r, torch.zeros((0,) + tuple(trail), dtype=dtype,
                                  device=self.device)
        if not isinstance(rows, torch.Tensor):
            rows = torch.from_numpy(np.array(rows, np.uint8))
        if nb and ops.resolve_backend(device=rows.device) == "fused":
            out = ops.reloc_decode_rows(rows[:m], nbytes=nb, dtype=dtype)
        else:
            out = rows[:m, :nb].clone(memory_format=torch.contiguous_format) \
                .view(dtype)
        return r, out.reshape((m,) + tuple(trail)).to(self.device)


class DistBag(DistCollection):
    """Paper's ``DistBag``: unordered multiset, efficient concurrent
    producers; entries have no identity so only bulk relocation exists."""

    def __init__(self, group: PlaceGroup):
        super().__init__(group)

    def _new_handle(self) -> list:
        return []

    def _item(self, item):
        """Numeric items become tensors on the group's device; anything
        else stays a host object (and rides the pickle codec)."""
        if isinstance(item, torch.Tensor):
            return item.to(self.device)
        a = np.asarray(item)
        if a.dtype.hasobject or a.dtype.kind not in "biuf":
            return a
        return torch.tensor(a, device=self.device)

    def put(self, place: int, item) -> None:
        if _san._ACTIVE:
            _san.check_mutation(self, "put")
        self.handle(place).append(self._item(item))

    def put_batch(self, place: int, items) -> None:
        if _san._ACTIVE:
            _san.check_mutation(self, "put_batch")
        self.handle(place).extend(self._item(x) for x in items)

    def local_size(self, place: int) -> int:
        return len(self.handle(place))

    def global_size(self) -> int:
        return sum(len(self.handle(p)) for p in self.group.members)

    def items(self, place: int) -> list:
        return list(self.handle(place))

    def clear(self, place: int) -> None:
        if _san._ACTIVE:
            _san.check_mutation(self, "clear")
        self.handle(place).clear()

    def move_at_sync_count(self, place: int, count: int, dest: int,
                           mm) -> None:
        mm.register_bag_move(self, place, count, dest)

    # producer/receiver (paper §4.2 parallelToBag): apply fn to each row
    # of `source` at `place`, collecting non-None results into this bag.
    def collect_from(self, place: int, source: DistArray,
                     fn: Callable[[int, torch.Tensor], Any]) -> None:
        out = self.handle(place)
        src = source.handle(place)
        for r in src.ranges():
            arr = src.chunks[r]
            for i in range(r.size):
                produced = fn(r.start + i, arr[i])
                if produced is not None:
                    out.append(self._item(produced))

    # teamed gather (paper §4.3): all entries relocate to `root`.
    def team_gather(self, root: int) -> None:
        self.comm.syncs += 1
        moved = 0
        for p in self.group.members:
            if p == root:
                continue
            h = self.handle(p)
            for item in h:
                self.handle(root).append(item)
                moved += _value_nbytes(item)
            h.clear()
        self.comm.record(moved, messages=self.group.size() - 1)

    def _extract_count(self, place: int, count: int):
        h = self.handle(place)
        if len(h) < count:
            raise ValueError(f"bag at place {place} holds {len(h)} < "
                             f"{count}")
        taken = h[-count:]
        del h[-count:]
        return taken

    def _insert_payload(self, dest: int, payload) -> None:
        self.handle(dest).extend(payload)

    def _payload_nbytes(self, payload) -> int:
        # per-item dedup (items encode/ship independently)
        return int(sum(_value_nbytes(x, set()) for x in payload)) + 16

    # -- row codec (transport layer) -------------------------------------
    def encode_rows(self, payload):
        """Bag payload (item list, shapes may differ per item) → one
        byte row per item + per-item specs."""
        rows, specs = [], []
        for item in payload:
            row, spec = _encode_value(item)
            rows.append(row)
            specs.append(spec)
        return rows, ("bag", tuple(specs))

    def decode_rows(self, rows, manifest):
        _, specs = manifest
        return [_decode_value(row, spec) for row, spec in zip(rows, specs)]


class DistMap(DistCollection):
    """Paper's ``DistMap<K,V>`` (and via ``multi=True``
    ``DistMultiMap``)."""

    def __init__(self, group: PlaceGroup, *, multi: bool = False):
        super().__init__(group)
        self.multi = multi
        # callers that retire keys while an async window's phase 1
        # extracts opt in to tolerating keys that vanish between
        # registration and extraction; for everyone else a missing key
        # stays a loud error, not silent entry loss
        self.tolerate_missing_keys = False

    def _new_handle(self) -> dict:
        return {}

    def put(self, place: int, key, value) -> None:
        if _san._ACTIVE:
            _san.check_mutation(self, "put", key)
        h = self.handle(place)
        if self.multi:
            h.setdefault(key, []).append(value)
        else:
            h[key] = value

    def get(self, place: int, key):
        return self.handle(place)[key]

    def keys(self, place: int):
        return list(self.handle(place).keys())

    def local_size(self, place: int) -> int:
        return len(self.handle(place))

    def global_size(self) -> int:
        return sum(len(self.handle(p)) for p in self.group.members)

    def for_each(self, place: int, fn: Callable[[Any, Any], None]) -> None:
        for k, v in list(self.handle(place).items()):
            fn(k, v)

    # -- device bridge (values become device-resident payloads) ----------
    def to_device(self, place: int, keys: Sequence | None = None) -> int:
        """Move every tensor/array leaf of the place's values onto the
        group's device, so later windows ship device buffers.  Returns
        the number of bytes now device-resident."""
        if _san._ACTIVE:
            _san.check_mutation(self, "to_device")
        h = self.handle(place)
        moved = 0

        def put(x):
            if isinstance(x, torch.Tensor):
                return x.to(self.device)
            if _is_host_array(x):
                return torch.tensor(np.asarray(x), device=self.device)
            return x

        for k in (list(h) if keys is None else keys):
            v = h.get(k)
            if v is None:
                continue
            dv = pytree.tree_map(put, v)
            h[k] = dv
            moved += sum(_value_nbytes(x) for x in tree_leaves(dv)
                         if isinstance(x, torch.Tensor))
        return moved

    def from_device(self, place: int, keys: Sequence | None = None) -> int:
        """Inverse bridge: pull device-resident values back to host
        tensors (checkpointing / inspection path).  Returns bytes
        moved."""
        if _san._ACTIVE:
            _san.check_mutation(self, "from_device")
        h = self.handle(place)
        moved = 0
        for k in (list(h) if keys is None else keys):
            v = h.get(k)
            if v is None:
                continue
            hv = pytree.tree_map(
                lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, v)
            h[k] = hv
            moved += sum(_value_nbytes(x) for x in tree_leaves(hv)
                         if isinstance(x, torch.Tensor))
        return moved

    # KeyRelocatable (paper §5.2): relocate by key→destination rule.
    def move_at_sync(self, place: int, rule: Callable[[Any], int],
                     mm) -> None:
        mm.register_key_moves(self, place, rule)

    def relocate(self, dist: RangeDistribution, mm=None) -> None:
        """Paper §4.4: relocate entries to match a (long-key)
        distribution.  Teamed: applies to all places."""
        from .relocation import CollectiveMoveManager
        own_mm = mm is None
        if own_mm:
            mm = CollectiveMoveManager(self.group)
        for p in self.group.members:
            self.move_at_sync(p, lambda k: dist.owner_of(int(k)), mm)
        if own_mm:
            mm.sync()

    def _extract_keys(self, place: int, keys):
        h = self.handle(place)
        if not self.tolerate_missing_keys:
            # validate before popping: a missing key raises with the
            # handle untouched, never with earlier keys already removed
            for k in keys:
                if k not in h:
                    raise KeyError(k)
        out = []
        for k in keys:
            try:
                out.append((k, h.pop(k)))
            except KeyError:
                # removed between registration and extraction — nothing
                # to relocate for this key
                pass
        return out

    def _insert_payload(self, dest: int, payload) -> None:
        h = self.handle(dest)
        for k, v in payload:
            if self.multi and isinstance(v, list):
                h.setdefault(k, []).extend(v)
            else:
                h[k] = v

    def _payload_nbytes(self, payload) -> int:
        # one `seen` set per VALUE: leaves aliased inside a value's
        # pytree (shared KV pages) count once — the codec ships them
        # once.  Two *values* sharing a buffer still count (and ship)
        # separately: each value is an independent wire row.
        total = 16
        for k, v in payload:
            vv = v if isinstance(v, list) else [v]
            seen: set = set()
            total += 8 + sum(_value_nbytes(x, seen) for x in vv)
        return total

    # -- row codec (transport layer) -------------------------------------
    def encode_rows(self, payload):
        """Key/value payload → one byte row per entry + (key, spec)
        manifest.  Values that are pytrees of device tensors encode on
        the device (byte view + concat, no host bounce)."""
        rows, entries = [], []
        for k, v in payload:
            row, spec = _encode_value(v)
            rows.append(row)
            entries.append((k, spec))
        return rows, ("map", tuple(entries))

    def decode_rows(self, rows, manifest):
        _, entries = manifest
        return [(k, _decode_value(row, spec))
                for row, (k, spec) in zip(rows, entries)]


class DistIdMap(DistMap):
    """Paper's ``DistIdMap``: long keys, tracked distribution."""

    def __init__(self, group: PlaceGroup):
        super().__init__(group, multi=False)
        self._dist = RangeDistribution()

    def put(self, place: int, key: int, value) -> None:
        # the dist assign must not interleave with a background window's
        # update_dist rebuild
        with self._lock:
            super().put(place, int(key), value)
            self._dist.assign(LongRange(int(key), int(key) + 1), place)

    def get_distribution(self) -> RangeDistribution:
        with self._lock:
            return self._dist.copy()

    def update_dist(self) -> None:
        with self._lock:
            new = RangeDistribution()
            for p in self.group.local_places():
                for k in self.keys(p):
                    new.assign(LongRange(k, k + 1), p)
            self._dist = new


def DistMultiMap(group: PlaceGroup) -> DistMap:
    """Paper's ``DistMultiMap``: multiple values per key."""
    return DistMap(group, multi=True)


# ---------------------------------------------------------------------------
# Replication: CachableArray / CachableChunkedList
# ---------------------------------------------------------------------------
class CachableArray(DistCollection):
    """Paper §4.1: owner-updated array replicated on every place.

    ``broadcast(pack, unpack)`` extracts an update object from the
    owner's entries and applies it to every replica.
    """

    def __init__(self, group: PlaceGroup, values, *, owner: int = 0):
        super().__init__(group)
        self.owner = owner
        self._template = [v for v in values]
        for p in group.members:
            self._handles[p] = self._new_handle()

    def _new_handle(self):
        return [_as_rows(v, self.device).clone() for v in self._template]

    def local(self, place: int) -> list[torch.Tensor]:
        return self.handle(place)

    def broadcast(self, pack: Callable[[Any], Any],
                  unpack: Callable[[Any, Any], Any]) -> None:
        self.comm.syncs += 1
        src = self.handle(self.owner)
        updates = [pack(v) for v in src]
        nbytes = sum(_value_nbytes(u) for u in updates)
        self.comm.record(nbytes * (self.group.size() - 1),
                         messages=self.group.size() - 1)
        for p in self.group.members:
            h = self.handle(p)
            for i, u in enumerate(updates):
                res = unpack(h[i], u)
                if res is not None:
                    h[i] = _as_rows(res, self.device)


class CachableChunkedList(DistArray):
    """Paper §4.9/§4.12: chunked list whose ranges can be *shared*
    (replicated) on all places, with an ``allreduce`` to reconcile
    per-replica contributions (the data-parallel gradient allreduce
    pattern)."""

    def __init__(self, group: PlaceGroup):
        super().__init__(group, track=True)
        self.shared_ranges: list[LongRange] = []

    def share(self, place: int, r: LongRange | None = None) -> None:
        """Teamed: the places owning ``r`` replicate it everywhere;
        places calling with ``r=None`` only receive."""
        if r is None:
            return
        rows = self.handle(place).chunks.get(r)
        if rows is None:
            rows = self.handle(place).extract(r)
            self.handle(place).add_chunk(r, rows)
        self.comm.syncs += 1
        self.comm.record(int(rows.nbytes) * (self.group.size() - 1),
                         messages=self.group.size() - 1)
        for p in self.group.members:
            if p == place:
                continue
            self.handle(p).add_chunk(r, rows.clone())
        self.shared_ranges.append(r)

    def allreduce(self, pack: Callable[[torch.Tensor], torch.Tensor],
                  unpack: Callable[[torch.Tensor, torch.Tensor],
                                   torch.Tensor],
                  op: str = "sum") -> None:
        """Elementwise allreduce over the replicated ranges. ``pack``
        maps rows → a lane tensor; ``unpack`` writes reduced lanes
        back."""
        self.comm.syncs += 1
        reducers = {"sum": lambda t: t.sum(0),
                    "max": lambda t: t.amax(0),
                    "min": lambda t: t.amin(0)}
        red = reducers[op]
        for r in self.shared_ranges:
            lanes = [_as_rows(pack(self.handle(p).chunks[r]), self.device)
                     for p in self.group.members]
            reduced = red(torch.stack(lanes, 0))
            self.comm.record(int(lanes[0].nbytes) * self.group.size(),
                             messages=self.group.size())
            for p in self.group.members:
                out = unpack(self.handle(p).chunks[r], reduced)
                if out is not None:
                    self.handle(p).chunks[r] = _as_rows(out, self.device)
