"""Pluggable relocation transports — one data plane for every payload.

The §5.3 two-phase exchange has two halves: *what* moves (the payloads
``CollectiveMoveManager._phase1`` extracts from the collections) and
*how* it moves.  This module isolates the relocation engine from the
communication backend behind a thin transport interface:

* :class:`RelocationTransport` — the protocol.  ``exchange(group,
  counts, payloads)`` takes the phase-1 byte-count matrix plus the
  extracted ``(collection, src, dest, payload)`` tuples and returns the
  payloads *as the destination receives them*, with a per-window
  :class:`TransportStats`.

* :class:`HostTransport` — the in-process loopback: payloads pass
  through by reference.  Zero copies — the default.

* :class:`DeviceTransport` — the wire rides the group's device: each
  payload's rows are encoded into fixed-width byte rows by the owning
  collection's row codec, bucketed by row-width class, packed into a
  send buffer, exchanged over the place dimension, and decoded on the
  receiver into bit-identical payloads.  Two codec paths, picked once
  per window by ``kernels.ops.resolve_backend``:

  - *composite* — the prefix-invariant ``(n, S, W)`` buffer and
    ``spmd_glb._ship_hop``'s cumsum/searchsorted gathers, plain tensor
    ops;
  - *fused* — a per-(src, dest) slotted ``(n, n, Sp, W)`` buffer written
    by one ``encode_pack`` (homogeneous typed bucket) or ``pack_rows``
    (byte arena) kernel; the exchange is ``transpose(0, 1)`` of it and
    the receiver decodes its block in place (``decode_rows``).

Both backends produce bit-identical final collection state and equal
wire accounting.  A self-destined payload never reaches the wire on
either backend — the counts diagonal stays zero, keeping the two §5.3
accounting surfaces (``last_counts_matrix.sum() ==
last_payload_bytes``) in agreement.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Any, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from . import telemetry

__all__ = [
    "RelocationTransport",
    "TransportStats",
    "HostTransport",
    "DeviceTransport",
    "make_transport",
]


@dataclass
class TransportStats:
    """One relocation window's wire accounting, per transport."""

    kind: str = "host"
    payloads: int = 0        # payload tuples that crossed places
    local: int = 0           # self-destined payloads (never on the wire)
    rows: int = 0            # encoded rows exchanged (device path)
    row_bytes: int = 0       # unpadded payload bytes on the wire
    wire_bytes: int = 0      # valid rows × padded class width (row
    #                          padding included; the buffers' empty
    #                          capacity slots are not)
    pad_waste_bytes: int = 0  # wire_bytes minus unpadded payload bytes
    #                          actually shipped — the pow2 _width_class
    #                          padding overhead
    width: int = 0           # widest padded row-width class exchanged
    exchanges: int = 0       # exchanges (one per row-width class in the
    #                          window)
    codec_backend: str = ""  # resolved kernels.ops backend the window's
    #                          codec ran on ("fused", "composite"; "" =
    #                          no codec ran)

    def merge(self, other: "TransportStats") -> "TransportStats":
        """Accumulate ``other`` into self (lifetime totals from
        per-window stats; ``width`` is a high-water mark and
        ``codec_backend`` keeps the most recent window's value)."""
        self.payloads += other.payloads
        self.local += other.local
        self.rows += other.rows
        self.row_bytes += other.row_bytes
        self.wire_bytes += other.wire_bytes
        self.pad_waste_bytes += other.pad_waste_bytes
        self.exchanges += other.exchanges
        self.width = max(self.width, other.width)
        if other.codec_backend:
            self.codec_backend = other.codec_backend
        return self

    def as_dict(self, prefix: str = "") -> dict:
        """Flat ``{name: number}`` view (plus the ``codec_backend``
        string)."""
        return {
            f"{prefix}payloads": self.payloads,
            f"{prefix}local": self.local,
            f"{prefix}rows": self.rows,
            f"{prefix}row_bytes": self.row_bytes,
            f"{prefix}wire_bytes": self.wire_bytes,
            f"{prefix}pad_waste_bytes": self.pad_waste_bytes,
            f"{prefix}width": self.width,
            f"{prefix}exchanges": self.exchanges,
            f"{prefix}codec_backend": self.codec_backend,
        }

    def publish(self, registry=None) -> None:
        """Snapshot these stats into the metrics registry as
        ``transport.<kind>.*`` counters (and a ``width`` gauge).  Values
        are *set*, not incremented: this is meant for cumulative stats
        (a transport's ``lifetime``), polled by the registry at read
        time."""
        reg = registry if registry is not None else telemetry.metrics()
        names = _PUBLISH_NAMES.get(self.kind)
        if names is None:
            p = f"transport.{self.kind}."
            names = tuple(p + f for f in (
                "payloads", "local", "rows", "row_bytes", "wire_bytes",
                "pad_waste_bytes", "exchanges", "width"))
            _PUBLISH_NAMES[self.kind] = names
        reg.counter(names[0]).set(self.payloads)
        reg.counter(names[1]).set(self.local)
        reg.counter(names[2]).set(self.rows)
        reg.counter(names[3]).set(self.row_bytes)
        reg.counter(names[4]).set(self.wire_bytes)
        reg.counter(names[5]).set(self.pad_waste_bytes)
        reg.counter(names[6]).set(self.exchanges)
        reg.gauge(names[7]).set(self.width)


# metric-name tuples per transport kind, built once
_PUBLISH_NAMES: dict = {}


def _account_exchange(transport, stats: TransportStats, sp) -> None:
    """Shared post-exchange bookkeeping for every backend: fold the
    window stats into the transport's lifetime totals (under its lock),
    stamp the open ``transport.exchange`` span, register the lifetime
    stats as a registry publisher, and feed the wire histograms."""
    with transport._lifetime_lock:
        transport.lifetime.merge(stats)
    if sp:
        sp.set(payloads=stats.payloads, local=stats.local,
               rows=stats.rows, wire_bytes=stats.wire_bytes,
               width=stats.width, exchanges=stats.exchanges)
    if telemetry.enabled():
        telemetry.metrics().add_publisher(
            id(transport), transport.lifetime.publish)
        telemetry.observe("transport.exchange_wire_bytes",
                          stats.wire_bytes)
        telemetry.observe("transport.exchange_rows", stats.rows)


# per-collection-type capability probe for the codec donation fast path
_DONATE_OK: dict[type, bool] = {}


def _encode_rows(col, payload):
    """Call a collection's row codec, passing ``donate=True`` when the
    codec supports it: the transport packs the returned rows into the
    send buffer immediately and never mutates them, so a donating codec
    may hand back zero-copy views of the extracted chunk.  Probed once
    per collection type."""
    ok = _DONATE_OK.get(type(col))
    if ok is None:
        import inspect

        try:
            ok = "donate" in inspect.signature(col.encode_rows).parameters
        except (TypeError, ValueError):
            ok = False
        _DONATE_OK[type(col)] = ok
    if ok:
        return col.encode_rows(payload, donate=True)
    return col.encode_rows(payload)


@runtime_checkable
class RelocationTransport(Protocol):
    """How extracted payloads cross places (the Alltoallv back end).

    A transport may also declare ``device_plane = True`` to tell the
    GLB's device steal loop that rows should ride the loop's own
    exchange (``run_device_steal(ship_rows=True)``) instead of
    materializing by id."""

    device_plane: bool = False

    def exchange(self, group, counts: np.ndarray | None,
                 payloads: Sequence[tuple]) -> tuple[list, TransportStats]:
        """Ship phase-1 payloads; return them as delivered (same order
        as ``payloads`` — insertion order is part of determinism).
        ``counts`` is the window's phase-1 place×place *byte*-count
        matrix — informational for custom backends."""
        ...


class HostTransport:
    """The in-process loopback: the delivered payload *is* the
    extracted payload (object identity preserved)."""

    device_plane = False

    def __init__(self):
        self.lifetime = TransportStats(kind="host")
        self._lifetime_lock = threading.Lock()
        # per-instance exchange ordinal: the span's seq attribute
        self._seq = itertools.count()

    def exchange(self, group, counts, payloads):
        with telemetry.span("transport.exchange", kind="host",
                            seq=next(self._seq)) as sp:
            stats = TransportStats(kind="host")
            for _, src, dest, _ in payloads:
                if src == dest:
                    stats.local += 1
                else:
                    stats.payloads += 1
            _account_exchange(self, stats, sp)
        return list(payloads), stats


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def _to_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.ascontiguousarray(x, np.uint8)
    if not a.flags.writeable:       # e.g. a pickle's frombuffer view
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _concat_bytes(pieces, device) -> torch.Tensor:
    """1-D uint8 pieces (tensors or host arrays) → one tensor on
    ``device``; consecutive host pieces cross to the device in one
    copy."""
    out, host = [], []
    for p in pieces:
        if isinstance(p, torch.Tensor):
            if host:
                out.append(_to_device(np.concatenate(host), device))
                host = []
            out.append(p.reshape(-1).to(device))
        else:
            host.append(np.asarray(p, np.uint8).reshape(-1))
    if host:
        out.append(_to_device(np.concatenate(host), device))
    return out[0] if len(out) == 1 else torch.cat(out)


def _byte_mat(mat: torch.Tensor) -> torch.Tensor:
    """(m, k) typed matrix → (m, k*itemsize) uint8 view (zero-copy for
    a contiguous tensor)."""
    m = int(mat.shape[0])
    return mat.contiguous().view(torch.uint8).reshape(m, -1)


class DeviceTransport:
    """Payload rows ride exchanges over the place dimension on the
    group's device.

    A window's payloads are bucketed by *row-width class* (next power
    of two ≥ the payload's widest row, floored at ``pad_multiple``) and
    each class runs one exchange — so a window carrying both small
    metadata rows and KV pages pads neither to the other's width.

    Delivered payloads are *reconstructions* (bit-identical bytes, new
    objects): alias structure inside a payload is preserved by the
    codec, object identity across the wire is not.
    """

    device_plane = True

    def __init__(self, *, pad_multiple: int = 8):
        self.pad_multiple = int(pad_multiple)
        self.lifetime = TransportStats(kind="device")
        # one shared instance may serve many managers' background
        # delivery threads — the counter updates must not interleave
        self._lifetime_lock = threading.Lock()
        self._seq = itertools.count()

    def exchange(self, group, counts, payloads):
        with telemetry.span("transport.exchange", kind="device",
                            seq=next(self._seq)) as sp:
            return self._exchange(group, counts, payloads, sp)

    def _exchange(self, group, counts, payloads, sp):
        from ..kernels import ops

        n = group.size()
        device = group.device
        place_index = {p: i for i, p in enumerate(group.members)}
        # resolved once per window: the whole window's codec runs on one
        # backend, so fused and composite rows never mix in a bucket
        backend = ops.resolve_backend(device=device)
        fused = backend == "fused"
        stats = TransportStats(kind="device", codec_backend=backend)

        # encode off-place payloads; self-moves bypass the wire verbatim
        entries: dict[int, dict] = {}   # payload position -> wire entry
        for pos, (col, src, dest, payload) in enumerate(payloads):
            if src == dest:
                stats.local += 1
                continue
            base = {"pos": pos, "si": place_index[src],
                    "di": place_index[dest]}
            if fused:
                raw_fn = getattr(col, "encode_rows_raw", None)
                raw = raw_fn(payload) if raw_fn is not None else None
                if raw is not None:
                    # typed chunk matrix: the encode kernel views it as
                    # wire bytes in-kernel — no byte matrix is built
                    mat, manifest = raw
                    m = int(mat.shape[0])
                    nb = int(mat.shape[1]) * mat.element_size()
                    entries[pos] = dict(base, raw=mat, m=m, wmax=nb,
                                        nbytes=m * nb, manifest=manifest,
                                        dev=True)
                    stats.payloads += 1
                    stats.rows += m
                    stats.row_bytes += m * nb
                    continue
            rows, manifest = _encode_rows(col, payload)
            if isinstance(rows, (torch.Tensor, np.ndarray)) \
                    and rows.ndim == 2:
                # chunk payloads stay one (m, w) matrix end to end: the
                # pack is a single block copy, never m row assignments
                e = dict(base, mat=rows, m=int(rows.shape[0]),
                         wmax=int(rows.shape[1]),
                         nbytes=int(rows.shape[0]) * int(rows.shape[1]),
                         manifest=manifest,
                         dev=isinstance(rows, torch.Tensor))
            else:
                rows = list(rows)
                widths = [int(r.shape[0]) for r in rows]
                e = dict(base, rows=rows, widths=widths, m=len(rows),
                         wmax=max(widths, default=0),
                         nbytes=int(sum(widths)), manifest=manifest,
                         dev=any(isinstance(r, torch.Tensor)
                                 for r in rows))
            entries[pos] = e
            stats.payloads += 1
            stats.rows += e["m"]
            stats.row_bytes += e["nbytes"]

        delivered = list(payloads)
        # decode zero-row payloads directly (delivered objects are
        # reconstructions even when nothing crossed the wire); bucket
        # the rest by padded row-width class — one exchange per class
        buckets: dict[int, list[dict]] = {}
        for e in entries.values():
            if e["m"] == 0:
                col, src, dest, _ = payloads[e["pos"]]
                delivered[e["pos"]] = (col, src, dest,
                                       col.decode_rows([], e["manifest"]))
                continue
            buckets.setdefault(self._width_class(e["wmax"]), []).append(e)
        for W, bucket in sorted(buckets.items()):
            if fused:
                self._exchange_bucket_fused(n, W, bucket, payloads,
                                            delivered, stats, backend,
                                            device)
            else:
                self._exchange_bucket(n, W, bucket, payloads, delivered,
                                      stats, device)
        _account_exchange(self, stats, sp)
        return delivered, stats

    def _width_class(self, w: int) -> int:
        """Next power of two ≥ ``w`` (floored at ``pad_multiple``)."""
        w = max(int(w), self.pad_multiple)
        return 1 << (w - 1).bit_length()

    @staticmethod
    def _deliver(e, block, payloads, delivered) -> None:
        """Decode one entry's received block into ``delivered``; blocks
        of host rows (pickles, numpy values) cross to the host once."""
        if not e["dev"]:
            block = block.cpu().numpy()
        rows = block if ("mat" in e or "raw" in e) \
            else [block[i] for i in range(e["m"])]
        col, src, dest, _ = payloads[e["pos"]]
        delivered[e["pos"]] = (col, src, dest,
                               col.decode_rows(rows, e["manifest"]))

    # -- the composite window path ---------------------------------------
    def _exchange_bucket(self, n, W, bucket, payloads, delivered, stats,
                         device):
        """One prefix-invariant exchange over the entries of one
        row-width class (``_ship_hop`` over the place dimension)."""
        from .spmd_glb import _ship_hop

        per_src: list[list[dict]] = [[] for _ in range(n)]
        # each sender's prefix is grouped by destination (stable within
        # a destination: registration order) — the receive side then
        # reads contiguous blocks per (src, dest) pair
        for e in bucket:
            per_src[e["si"]].append(e)
        for si in range(n):
            per_src[si].sort(key=lambda e: e["di"])
        ship = np.zeros((n, n), np.int64)
        for e in bucket:
            ship[e["si"], e["di"]] += e["m"]
        # capacity covers BOTH sides of the exchange — the busiest
        # sender's outgoing total and the busiest receiver's incoming
        # total (the receive prefix lands in the same S slots; fan-in
        # past S would silently drop rows) — rounded to a power of two
        S = _pow2(max(ship.sum(axis=1).max(), ship.sum(axis=0).max(), 1))
        buf = self._pack(per_src, n, S, W, device)
        ship_t = torch.from_numpy(ship).to(device)
        gids = torch.zeros((n, S), dtype=torch.int32, device=device)
        recv, _, _ = _ship_hop(buf, gids, ship_t.sum(1), ship_t)
        stats.exchanges += 1
        stats.width = max(stats.width, W)
        wire = int(ship.sum()) * W
        stats.wire_bytes += wire
        stats.pad_waste_bytes += wire - sum(e["nbytes"] for e in bucket)

        # receive layout: shard d's prefix holds, for src 0..n-1, the
        # ship[src, d] rows that src packed for d, in src's order
        offsets = np.zeros(n, np.int64)
        for si in range(n):
            for e in per_src[si]:
                di, m = e["di"], e["m"]
                lo = int(offsets[di])
                offsets[di] += m
                self._deliver(e, recv[di, lo:lo + m], payloads, delivered)

    def _pack(self, per_src, n, S, W, device) -> torch.Tensor:
        """(n, S, W) uint8 send buffer under the prefix invariant.
        Chunk matrices land as one block copy each; ragged rows of one
        entry land as one block (host rows cross to the device in one
        copy)."""
        buf = torch.zeros((n, S, W), dtype=torch.uint8, device=device)
        for si in range(n):
            off = 0
            for e in per_src[si]:
                m = e["m"]
                if "mat" in e:
                    buf[si, off:off + m, :e["wmax"]] = \
                        _to_device(e["mat"], device)
                elif e["dev"]:
                    for j, (r, w) in enumerate(zip(e["rows"],
                                                   e["widths"])):
                        buf[si, off + j, :w] = _to_device(r, device)
                else:
                    blk = np.zeros((m, W), np.uint8)
                    for j, (r, w) in enumerate(zip(e["rows"],
                                                   e["widths"])):
                        blk[j, :w] = np.asarray(r, np.uint8)
                    buf[si, off:off + m] = _to_device(blk, device)
                off += m
        return buf

    # -- the fused-kernel window path --------------------------------------
    def _exchange_bucket_fused(self, n, W, bucket, payloads, delivered,
                               stats, backend, device):
        """One codec kernel + one exchange over the entries of one
        row-width class.

        The send buffer is slotted *per (src, dest) pair* — capacity is
        the pow2 of the busiest pair, every pair owns its own block —
        so encode → byte view → permute → pad is a single kernel, the
        exchange is a transpose (a view: block ``buf[s, d]`` is read by
        receiver ``d`` in place), receiver blocks are contiguous row
        runs, and fan-in can never overflow a shared prefix.  Delivered
        bytes are bit-identical to the composite path: entries pack in
        registration order within each pair, the order
        ``_exchange_bucket`` produces."""
        from ..kernels import ops

        ship = np.zeros((n, n), np.int64)
        for e in bucket:
            ship[e["si"], e["di"]] += e["m"]
        Sp = _pow2(int(ship.max()))
        pairs = n * n
        n_slots = pairs * Sp

        # slot assignment: each entry's rows land at [p0, p0+m) inside
        # its pair's block, accumulated in registration order
        fill = np.zeros((n, n), np.int64)
        for e in bucket:
            e["p0"] = int(fill[e["si"], e["di"]])
            fill[e["si"], e["di"]] += e["m"]

        wid_tab = torch.zeros(n_slots, dtype=torch.int32, device=device)
        raw_keys = {(e["raw"].dtype, int(e["raw"].shape[1]))
                    for e in bucket if "raw" in e}
        if len(raw_keys) == 1 and all("raw" in e for e in bucket):
            # homogeneous typed bucket (the chunk-steal hot path): one
            # encode+pack kernel straight off the chunk matrices
            idx_tab = torch.zeros(n_slots, dtype=torch.int32,
                                  device=device)
            mats, base = [], 0
            for e in bucket:
                s0 = (e["si"] * n + e["di"]) * Sp + e["p0"]
                m = e["m"]
                idx_tab[s0:s0 + m] = torch.arange(
                    base, base + m, dtype=torch.int32, device=device)
                wid_tab[s0:s0 + m] = e["wmax"]
                mats.append(e["raw"].to(device))
                base += m
            src = mats[0].contiguous() if len(mats) == 1 \
                else torch.cat(mats)
            buf = ops.reloc_encode_pack(src, idx_tab, wid_tab, pairs=pairs,
                                        slots=Sp, width=W, impl=backend)
        else:
            # mixed bucket: every entry contributes flat wire bytes to
            # one arena; a single pack kernel gathers them into slots
            off_tab = torch.zeros(n_slots, dtype=torch.int64,
                                  device=device)
            pieces, base = [], 0
            for e in bucket:
                s0 = (e["si"] * n + e["di"]) * Sp + e["p0"]
                m = e["m"]
                if "rows" in e:
                    widths = np.asarray(e["widths"], np.int64)
                    offs = base + np.concatenate(
                        [[0], np.cumsum(widths)[:-1]])
                    off_tab[s0:s0 + m] = torch.from_numpy(offs).to(device)
                    wid_tab[s0:s0 + m] = torch.from_numpy(
                        widths.astype(np.int32)).to(device)
                    pieces.extend(e["rows"])
                    base += int(widths.sum())
                    continue
                bm = e["mat"] if "mat" in e else _byte_mat(e["raw"])
                w = e["wmax"]
                off_tab[s0:s0 + m] = base + w * torch.arange(
                    m, dtype=torch.int64, device=device)
                wid_tab[s0:s0 + m] = w
                pieces.append(bm.reshape(-1))
                base += m * w
            # ≥ W trailing zeros past the last row's bytes
            pieces.append(np.zeros(W, np.uint8))
            arena = _concat_bytes(pieces, device)
            buf = ops.reloc_pack_rows(arena, off_tab, wid_tab, pairs=pairs,
                                      slots=Sp, width=W, impl=backend)

        # the exchange over the place dimension: recv[d, s] is exactly
        # the block s packed for d
        recv = buf.view(n, n, Sp, W).transpose(0, 1)
        stats.exchanges += 1
        stats.width = max(stats.width, W)
        wire = int(ship.sum()) * W
        stats.wire_bytes += wire
        stats.pad_waste_bytes += wire - sum(e["nbytes"] for e in bucket)

        for e in bucket:
            block = recv[e["di"], e["si"], e["p0"]:e["p0"] + e["m"]]
            self._deliver(e, block, payloads, delivered)


def make_transport(spec: Any) -> RelocationTransport:
    """``None``/``"host"`` → :class:`HostTransport`, ``"device"`` →
    :class:`DeviceTransport`; an instance passes through (shared across
    managers/windows)."""
    if spec is None or spec == "host":
        return HostTransport()
    if spec == "device":
        return DeviceTransport()
    if spec == "distributed":
        raise NotImplementedError(
            "the multi-process transport is not ported yet: "
            "core/distributed.py is a later slice (ROADMAP.md queue 1, "
            "'Cross-process code')")
    if isinstance(spec, str):
        raise ValueError(f"unknown transport {spec!r} "
                         "(expected 'host' or 'device')")
    # fail at config time, not on a background delivery thread: the
    # instance must implement the protocol (a bare class is rejected)
    if isinstance(spec, type) \
            or not callable(getattr(spec, "exchange", None)):
        raise TypeError(
            f"transport {spec!r} does not implement RelocationTransport "
            "(pass an instance with an exchange() method)")
    return spec
