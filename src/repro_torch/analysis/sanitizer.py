"""Runtime sanitizer for the relocation window data plane (in-process).

The PyTorch port of the in-process hooks of ``repro.analysis.sanitizer``,
all opt-in (``REPRO_SANITIZE=1`` in the environment, or ``sanitize=True``
on ``CollectiveMoveManager`` / ``GLBConfig``), all off the hot path when
disabled (one module attribute test per instrumented operation):

* **Race detector** — lockset + happens-before over DistCollection
  mutations versus in-flight window phases.  Window phases come from
  the telemetry span stream (``reloc.submit`` → ``reloc.phase1`` →
  ``reloc.deliver`` → ``reloc.commit``, correlated by the ``window``
  context attribute).  Between a window's submission and its delivery,
  a structural mutation of a participating collection must hold that
  collection's ``_lock``; anything else is reported *at the mutation
  site* with the collection, operation, and window phase named.

* **Transport invariant assertions** — per window: the §5.3 accounting
  identity (delivered off-place bytes == the counts-matrix column sum
  of the local places), a zero diagonal on the counts matrix, and a
  codec round-trip spot check on one sampled payload row
  (``decode(encode(p))`` re-encodes to identical bytes), so codec drift
  is caught even on transports that never encode (host loopback).

The multi-process SPMD contract checker belongs with the cross-process
data plane and is not part of this module.

This module keeps zero module-level imports from ``repro_torch.core``
so any core module may import it at module scope without a cycle.
"""
from __future__ import annotations

import os
import threading

__all__ = [
    "SanitizerError",
    "RelocationRaceError",
    "TransportInvariantError",
    "active",
    "enable",
    "disable",
    "check_mutation",
    "check_commit_invariants",
    "check_codec_roundtrip",
    "window_report",
]


class SanitizerError(RuntimeError):
    """Base class: an invariant of the window data plane was violated."""


class RelocationRaceError(SanitizerError):
    """Unlocked mutation of a collection with an in-flight window."""


class TransportInvariantError(SanitizerError):
    """§5.3 accounting identity or codec round-trip failed."""


# ---------------------------------------------------------------------------
# global switch
# ---------------------------------------------------------------------------
# instrumented hot paths test this attribute directly
# (``if _san._ACTIVE: _san.check_mutation(...)``)
_ACTIVE = False

_ENV_FLAG = os.environ.get("REPRO_SANITIZE", "").strip().lower() \
    in ("1", "true", "yes", "on")

_LOCK = threading.Lock()

# window_id -> {"phase": str, "gids": frozenset[int]}
_WINDOWS: dict[int, dict] = {}
# collection global_id -> set of in-flight window ids covering it
_BY_COL: dict[int, set] = {}
# advisory: non-raising findings — tests and reports read this
_REPORTS: list[str] = []


def active() -> bool:
    """Is the sanitizer on?  ``REPRO_SANITIZE=1`` enables it lazily on
    the first data-plane construction that asks."""
    if _ACTIVE:
        return True
    if _ENV_FLAG:
        enable()
        return True
    return False


def enable(*, rank: int | None = None) -> None:
    """Turn every checker on.  Forces telemetry on (the window-phase
    event source is the span stream) and registers the span listener."""
    global _ACTIVE
    from ..core import telemetry

    with _LOCK:
        telemetry.enable(rank=rank)
        telemetry.tracer().add_listener(_on_span_record)
        _ACTIVE = True


def disable() -> None:
    """Turn the sanitizer off and drop its window state.  Telemetry is
    left as-is (the caller may have enabled it independently)."""
    global _ACTIVE
    from ..core import telemetry

    with _LOCK:
        _ACTIVE = False
        telemetry.tracer().remove_listener(_on_span_record)
        _WINDOWS.clear()
        _BY_COL.clear()
        del _REPORTS[:]


def window_report() -> dict:
    """Diagnostic snapshot: in-flight windows, per-collection coverage,
    and advisory findings."""
    with _LOCK:
        return {
            "windows": {w: dict(st) for w, st in _WINDOWS.items()},
            "by_collection": {g: sorted(w) for g, w in _BY_COL.items()},
            "reports": list(_REPORTS),
        }


# ---------------------------------------------------------------------------
# window phase tracking — fed by the telemetry span stream
# ---------------------------------------------------------------------------
def _window_of(ctx, attrs):
    if attrs and "window" in attrs:
        return attrs["window"]
    if ctx and "window" in ctx:
        return ctx["window"]
    return None


def _on_span_record(rec) -> None:
    """Tracer listener (called on the recording thread, after the ring
    write).  Must never raise — race errors fire at mutation sites, not
    from inside a span's ``__exit__``."""
    try:
        name, _ph, _ts, _dur, ctx, attrs, _rank, _ident = rec
        if not name.startswith("reloc."):
            return
        w = _window_of(ctx, attrs)
        if w is None:
            return
        if name == "reloc.submit":
            gids = frozenset(attrs.get("gids", ()))
            with _LOCK:
                _WINDOWS[w] = {"phase": "phase1", "gids": gids}
                for g in gids:
                    _BY_COL.setdefault(g, set()).add(w)
        elif name == "reloc.phase1":
            with _LOCK:
                st = _WINDOWS.get(w)
                if st is not None:
                    if attrs and "error" in attrs:
                        # failed + rolled back: nothing in flight anymore
                        _close_window_locked(w)
                    else:
                        st["phase"] = "extracted"
        elif name == "reloc.deliver":
            # payloads have landed (insertions run under each
            # collection's lock) — collections leave the danger zone
            with _LOCK:
                st = _WINDOWS.get(w)
                if st is not None:
                    st["phase"] = "delivered"
                    for g in st["gids"]:
                        wins = _BY_COL.get(g)
                        if wins is not None:
                            wins.discard(w)
                            if not wins:
                                _BY_COL.pop(g, None)
        elif name == "reloc.commit":
            with _LOCK:
                _close_window_locked(w)
    except Exception:
        pass


def _close_window_locked(w) -> None:
    st = _WINDOWS.pop(w, None)
    if st is None:
        return
    for g in st["gids"]:
        wins = _BY_COL.get(g)
        if wins is not None:
            wins.discard(w)
            if not wins:
                _BY_COL.pop(g, None)


# ---------------------------------------------------------------------------
# race detector — mutation-site hook
# ---------------------------------------------------------------------------
def check_mutation(col, op: str, detail=None) -> None:
    """Called by ``core/collections.py`` mutators when the sanitizer is
    active.  Raises :class:`RelocationRaceError` when ``col`` has an
    in-flight window (submitted, not yet delivered) and the calling
    thread does not hold the collection lock."""
    wins = _BY_COL.get(col.global_id)
    if not wins:
        return
    is_owned = getattr(col._lock, "_is_owned", None)
    if is_owned is None or is_owned():
        return  # lockset: serialized against the window threads
    with _LOCK:
        live = [(w, _WINDOWS[w]["phase"]) for w in sorted(wins)
                if w in _WINDOWS]
    if not live:
        return
    w, phase = live[0]
    what = f"{op}({detail!r})" if detail is not None else f"{op}()"
    raise RelocationRaceError(
        f"unlocked mutation {what} of {type(col).__name__}"
        f"#{col.global_id} while relocation window {w} is in flight "
        f"(phase={phase}): between sync_async() and delivery, "
        "structural mutation must hold the collection's _lock — the "
        "window's background extraction/insertion threads serialize on "
        "it.  Take `with col._lock:` around the mutation, or finish() "
        "the window first.")


# ---------------------------------------------------------------------------
# transport invariant assertions
# ---------------------------------------------------------------------------
def check_commit_invariants(manager, counts, moved_bytes,
                            window_id) -> None:
    """§5.3 accounting: the diagonal never reaches the wire, and the
    delivered off-place bytes equal the counts destined to this rank's
    local places (== the whole matrix sum in-process)."""
    import numpy as np

    if counts is None:
        return
    counts = np.asarray(counts)
    diag = int(np.abs(np.diagonal(counts)).sum())
    if diag != 0:
        raise TransportInvariantError(
            f"window {window_id}: counts matrix has nonzero diagonal "
            f"({diag} bytes) — self-moves must never reach the wire "
            "accounting (core/relocation.py phase-1 contract)")
    group = manager.group
    place_index = {p: i for i, p in enumerate(group.members)}
    local_idx = [place_index[p] for p in group.local_places()]
    expected = int(counts[:, local_idx].sum())
    if int(moved_bytes) != expected:
        raise TransportInvariantError(
            f"window {window_id}: delivered off-place payload bytes "
            f"({int(moved_bytes)}) != counts destined to local places "
            f"({expected}) — the two §5.3 accounting surfaces "
            "(phase-1 counts matrix vs delivered payloads) must agree "
            "on every transport; a mismatch means a payload was "
            "dropped, duplicated, or re-measured differently at the "
            "destination")


def _rows_bytes(rows):
    """Row bytes of a codec's output, whatever holds them: one (m, w)
    tensor or array, or a list of 1-D rows (tensors or arrays)."""
    import numpy as np
    import torch

    def raw(r):
        if isinstance(r, torch.Tensor):
            return r.detach().contiguous().cpu().view(torch.uint8) \
                .numpy().tobytes()
        return np.asarray(r, np.uint8).tobytes()

    if isinstance(rows, (np.ndarray, torch.Tensor)):
        return [raw(rows)]
    return [raw(r) for r in rows]


def _sample_row_payload(payload, window_id):
    """A one-entry sub-payload of ``payload`` (row picked by window id)
    in the owning collection's own payload shape, or ``None`` when the
    shape is unknown/empty.  Keeps the spot check O(1 row) however
    large the window."""
    if isinstance(payload, tuple) and len(payload) == 2 \
            and hasattr(payload[0], "start"):       # DistArray: (range, rows)
        r, rows = payload
        n = len(rows)
        if n == 0:
            return None
        i = window_id % n
        return (type(r)(r.start + i, r.start + i + 1), rows[i:i + 1])
    if isinstance(payload, list):                   # bag items / map pairs
        if not payload:
            return None
        i = window_id % len(payload)
        return payload[i:i + 1]
    return None


# spot-check cadence: round-trip every Nth window (window ids are a
# global monotone counter, so this is deterministic and drift shows up
# within N windows).  Tests pin it to 1 to make every window checked.
_CODEC_SAMPLE_EVERY = 4


def check_codec_roundtrip(payloads, window_id) -> None:
    """Spot check: sample ONE row of ONE payload (both picked
    deterministically by window id) and round-trip it through the
    owning collection's row codec — ``encode → decode → encode`` must
    reproduce identical row bytes."""
    if not payloads or window_id % _CODEC_SAMPLE_EVERY:
        return
    col, src, dest, payload = payloads[window_id % len(payloads)]
    sample = _sample_row_payload(payload, window_id)
    if sample is None:
        return
    try:
        rows1, manifest1 = col.encode_rows(sample)
        decoded = col.decode_rows(rows1, manifest1)
        rows2, _manifest2 = col.encode_rows(decoded)
        b1, b2 = _rows_bytes(rows1), _rows_bytes(rows2)
    except SanitizerError:
        raise
    except Exception as e:
        raise TransportInvariantError(
            f"window {window_id}: codec round-trip raised for "
            f"{type(col).__name__}#{col.global_id} payload "
            f"{src}->{dest}: {type(e).__name__}: {e}") from e
    if b1 != b2:
        raise TransportInvariantError(
            f"window {window_id}: codec round-trip mismatch for "
            f"{type(col).__name__}#{col.global_id} payload "
            f"{src}->{dest}: decode(encode(p)) re-encodes to different "
            "bytes — the destination would reconstruct a different "
            "payload than the source shipped")
