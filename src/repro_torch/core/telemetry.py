"""Unified runtime telemetry: spans, metrics, cross-rank aggregation.

The paper's promise is *adaptive* execution — but adaptation you cannot
see you cannot trust or tune.  Before this module the repo's telemetry
was fragmented: ``TransportStats`` counted wire bytes,
``GLBStats.overlap_fraction`` judged windows, ``AsyncRelocation.trace``
stamped host timestamps, and ``_CommStats`` tallied per-collection
bytes — four surfaces with no way to correlate a slow decode round with
the steal window and transport exchange that caused it.  Following the
DASH line of work (runtime introspection as a first-class library
layer), this module is the one place every subsystem reports to:

* **Spans and events** — a thread-safe ring-buffer :class:`Tracer`.
  ``with span("reloc.window"): ...`` records begin/end timestamps,
  process rank, a per-place-or-thread track, and key=value attributes;
  :func:`event` records instants.  Finished records are stored directly
  in Chrome trace-event form, so export and cross-rank merging are
  concatenation, not translation.

* **Metrics** — a :class:`MetricsRegistry` of counters, gauges, and
  streaming :class:`Histogram` s (fixed log-spaced HDR-style bins, so
  p50/p95/p99 come from O(1)-memory state with bounded relative
  error).  ``TransportStats``/``GLBStats`` publish into the registry
  via their ``as_dict``/``publish`` methods rather than growing more
  parallel bespoke structs.

* **Export + aggregation** — :func:`chrome_trace` /
  :func:`write_chrome_trace` dump a Perfetto-loadable timeline (one
  track per rank/place); :func:`allgather_spans` rides any process
  backend's allgather so every rank of a multi-process run holds one
  merged, rank-tagged timeline (``run_multiprocess(...,
  collect_trace=True)`` wires it in at shutdown).

Two hard requirements shape the implementation:

* **Zero-cost-when-disabled.**  The module-level ``_ENABLED`` flag is
  checked before *any* attribute formatting or record allocation;
  disabled ``span()`` returns the shared :data:`NULL_SPAN` singleton
  and ``event``/``observe``/``inc``/``gauge`` return immediately.
  Instrumented hot paths stay on by default in benchmarks.

* **Bounded memory.**  The span buffer is a fixed-capacity ring: when
  it wraps, the oldest records are overwritten and counted in
  ``Tracer.dropped`` — a long benchmark cannot OOM the tracer, and the
  drop counter makes truncation visible instead of silent.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any

__all__ = [
    "Tracer",
    "Span",
    "NULL_SPAN",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "enabled",
    "enable",
    "disable",
    "set_rank",
    "tracer",
    "metrics",
    "span",
    "event",
    "complete",
    "context",
    "inc",
    "gauge",
    "observe",
    "metrics_dict",
    "chrome_trace",
    "write_chrome_trace",
    "allgather_spans",
    "reset",
]

# the zero-cost gate: every recording entry point checks this module
# flag before touching attributes, locks, or the ring buffer
_ENABLED = False

# wall-clock anchor: perf_counter is monotonic but per-process; adding
# the anchor puts every rank's timestamps on the (roughly) shared
# wall clock so merged cross-rank timelines line up in Perfetto
_ANCHOR = time.time() - time.perf_counter()


def _now_us() -> float:
    return (_ANCHOR + time.perf_counter()) * 1e6


# thread-local span context: attributes attached to every span/event
# opened while the context is active (the window-id correlation the
# relocation pipeline uses to tie a transport exchange to its window)
_CTX = threading.local()


class _SpanContext:
    __slots__ = ("_attrs", "_prev")

    def __init__(self, attrs: dict):
        self._attrs = attrs
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_CTX, "attrs", None)
        merged = dict(self._prev) if self._prev else {}
        merged.update(self._attrs)
        _CTX.attrs = merged
        return self

    def __exit__(self, *exc):
        _CTX.attrs = self._prev
        return False


class _NullContext:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CONTEXT = _NullContext()


def context(**attrs):
    """Attach ``attrs`` to every span/event opened in this thread while
    the ``with`` block is active (e.g. ``context(window=7)`` inside a
    delivery thread tags the transport exchange with its relocation
    window).  No-op when disabled."""
    if not _ENABLED:
        return _NULL_CONTEXT
    return _SpanContext(attrs)


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------
class _NullSpan:
    """The disabled-mode singleton: falsy, context-manager-shaped, and
    attribute-setting is a no-op — so call sites can guard expensive
    attribute formatting with ``if sp:``."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One open span; records itself into its tracer on ``__exit__``."""

    __slots__ = ("_tracer", "name", "attrs", "t0", "t1")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.t1 = 0.0

    def __bool__(self):
        return True

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self.t0 = _now_us()
        return self

    def __exit__(self, etype, evalue, tb):
        self.t1 = _now_us()
        if etype is not None:
            self.attrs["error"] = etype.__name__
        self._tracer._record(self.name, "X", self.t0,
                             self.t1 - self.t0, self.attrs)
        return False


class Tracer:
    """Thread-safe fixed-capacity ring buffer of trace-event records.

    :meth:`records` returns Chrome trace-event form — ``{"name", "ph",
    "ts", "dur", "pid", "tid", "args"}`` with microsecond timestamps —
    so :func:`chrome_trace` is concatenation plus normalization and a
    cross-rank merge is an allgather of plain lists.  ``pid`` is the
    process rank (:func:`set_rank`); ``tid`` is the ``place=`` span
    attribute when given (one track per place) and a small per-thread
    ordinal otherwise.

    The *write* path stores one raw tuple per record and defers all
    dict assembly (context merging, track resolution) to read time:
    recording runs on live relocation/steal threads where every
    microsecond stretches the window critical path, while
    :meth:`records` runs once, after the measured region.
    """

    def __init__(self, capacity: int = 65536, rank: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.rank = int(rank)
        self.dropped = 0
        self._buf: list = [None] * self.capacity
        self._head = 0          # next write slot
        self._count = 0         # live records (<= capacity)
        self._lock = threading.Lock()
        self._tids: dict[int, int] = {}   # thread ident -> small ordinal
        # record listeners (the relocation sanitizer's event source):
        # called with the raw record tuple on the recording thread,
        # after the ring write, outside the ring lock
        self._listeners: list = []

    # -- recording ---------------------------------------------------------
    def span(self, name: str, **attrs):
        if not _ENABLED:
            return NULL_SPAN
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        if not _ENABLED:
            return
        self._record(name, "i", _now_us(), None, attrs)

    def complete(self, name: str, t0_us: float, t1_us: float,
                 **attrs) -> None:
        """Record an already-timed span (begin/end measured elsewhere —
        e.g. a relocation window whose phases ran on three threads)."""
        if not _ENABLED:
            return
        self._record(name, "X", t0_us, t1_us - t0_us, attrs)

    def _record(self, name, ph, ts, dur, attrs) -> None:
        # instrumented hot path: one tuple literal + direct lock
        # acquire/release (no context-manager dispatch, and the locked
        # region cannot raise).  Thread context (_CTX.attrs) and thread
        # identity are captured by reference/value; merging happens in
        # records()
        rec = (name, ph, ts, dur, getattr(_CTX, "attrs", None), attrs,
               self.rank, threading.get_ident())
        lock = self._lock
        lock.acquire()
        self._buf[self._head] = rec
        self._head = (self._head + 1) % self.capacity
        if self._count < self.capacity:
            self._count += 1
        else:
            self.dropped += 1   # overwrote the oldest record
        lock.release()
        if self._listeners:
            # outside the ring lock: a listener may read the tracer (or
            # record) without deadlocking; listeners must not raise —
            # _record runs inside Span.__exit__ on live window threads
            for fn in tuple(self._listeners):
                fn(rec)

    def add_listener(self, fn) -> None:
        """Register ``fn(record_tuple)`` to observe every record as it
        is written (idempotent).  Records arrive as the raw storage
        tuple ``(name, ph, ts, dur, ctx_attrs, attrs, rank, ident)`` on
        the recording thread; listeners must be fast and must not
        raise."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    # -- reading -----------------------------------------------------------
    def records(self) -> list[dict]:
        """Live records as Chrome trace-event dicts, oldest surviving
        first (chronological).  This is where the deferred work happens:
        context attrs merge under the span's own, and each record's
        track (``tid``) resolves to its ``place`` attr or a stable
        per-thread ordinal."""
        with self._lock:
            if self._count < self.capacity:
                raw = self._buf[:self._count]
            else:
                raw = self._buf[self._head:] + self._buf[:self._head]
        out = []
        for name, ph, ts, dur, ctx, attrs, rank, ident in raw:
            if ctx:
                attrs = {**ctx, **attrs} if attrs else dict(ctx)
            place = attrs.get("place") if attrs else None
            if place is None:
                tid = self._tids.get(ident)
                if tid is None:
                    # threads track from 1000: never collides with places
                    tid = 1000 + len(self._tids)
                    self._tids[ident] = tid
            else:
                tid = int(place)
            rec: dict[str, Any] = {"name": name, "ph": ph, "ts": ts,
                                   "pid": rank, "tid": tid}
            if dur is not None:
                rec["dur"] = dur
            if ph == "i":
                rec["s"] = "t"
            if attrs:
                rec["args"] = attrs
            out.append(rec)
        return out

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._head = 0
            self._count = 0
            self.dropped = 0


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------
class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, value=1) -> None:
        with self._lock:
            self.value += value

    def set(self, value) -> None:
        """Overwrite with an externally-accumulated total (the
        publisher path: ``TransportStats`` lifetime counters are merged
        under their own lock, then snapshotted here at read time)."""
        self.value = value


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, value) -> None:
        self.value = value


class Histogram:
    """Streaming percentile sketch over fixed log-spaced bins.

    HDR-histogram style: bucket ``i`` covers
    ``[LO * GROWTH**i, LO * GROWTH**(i+1))``, so memory is O(1) (one
    int per bin) and any percentile estimate carries at most
    ``GROWTH - 1`` (~5.5%) relative error — tightened at the tails by
    clamping into the exact observed ``[min, max]``.  Values at or
    below zero land in the first bin.  The recording hot path is one
    ``math.log`` plus an int increment under the lock.
    """

    LO = 1e-9
    GROWTH = 1.055
    NBUCKETS = 1100          # covers LO .. ~3.8e16 (seconds or bytes)
    _INV_LOG_GROWTH = 1.0 / math.log(GROWTH)

    __slots__ = ("counts", "count", "total", "vmin", "vmax", "_lock")

    def __init__(self):
        self.counts = [0] * self.NBUCKETS
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._lock = threading.Lock()

    def observe(self, value) -> None:
        # hot path: bucket index computed outside the lock, direct
        # acquire/release (the locked region cannot raise)
        v = float(value)
        if v <= self.LO:
            idx = 0
        else:
            idx = int(math.log(v / self.LO) * self._INV_LOG_GROWTH)
            if idx >= self.NBUCKETS:
                idx = self.NBUCKETS - 1
        lock = self._lock
        lock.acquire()
        self.counts[idx] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        lock.release()

    def percentile(self, p: float) -> float:
        with self._lock:
            if self.count == 0:
                return 0.0
            target = max(1, math.ceil(p / 100.0 * self.count))
            seen = 0
            for i, c in enumerate(self.counts):
                seen += c
                if seen >= target:
                    est = self.LO * self.GROWTH ** (i + 0.5)
                    return min(max(est, self.vmin), self.vmax)
            return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def as_dict(self, name: str) -> dict:
        if self.count == 0:
            return {f"{name}.count": 0}
        return {
            f"{name}.count": self.count,
            f"{name}.sum": self.total,
            f"{name}.mean": self.mean,
            f"{name}.min": self.vmin,
            f"{name}.max": self.vmax,
            f"{name}.p50": self.percentile(50),
            f"{name}.p95": self.percentile(95),
            f"{name}.p99": self.percentile(99),
        }


class MetricsRegistry:
    """Get-or-create registry of named counters, gauges, histograms.

    Names are dotted (``reloc.window_s``); :meth:`as_dict` flattens
    everything into one sorted ``{name: number}`` dict — the shape the
    benchmark JSON merges verbatim.

    Stat structs that already accumulate their own totals
    (``TransportStats.lifetime``, ``GLBStats``) register a *publisher*
    instead of pushing on every update: :meth:`add_publisher` stores a
    callback that :meth:`as_dict` invokes right before flattening, so
    the registry polls cumulative state at read time and the data-plane
    hot path pays one dict assignment, not a metric update per field."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._publishers: dict[Any, Any] = {}   # key -> fn(registry)
        self._lock = threading.Lock()

    def add_publisher(self, key, fn) -> None:
        """Register (idempotently, by ``key``) a callback invoked with
        this registry at every :meth:`as_dict` — re-registering under
        the same key replaces the callback, so per-exchange hot paths
        can call this unconditionally."""
        self._publishers[key] = fn

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram())
        return h

    def as_dict(self) -> dict:
        for fn in list(self._publishers.values()):
            fn(self)
        out: dict[str, Any] = {}
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        for name, c in counters.items():
            out[name] = c.value
        for name, g in gauges.items():
            out[name] = g.value
        for name, h in histograms.items():
            out.update(h.as_dict(name))
        return dict(sorted(out.items()))

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._publishers.clear()


# ---------------------------------------------------------------------------
# Module-level singletons + the convenience API every subsystem uses
# ---------------------------------------------------------------------------
_TRACER = Tracer()
_METRICS = MetricsRegistry()


def enabled() -> bool:
    return _ENABLED


def enable(*, rank: int | None = None,
           capacity: int | None = None) -> Tracer:
    """Turn recording on.  ``rank`` tags every subsequent record's
    ``pid`` (multi-process workers pass their backend rank);
    ``capacity`` resizes (and clears) the ring buffer."""
    global _ENABLED, _TRACER
    if capacity is not None and capacity != _TRACER.capacity:
        replacement = Tracer(capacity=capacity, rank=_TRACER.rank)
        # listeners (e.g. the relocation sanitizer) survive a resize
        replacement._listeners = list(_TRACER._listeners)
        _TRACER = replacement
    if rank is not None:
        _TRACER.rank = int(rank)
    _ENABLED = True
    return _TRACER


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def set_rank(rank: int) -> None:
    _TRACER.rank = int(rank)


def tracer() -> Tracer:
    return _TRACER


def metrics() -> MetricsRegistry:
    return _METRICS


def span(name: str, **attrs):
    """Open a span (``with span("reloc.window") as sp: ...``).  Returns
    the falsy :data:`NULL_SPAN` singleton when disabled, so guards like
    ``if sp: sp.set(bytes=...)`` skip attribute formatting entirely."""
    if not _ENABLED:
        return NULL_SPAN
    return Span(_TRACER, name, attrs)


def event(name: str, **attrs) -> None:
    if not _ENABLED:
        return
    _TRACER.event(name, **attrs)


def complete(name: str, t0_us: float, t1_us: float, **attrs) -> None:
    if not _ENABLED:
        return
    _TRACER.complete(name, t0_us, t1_us, **attrs)


def now_us() -> float:
    """The tracer's clock (wall-anchored microseconds) — for callers
    assembling :func:`complete` spans from their own stamps."""
    return _now_us()


def inc(name: str, value=1) -> None:
    if not _ENABLED:
        return
    _METRICS.counter(name).inc(value)


def gauge(name: str, value) -> None:
    if not _ENABLED:
        return
    _METRICS.gauge(name).set(value)


def observe(name: str, value) -> None:
    if not _ENABLED:
        return
    _METRICS.histogram(name).observe(value)


def metrics_dict() -> dict:
    """Flat snapshot of every registered metric (histograms expanded to
    ``.count/.sum/.mean/.min/.max/.p50/.p95/.p99``)."""
    return _METRICS.as_dict()


def reset() -> None:
    """Clear the span buffer and every metric (test/benchmark hygiene);
    leaves the enable flag untouched."""
    _TRACER.clear()
    _METRICS.clear()


# ---------------------------------------------------------------------------
# Export + cross-rank aggregation
# ---------------------------------------------------------------------------
def chrome_trace(records: list[dict] | None = None) -> dict:
    """Chrome trace-event JSON (the ``chrome://tracing`` / Perfetto
    format): ``{"traceEvents": [...]}`` with timestamps normalized to
    the earliest record.  ``records`` defaults to the live tracer
    buffer; pass a merged cross-rank list to get one timeline with one
    ``pid`` track per rank."""
    if records is None:
        records = _TRACER.records()
    t0 = min((r["ts"] for r in records), default=0.0)
    events = []
    for r in records:
        e = dict(r)
        e["ts"] = e["ts"] - t0
        events.append(e)
    meta = {"dropped_spans": _TRACER.dropped} if records else {}
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": meta}


def write_chrome_trace(path, records: list[dict] | None = None) -> dict:
    """Dump :func:`chrome_trace` to ``path`` (creating parent
    directories); returns the dict."""
    doc = chrome_trace(records)
    parent = os.path.dirname(os.fspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def allgather_spans(backend) -> list[dict]:
    """Merge every rank's tracer buffer into one rank-tagged timeline
    (each record's ``pid`` is the rank that produced it).  ``backend``
    is any object with an ``allgather`` collective — the
    ``PipeBackend``/``LocalBackend`` seam of ``core/distributed.py`` —
    so the merge rides the existing data plane at shutdown and every
    rank returns the same sorted list."""
    merged: list[dict] = []
    for part in backend.allgather(_TRACER.records()):
        if part is not None:   # dead ranks contribute nothing
            merged.extend(part)
    merged.sort(key=lambda r: r.get("ts", 0.0))
    return merged


def phase_breakdown(records: list[dict] | None = None) -> dict:
    """Aggregate complete spans by name: ``{name: {"spans", "total_us",
    "mean_us", "p95_us"}}`` — the per-phase table
    ``examples/trace_viewer.py`` prints (counts/pack vs exchange vs
    commit)."""
    if records is None:
        records = _TRACER.records()
    by_name: dict[str, list[float]] = {}
    for r in records:
        if r.get("ph") == "X":
            by_name.setdefault(r["name"], []).append(float(r["dur"]))
    out = {}
    for name, durs in sorted(by_name.items()):
        durs.sort()
        p95 = durs[min(len(durs) - 1, int(math.ceil(0.95 * len(durs))) - 1)]
        out[name] = {"spans": len(durs), "total_us": sum(durs),
                     "mean_us": sum(durs) / len(durs), "p95_us": p95}
    return out
