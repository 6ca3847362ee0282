"""Relocation windows of the PyTorch port against the JAX package.

The same multi-window scenario (range moves, count moves, key-rule
moves of dict-of-tensor pytree values and pickled tuples, admission-time
puts between windows, an eviction drain mid-chain) runs through

* the port's ``DeviceTransport`` on the ``fused`` backend (the kernels'
  plain versions on the CPU), on ``composite``, and its ``HostTransport``;
* the JAX package's ``DeviceTransport`` on ``xla`` and its
  ``HostTransport``;

and every run must leave bit-identical state: entry bytes, dtypes,
distributions, comm counters, the managers' counts matrices, and equal
``TransportStats``.  Tolerance: exact equality — every op here moves
bytes.
"""
import contextlib

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.kernels import ops as jops
from repro_torch.core.collections import _TORCH_DTYPES
from repro_torch.kernels import ops as tops

STAT_FIELDS = ("payloads", "local", "rows", "row_bytes", "wire_bytes",
               "pad_waste_bytes", "width", "exchanges")


@contextlib.contextmanager
def backends(torch_backend="auto", jax_backend="xla"):
    pt, pj = tops.get_backend(), jops.get_backend()
    tops.set_backend(torch_backend)
    jops.set_backend(jax_backend)
    try:
        yield
    finally:
        tops.set_backend(pt)
        jops.set_backend(pj)


# ---------------------------------------------------------------------------
# one scenario, two packages
# ---------------------------------------------------------------------------
def _leaf(x):
    """A value leaf as (dtype name, shape, bytes), whichever package."""
    if isinstance(x, torch.Tensor):
        return (_TORCH_DTYPES[x.dtype][1], tuple(x.shape),
                x.contiguous().view(torch.uint8).numpy().tobytes())
    a = np.asarray(x)
    return (a.dtype.name, tuple(a.shape), a.tobytes())


def _value(v):
    if isinstance(v, dict):
        return ("tree", tuple(sorted((k, _leaf(x)) for k, x in v.items())))
    if isinstance(v, tuple):
        return ("obj", v)
    return ("leaf", _leaf(v))


def _rows(rows):
    if isinstance(rows, torch.Tensor):
        return _leaf(rows)
    return _leaf(np.asarray(rows))


def snapshot(cols, mms):
    """Full observable state in package-neutral form."""
    snap = []
    for col in cols:
        dist = None
        if hasattr(col, "get_distribution") and getattr(col, "track", True):
            dist = [((r.start, r.end), o)
                    for r, o in col.get_distribution().items()]
        if hasattr(col, "to_local_matrix"):
            per_place = []
            for p in col.group.members:
                rows, idx = col.to_local_matrix(p)
                per_place.append(([(r.start, r.end) for r in col.ranges(p)],
                                  np.asarray(idx).tolist(),
                                  _rows(rows) if len(idx) else None))
        else:
            per_place = [[(k, _value(col.get(p, k)))
                          for k in sorted(col.keys(p))]
                         for p in col.group.members]
        snap.append((per_place, dist, col.comm.bytes_moved,
                     col.comm.messages))
    for mm in mms:
        st = mm.last_transport_stats
        snap.append((mm.syncs, mm.last_payload_bytes,
                     np.asarray(mm.last_counts_matrix).tolist(),
                     tuple(getattr(st, f) for f in STAT_FIELDS)))
    return snap


def drive_windows(pkg, transport, depth, *, n_rows=60, n_keys=12):
    """The multi-window scenario of the JAX package's transport tests,
    with dict-of-array values in place of its serving ``SeqKV`` and
    small tuples in place of its pickled ``Sequence`` metadata."""
    torch_side = pkg is T
    g = T.PlaceGroup(4, device="cpu") if torch_side else J.PlaceGroup(4)
    col = pkg.DistArray(g, track=True)
    col.add_chunk(0, pkg.LongRange(0, n_rows),
                  np.arange(2 * n_rows, dtype=np.float64).reshape(n_rows, 2))
    seqs, kv = pkg.DistIdMap(g), pkg.DistIdMap(g)
    for p in g.members:
        col.handle(p)
        seqs.handle(p)
        kv.handle(p)

    def admit(k, place):
        seqs.put(place, k, ("seq", k, 4 + k))
        page = np.full((2, 4), k, np.float32)
        pos = np.full((1, 1), k, np.int32)
        if torch_side:
            page, pos = torch.from_numpy(page), torch.from_numpy(pos)
        else:
            import jax
            page, pos = jax.device_put(page), jax.device_put(pos)
        kv.put(place, k, {"k": page, "v": page, "pos": pos})

    for k in range(n_keys):
        admit(k, 0)
    mm = pkg.CollectiveMoveManager(g, transport=transport)
    col.move_range_at_sync(pkg.LongRange(0, n_rows // 4), 1, mm)
    col.move_at_sync_count(0, n_rows // 6, 2, mm)
    rule1 = lambda k: k % 4  # noqa: E731
    seqs.move_at_sync(0, rule1, mm)
    kv.move_at_sync(0, rule1, mm)
    h1 = mm.sync_async(update_dists=(col, seqs, kv), depth=depth)
    if depth == 1:
        h1.finish()
    for k in range(n_keys, n_keys + 4):
        admit(k, 3)
    h1.wait_delivered()
    mm.register_drain(col, 3, (0, 1, 2))
    mm.register_drain(seqs, 3, (0, 1, 2))
    mm.register_drain(kv, 3, (0, 1, 2))
    h2 = mm.sync_async(update_dists=(col, seqs, kv), depth=depth)
    if depth == 1:
        h2.finish()
    rule3 = lambda k: (k * 7) % 3  # noqa: E731
    seqs.move_at_sync(1, rule3, mm)
    kv.move_at_sync(1, rule3, mm)
    col.move_at_sync_count(2, 5, 1, mm)
    mm.sync_async(update_dists=(col, seqs, kv), depth=depth)
    mm.drain()
    assert col.global_size() == n_rows
    assert seqs.global_size() == n_keys + 4 == kv.global_size()
    if torch_side:
        for p in g.members:
            for k in kv.keys(p):
                v = kv.get(p, k)
                assert v["k"] is v["v"]     # the alias was rebound
    return snapshot((col, seqs, kv), (mm,)), mm.transport.lifetime


class TestWindowChainParity:
    @pytest.mark.parametrize("depth", [1, 2])
    def test_port_equals_reference(self, depth):
        runs = {}
        with backends("fused"):
            runs["torch fused"] = drive_windows(T, "device", depth)
        with backends("composite"):
            runs["torch composite"] = drive_windows(T, "device", depth)
        runs["torch host"] = drive_windows(T, "host", depth)
        with backends(jax_backend="xla"):
            runs["jax xla"] = drive_windows(J, "device", depth)
        runs["jax host"] = drive_windows(J, "host", depth)

        want = runs["jax host"][0]
        for name, (snap, _) in runs.items():
            states = [s[:-1] if isinstance(s[0], int) else s for s in snap]
            ref = [s[:-1] if isinstance(s[0], int) else s for s in want]
            assert states == ref, name
        # wire accounting: both device paths of the port == JAX xla
        dev = [runs[k] for k in ("torch fused", "torch composite",
                                 "jax xla")]
        for (snap, life) in dev[:2]:
            assert snap[-1] == dev[2][0][-1]
            for f in STAT_FIELDS:
                assert getattr(life, f) == getattr(dev[2][1], f), f
        assert runs["torch fused"][1].codec_backend == "fused"
        assert runs["torch composite"][1].codec_backend == "composite"

    def test_auto_resolves_to_composite_on_cpu(self):
        with backends("auto"):
            _, life = drive_windows(T, "device", 1)
        assert life.codec_backend == "composite"


def _chunk_run(pkg, dtype, transport="device"):
    torch_side = pkg is T
    g = T.PlaceGroup(3, device="cpu") if torch_side else J.PlaceGroup(3)
    col = pkg.DistArray(g, track=True)
    col.add_chunk(0, pkg.LongRange(0, 9),
                  np.arange(27).reshape(9, 3).astype(dtype))
    for p in g.members:
        col.handle(p)
    mm = pkg.CollectiveMoveManager(g, transport=transport)
    col.move_range_at_sync(pkg.LongRange(0, 4), 1, mm)
    col.move_at_sync_count(0, 2, 2, mm)
    mm.sync()
    return snapshot((col,), (mm,))


class TestChunkMoves:
    @pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float64,
                                       np.int64, np.uint8])
    def test_chunk_moves_across_dtypes(self, dtype):
        # float64/int64 take the typed kernel path in the port and the
        # byte path in the reference: bytes and stats must not differ
        with backends(jax_backend="xla"):
            want = _chunk_run(J, dtype)
        for be in ("fused", "composite"):
            with backends(be):
                assert _chunk_run(T, dtype) == want, be

    def test_fan_in_overflow(self):
        # every place ships to place 0: the composite capacity must be
        # sized by fan-in, the fused path has per-pair slots
        def run(pkg):
            torch_side = pkg is T
            g = T.PlaceGroup(4, device="cpu") if torch_side \
                else J.PlaceGroup(4)
            col = pkg.DistArray(g, track=True)
            for p in range(4):
                col.add_chunk(p, pkg.LongRange(10 * p, 10 * p + 10),
                              np.arange(10 * p, 10 * p + 10,
                                        dtype=np.float32)[:, None]
                              * np.ones((1, 3), np.float32))
            mm = pkg.CollectiveMoveManager(g, transport="device")
            for p in (1, 2, 3):
                col.move_at_sync_count(p, 9, 0, mm)
            mm.sync()
            assert col.local_size(0) == 37
            return snapshot((col,), (mm,))

        with backends(jax_backend="xla"):
            want = run(J)
        for be in ("fused", "composite"):
            with backends(be):
                assert run(T) == want, be

    def test_width_classes_exchange_separately(self):
        def run(pkg):
            torch_side = pkg is T
            g = T.PlaceGroup(2, device="cpu") if torch_side \
                else J.PlaceGroup(2)
            small, big = pkg.DistIdMap(g), pkg.DistIdMap(g)
            for p in g.members:
                small.handle(p)
                big.handle(p)
            for k in range(3):
                small.put(0, k, np.full(2, k, np.float32))
                page = np.full((8, 4), k, np.float32)
                big.put(0, k, {"page": torch.from_numpy(page)
                               if torch_side else page})
            mm = pkg.CollectiveMoveManager(g, transport="device")
            small.move_at_sync(0, lambda k: 1, mm)
            big.move_at_sync(0, lambda k: 1, mm)
            mm.sync()
            st = mm.last_transport_stats
            assert st.exchanges == 2 and st.width == 128
            return snapshot((small, big), (mm,))

        with backends(jax_backend="xla"):
            want = run(J)
        for be in ("fused", "composite"):
            with backends(be):
                assert run(T) == want, be

    def test_self_moves_bypass_the_wire(self):
        g = T.PlaceGroup(2, device="cpu")
        m = T.DistIdMap(g)
        for p in g.members:
            m.handle(p)
        for k in range(4):
            m.put(0, k, torch.full((3,), float(k)))
        for be in ("fused", "composite"):
            with backends(be):
                mm = T.CollectiveMoveManager(g, transport="device")
                m.move_at_sync(0, lambda k: 0 if k < 3 else 1, mm)
                mm.sync()
                st = mm.last_transport_stats
                assert st.rows == 1 and st.local == 0
                assert int(mm.last_counts_matrix.sum()) \
                    == mm.last_payload_bytes
                # move it back for the next backend
                mm2 = T.CollectiveMoveManager(g)
                m.move_at_sync(1, lambda k: 0, mm2)
                mm2.sync()
        assert sorted(m.keys(0)) == [0, 1, 2, 3]


class TestTransportSurface:
    def test_distributed_transport_not_ported_yet(self):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.make_transport("distributed")
        with pytest.raises(ValueError):
            T.make_transport("tcp")
        with pytest.raises(TypeError):
            T.make_transport(T.HostTransport)

    def test_stats_merge(self):
        a = T.TransportStats(kind="device", rows=2, width=64,
                             codec_backend="fused")
        b = T.TransportStats(kind="device", rows=3, width=32)
        a.merge(b)
        assert a.rows == 5 and a.width == 64 and a.codec_backend == "fused"
        assert set(J.TransportStats().as_dict()) \
            == set(T.TransportStats().as_dict())

    def test_phase1_rollback_conserves_entries(self):
        g = T.PlaceGroup(2, device="cpu")
        col = T.DistArray(g, track=True)
        col.add_chunk(0, T.LongRange(0, 10), torch.arange(10.0))
        mm = T.CollectiveMoveManager(g, transport="device")
        col.move_range_at_sync(T.LongRange(0, 4), 1, mm)
        col.move_at_sync_count(0, 50, 1, mm)      # more than held
        with pytest.raises(ValueError):
            mm.sync()
        assert col.global_size() == 10 and col.local_size(0) == 10

    def test_sanitized_windows_pass_invariants(self):
        from repro_torch.analysis import sanitizer as san

        prev = san._CODEC_SAMPLE_EVERY
        san._CODEC_SAMPLE_EVERY = 1
        try:
            with backends("fused"):
                g = T.PlaceGroup(3, device="cpu")
                col = T.DistArray(g, track=True)
                col.add_chunk(0, T.LongRange(0, 12),
                              torch.arange(24.0).reshape(12, 2))
                mm = T.CollectiveMoveManager(g, transport="device",
                                             sanitize=True)
                col.move_at_sync_count(0, 5, 1, mm)
                h = mm.sync_async(depth=2)
                with pytest.raises(san.RelocationRaceError):
                    col.set(0, 11, torch.zeros(2))
                h.finish()
                col.set(0, 11, torch.zeros(2))     # window landed: fine
        finally:
            san._CODEC_SAMPLE_EVERY = prev
            san.disable()
            T.telemetry.disable()
