#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's main path — relocatable collections moved by
``CollectiveMoveManager`` windows over the ``DeviceTransport``, and the
GLB device steal loop — on the card at the sizes below, and holds each
hand-written relocation-codec kernel against its plain PyTorch version:

* phase 0: build the kernels from ``src/repro_torch/kernels/csrc``;
* phase 1: each kernel at the main path's shapes over float32,
  bfloat16, int32, uint8 and float64 (width > row bytes, zero-width
  slots, out-of-range indices, the arena's last row), ``torch.equal``
  with its plain version, then timed with CUDA events beside its bound,
  its plain version and a one-call PyTorch yardstick;
* phase 2: three relocation windows over ``PlaceGroup(8)``: ``pts``
  (2^23 x 32 float32, all on place 0), ``ids`` (2^22 x 16 int64, block
  distributed), ``kv`` (4096 keys of ``{"k": page, "v": page, "pos"}``
  with ``k`` and ``v`` aliasing one 1 KiB page) and ``tags`` (4096
  pickled tuples); then the same scenario at 1/16 of the rows on the
  ``fused`` and ``composite`` backends, which must agree bit for bit;
* phase 3: ``GlobalLoadBalancer(device_loop=True)`` on a 2^20 x 32
  float32 hot shard over 8 places (codec rows through ``decode_rows``),
  held against the host ``steal_pass`` loop and the id-plane loop.

Every check raises on failure.  The output ends with the card's name and
power limit, a ``kernels`` JSON line, per-phase wall time and peak
memory, and, as the last line, ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``
(``--shift K`` divides every row count by 2^K; ``--out PATH`` writes a
JSON report).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
N_PLACES = 8
KEYS = 4096
PAGE = (16, 16)                    # float32: 1 KiB
SEED = 1234
DEV = "cuda"
DTYPES = ("float32", "bfloat16", "int32", "uint8", "float64")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class Phase:
    """Wall time and peak device memory of one phase."""

    def __init__(self, name, report):
        self.name, self.report = name, report

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.t0 = time.perf_counter()
        log(f"[phase] {self.name} ...")
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch
        torch.cuda.synchronize()
        rec = {"phase": self.name,
               "wall_s": time.perf_counter() - self.t0,
               "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        if exc_type is None:
            self.report["phases"].append(rec)
            log(f"[phase] {self.name} done in {rec['wall_s']:.2f} s, peak "
                f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB")
        return False


def cuda_ms(fn, reps=10, warm=2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` timed runs (CUDA
    events), after ``warm`` untimed runs."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        del out
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def torch_dtype(name):
    import torch
    return getattr(torch, name)


def rand_rows(gen, m, k, dtype):
    """Seeded random rows of any dtype (random bytes viewed as it; for
    floats, finite values only)."""
    import torch
    dt = torch_dtype(dtype) if isinstance(dtype, str) else dtype
    if dt.is_floating_point:
        return (torch.rand((m, k), generator=gen, device=DEV) * 2e3
                - 1e3).to(dt)
    nb = k * dt.itemsize
    u8 = torch.randint(0, 256, (m, nb), generator=gen, device=DEV,
                       dtype=torch.uint8)
    return u8.view(dt).reshape(m, k)


def bytes_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------
def encode_tables(n, Sp, blocks, m, nb, edge=True):
    """Slot tables of an encode window: ``blocks`` is a list of (src,
    dest, rows) pair blocks filled in order from row 0; plus edge slots
    (zero width, partial width, out-of-range and negative indices) in an
    empty pair block."""
    import torch
    n_slots = n * n * Sp
    idx = torch.zeros(n_slots, dtype=torch.int32, device=DEV)
    wid = torch.zeros(n_slots, dtype=torch.int32, device=DEV)
    base = 0
    for s, d, rows in blocks:
        s0 = (s * n + d) * Sp
        idx[s0:s0 + rows] = torch.arange(base, base + rows,
                                         dtype=torch.int32, device=DEV)
        wid[s0:s0 + rows] = nb
        base += rows
    if edge:
        s0 = (2 * n + 3) * Sp
        cases = [(m + 5, nb), (-3, nb), (m - 1, nb - 1), (0, 1), (1, 0),
                 (m * 4, nb // 2)]
        for j, (i, w) in enumerate(cases):
            idx[s0 + j], wid[s0 + j] = i, w
    return idx, wid


def phase_kernels(shift, report):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import reloc_codec as rc

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    n = N_PLACES
    out = {}

    # -- encode_pack at window 1's shape: 7 pair blocks of 2^20 rows of
    #    128 B (pts range moves off the hot place), Sp = 2^20, W = 128
    blk = 1 << (20 - shift)
    m = 7 * blk
    W = 128
    for dtype in DTYPES:
        k = W // torch_dtype(dtype).itemsize
        mat = rand_rows(gen, m, k, dtype)
        idx, wid = encode_tables(n, blk, [(0, d, blk) for d in range(1, 8)],
                                 m, W)
        got = rc.encode_pack(mat, idx, wid, pairs=n * n, slots=blk, width=W)
        want = ref.reloc_encode_pack_ref(mat, idx, wid, pairs=n * n,
                                         slots=blk, width=W)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"encode_pack {dtype} != plain")
        del got, want
        if dtype == "float32":
            live = int(wid.clamp(0, W).to(torch.int64).sum())
            nbytes = live + idx.nbytes + wid.nbytes + n * n * blk * W
            idx_l = idx.to(torch.int64).clamp(0, m - 1)
            u8 = mat.view(torch.uint8)
            out["reloc_encode_pack"] = {
                "shape": f"mat ({m}, {k}) float32, pairs {n * n}, slots "
                         f"{blk}, width {W}",
                "ms": cuda_ms(lambda: rc.encode_pack(
                    mat, idx, wid, pairs=n * n, slots=blk, width=W)),
                "plain_ms": cuda_ms(lambda: ref.reloc_encode_pack_ref(
                    mat, idx, wid, pairs=n * n, slots=blk, width=W)),
                "library_ms": cuda_ms(
                    lambda: torch.index_select(u8, 0, idx_l)),
                "library_call": "torch.index_select(mat_bytes, 0, idx)",
                "bound_ms": bound_ms(nbytes), "bytes": nbytes}
            del idx_l, u8
        del mat, idx, wid
        torch.cuda.empty_cache()
    # width > row bytes (odd byte counts included), smaller shape
    for dtype, k in (("float32", 30), ("bfloat16", 63), ("int32", 30),
                     ("uint8", 127), ("float64", 15), ("uint8", 5)):
        mb = 1 << (16 - min(shift, 8))
        mat = rand_rows(gen, mb, k, dtype)
        nb = k * mat.element_size()
        Wn = max(8, 1 << (nb - 1).bit_length())
        S = 1 << 9
        idx, wid = encode_tables(n, S, [(1, 2, S), (4, 0, S // 2)], mb, nb)
        got = rc.encode_pack(mat, idx, wid, pairs=n * n, slots=S, width=Wn)
        want = ref.reloc_encode_pack_ref(mat, idx, wid, pairs=n * n,
                                         slots=S, width=Wn)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"encode_pack {dtype} k={k} != plain")

    # -- pack_rows at window 2's 128 B bucket: per place 2^18 pts rows +
    #    2^17 ids rows to its successor, Sp = 2^19; plus ragged map rows
    #    at unaligned offsets, the arena's last row, reads past its end
    pts_rows, ids_rows = 1 << (18 - shift), 1 << (17 - shift)
    per_pair = pts_rows + ids_rows
    Sp = 1 << (per_pair - 1).bit_length()
    A_rows = n * per_pair * W
    ragged = [int(x) for x in torch.randint(
        1, W + 1, (4096,), generator=torch.Generator().manual_seed(SEED))]
    A = A_rows + sum(ragged) + W
    arena = torch.randint(0, 256, (A,), generator=gen, device=DEV,
                          dtype=torch.uint8)
    arena[-W:] = 0
    n_slots = n * n * Sp
    off = torch.zeros(n_slots, dtype=torch.int64, device=DEV)
    wid = torch.zeros(n_slots, dtype=torch.int32, device=DEV)
    for p in range(n):
        s0 = (p * n + (p + 1) % n) * Sp
        off[s0:s0 + per_pair] = p * per_pair * W + W * torch.arange(
            per_pair, dtype=torch.int64, device=DEV)
        wid[s0:s0 + per_pair] = W
    s0 = (0 * n + 2) * Sp                          # the ragged rows
    roff = A_rows + torch.tensor([0] + ragged[:-1]).cumsum(0)
    off[s0:s0 + len(ragged)] = roff.to(DEV)
    wid[s0:s0 + len(ragged)] = torch.tensor(ragged, dtype=torch.int32)
    s0 = (3 * n + 5) * Sp                          # edge slots
    for j, (o, w) in enumerate([(A - W, W), (A - 3, W), (-7, W), (5, 0),
                                (A_rows - 1, 17)]):
        off[s0 + j], wid[s0 + j] = o, w
    got = rc.pack_rows(arena, off, wid, pairs=n * n, slots=Sp, width=W)
    want = ref.reloc_pack_rows_ref(arena, off, wid, pairs=n * n, slots=Sp,
                                   width=W)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "pack_rows != plain")
    del got, want
    live = int(wid.to(torch.int64).sum())
    nbytes = live + off.nbytes + wid.nbytes + n_slots * W
    out["reloc_pack_rows"] = {
        "shape": f"arena {A} B, pairs {n * n}, slots {Sp}, width {W}",
        "ms": cuda_ms(lambda: rc.pack_rows(arena, off, wid, pairs=n * n,
                                           slots=Sp, width=W)),
        "plain_ms": cuda_ms(lambda: ref.reloc_pack_rows_ref(
            arena, off, wid, pairs=n * n, slots=Sp, width=W)),
        "library_ms": None, "library_call": None,
        "bound_ms": bound_ms(nbytes), "bytes": nbytes}
    del arena, off, wid
    torch.cuda.empty_cache()
    # narrow width class (byte path) with ragged rows
    ar = torch.randint(0, 256, (4096 + 8,), generator=gen, device=DEV,
                       dtype=torch.uint8)
    o8 = torch.randint(-4, 4100, (2 * 2 * 256,), generator=gen,
                       device=DEV)
    w8 = torch.randint(0, 9, (2 * 2 * 256,), generator=gen, device=DEV,
                       dtype=torch.int32)
    require(torch.equal(
        rc.pack_rows(ar, o8, w8, pairs=4, slots=256, width=8),
        ref.reloc_pack_rows_ref(ar, o8, w8, pairs=4, slots=256, width=8)),
        "pack_rows width 8 != plain")

    # -- decode_rows at a window-1 receive block: 2^20 rows of 128 B, a
    #    slice of the transposed per-pair send buffer
    md = 1 << (20 - shift)
    buf = torch.randint(0, 256, (2, 2, md, W), generator=gen, device=DEV,
                        dtype=torch.uint8)
    block = buf.transpose(0, 1)[1, 0]
    for dtype in DTYPES:
        dt = torch_dtype(dtype)
        got = rc.decode_rows(block, nbytes=W, dtype=dt)
        want = ref.reloc_decode_rows_ref(block, nbytes=W, dtype=dt)
        torch.cuda.synchronize()
        require(bytes_equal(got, want), f"decode_rows {dtype} != plain")
        if dtype == "float32":
            nbytes = 2 * md * W
            out["reloc_decode_rows"] = {
                "shape": f"rows ({md}, {W}) uint8 -> ({md}, 32) float32",
                "ms": cuda_ms(lambda: rc.decode_rows(block, nbytes=W,
                                                     dtype=dt)),
                "plain_ms": cuda_ms(lambda: ref.reloc_decode_rows_ref(
                    block, nbytes=W, dtype=dt)),
                "library_ms": cuda_ms(lambda: block[:, :W].clone()),
                "library_call": "rows[:, :nbytes].clone()",
                "bound_ms": bound_ms(nbytes), "bytes": nbytes}
    # a row stride wider than the row, odd byte counts
    wide = torch.randint(0, 256, (4101, 256), generator=gen, device=DEV,
                         dtype=torch.uint8)[5:]
    for dtype, nb in (("float32", 120), ("bfloat16", 126), ("uint8", 127),
                      ("float64", 128), ("int32", 4)):
        dt = torch_dtype(dtype)
        require(bytes_equal(
            rc.decode_rows(wide, nbytes=nb, dtype=dt),
            ref.reloc_decode_rows_ref(wide, nbytes=nb, dtype=dt)),
            f"decode_rows strided {dtype} != plain")
    del buf, block, wide
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    report["kernel_times"] = out
    return out


# ---------------------------------------------------------------------------
# phase 2: relocation windows
# ---------------------------------------------------------------------------
def array_checksum(col) -> int:
    """Order-free checksum of a DistArray: row bytes keyed by global
    index (int64 arithmetic wraps the same way on every run)."""
    import torch
    total = 0
    for p in col.group.members:
        h = col.handle(p)
        for r in h.ranges():
            rows = h.chunks[r]
            words = rows.contiguous().view(torch.int32).reshape(r.size, -1)
            cw = torch.arange(1, words.shape[1] + 1, device=rows.device,
                              dtype=torch.int64) * 2654435761
            sig = (words.to(torch.int64) * cw).sum(1)
            gi = torch.arange(r.start, r.end, device=rows.device,
                              dtype=torch.int64) * 2 + 1
            total += int((sig * gi).sum())
    return total % (1 << 64)


def build_collections(g, shift, gen):
    import torch
    from repro_torch.core import DistArray, DistIdMap, LongRange

    n_pts, n_ids = 1 << (23 - shift), 1 << (22 - shift)
    pts = DistArray(g, track=True)
    ids = DistArray(g, track=True)
    kv, tags = DistIdMap(g), DistIdMap(g)
    for p in g.members:
        for c in (pts, ids, kv, tags):
            c.handle(p)
    pts.add_chunk(0, LongRange(0, n_pts), rand_rows(gen, n_pts, 32,
                                                    "float32"))
    id_rows = rand_rows(gen, n_ids, 16, "int64")
    for p, r in enumerate(LongRange(0, n_ids).split(N_PLACES)):
        ids.add_chunk(p, r, id_rows[r.start:r.end])
    pages = torch.rand((KEYS,) + PAGE, generator=gen, device=DEV)
    for k in range(KEYS):
        pos = torch.full((1, 1), k, dtype=torch.int32, device=DEV)
        page = pages[k]                  # one object: k and v alias it
        kv.put(0, k, {"k": page, "v": page, "pos": pos})
        tags.put(0, k, ("tag", k, k % 7))
    return pts, ids, kv, tags, pages


def run_windows(shift, seed=SEED):
    """The three-window scenario; returns the collections, the per-window
    TransportStats and the reference pages."""
    import torch
    from repro_torch.core import CollectiveMoveManager, LongRange, PlaceGroup

    gen = torch.Generator(device=DEV).manual_seed(seed)
    g = PlaceGroup(N_PLACES, device=DEV)
    pts, ids, kv, tags, pages = build_collections(g, shift, gen)
    n_pts, n_ids = 1 << (23 - shift), 1 << (22 - shift)
    every = (pts, ids, kv, tags)
    mm = CollectiveMoveManager(g, transport="device")
    # window 1 (depth 1): spread the hot shard — range moves, one
    # homogeneous 128 B bucket (encode_pack)
    for i, r in enumerate(LongRange(0, n_pts).split(N_PLACES)):
        if i:
            pts.move_range_at_sync(r, i, mm)
    h1 = mm.sync_async(update_dists=every, depth=1)
    h1.finish()
    # window 2 (depth 2): count moves of pts and ids (two dtypes in one
    # 128 B class) + key-rule moves of kv (tree codec) and tags (pickle)
    # — mixed buckets (pack_rows)
    for p in g.members:
        pts.move_at_sync_count(p, n_pts // 32, (p + 1) % N_PLACES, mm)
        ids.move_at_sync_count(p, n_ids // 32, (p + 1) % N_PLACES, mm)
    kv.move_at_sync(0, lambda k: k % N_PLACES, mm)
    tags.move_at_sync(0, lambda k: k % N_PLACES, mm)
    h2 = mm.sync_async(update_dists=every, depth=2)
    h2.enqueue()
    # window 3 registers while window 2 delivers: the evicted place's
    # keys are enumerated at extraction, which waits for window 2
    kv.move_at_sync(N_PLACES - 1, lambda k: k % (N_PLACES - 1), mm)
    tags.move_at_sync(N_PLACES - 1, lambda k: k % (N_PLACES - 1), mm)
    h2.wait_delivered()
    survivors = tuple(range(N_PLACES - 1))
    mm.register_drain(pts, N_PLACES - 1, survivors)
    mm.register_drain(ids, N_PLACES - 1, survivors)
    h3 = mm.sync_async(update_dists=every, depth=2)
    mm.drain()
    stats = [h.transport_stats for h in (h1, h2, h3)]
    return (pts, ids, kv, tags), stats, pages


STAT_KEYS = ("rows", "wire_bytes", "pad_waste_bytes", "exchanges",
             "payloads", "local", "width", "row_bytes")


def check_maps(kv, tags, pages):
    import torch
    keys, vals_k, vals_v, poss = [], [], [], []
    for p in kv.group.members:
        for k in kv.keys(p):
            v = kv.get(p, k)
            require(v["k"] is v["v"], "kv alias not rebound")
            keys.append(k)
            vals_k.append(v["k"])
            poss.append(v["pos"])
    require(sorted(keys) == list(range(KEYS)), "kv keys lost")
    order = torch.tensor(keys, device=DEV)
    require(torch.equal(torch.stack(vals_k), pages[order]), "kv pages")
    require(torch.equal(torch.cat(poss).reshape(-1).to(torch.int64),
                        order), "kv pos")
    for p in tags.group.members:
        for k in tags.keys(p):
            require(tags.get(p, k) == ("tag", k, k % 7), "tags value")
    require(tags.global_size() == KEYS, "tags lost")


def state_equal(a, b) -> bool:
    """Bit-identical final state of two runs of the scenario."""
    for ca, cb in zip(a, b):
        for p in ca.group.members:
            if hasattr(ca, "ranges"):
                if ca.ranges(p) != cb.ranges(p):
                    return False
                ha, hb = ca.handle(p), cb.handle(p)
                if not all(bytes_equal(ha.chunks[r], hb.chunks[r])
                           for r in ha.ranges()):
                    return False
            else:
                if sorted(ca.keys(p)) != sorted(cb.keys(p)):
                    return False
                for k in ca.keys(p):
                    va, vb = ca.get(p, k), cb.get(p, k)
                    if isinstance(va, dict):
                        if any(not bytes_equal(va[f], vb[f]) for f in va):
                            return False
                    elif va != vb:
                        return False
            if ca.get_distribution() != cb.get_distribution():
                return False
    return True


def check_windows(shift, cols, stats, pages, report):
    """Conservation, per-entry checksums and map values of the main
    path's windows."""
    import torch
    from repro_torch.core import PlaceGroup

    pts, ids, kv, tags = cols
    n_pts, n_ids = 1 << (23 - shift), 1 << (22 - shift)
    require(pts.global_size() == n_pts and ids.global_size() == n_ids,
            "array entries lost")
    for c in cols:
        require(c.local_size(N_PLACES - 1) == 0, "eviction left entries")
    check_maps(kv, tags, pages)
    # rebuild the seeded inputs: row bytes keyed by global index must
    # be unchanged
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    ref_cols = build_collections(PlaceGroup(N_PLACES, device=DEV), shift, gen)
    for got, want, name in ((pts, ref_cols[0], "pts"),
                            (ids, ref_cols[1], "ids")):
        require(array_checksum(got) == array_checksum(want),
                f"{name} checksum changed")
    require(all(s.codec_backend == "fused" for s in stats),
            "main-path windows did not run the fused codec")
    report["windows_full"] = [{k: getattr(s, k) for k in STAT_KEYS}
                              for s in stats]


def phase_windows_parity(shift, report):
    """Both backends at 1/16 of the rows: bit-identical state and equal
    wire accounting."""
    import torch
    from repro_torch.kernels import ops

    runs = {}
    for be in ("fused", "composite"):
        ops.set_backend(be)
        try:
            cols, stats, _ = run_windows(shift + 4)
        finally:
            ops.set_backend("auto")
        require(all(s.codec_backend == be for s in stats), be)
        runs[be] = (cols, [{k: getattr(s, k) for k in STAT_KEYS}
                           for s in stats])
        torch.cuda.synchronize()
    require(runs["fused"][1] == runs["composite"][1],
            f"TransportStats differ: {runs['fused'][1]} vs "
            f"{runs['composite'][1]}")
    require(state_equal(runs["fused"][0], runs["composite"][0]),
            "fused and composite final states differ")
    report["windows_parity"] = runs["fused"][1]


# ---------------------------------------------------------------------------
# phase 3: the GLB steal loop
# ---------------------------------------------------------------------------
def hot_shard(shift):
    import torch
    from repro_torch.core import DistArray, LongRange, PlaceGroup

    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    n = 1 << (20 - shift)
    col = DistArray(PlaceGroup(N_PLACES, device=DEV), track=True)
    for p in col.group.members:
        col.handle(p)
    col.add_chunk(0, LongRange(0, n), rand_rows(gen, n, 32, "float32"))
    return col


def steal(col, transport, device_loop):
    from repro_torch.core import (DistArrayWorkload, GLBConfig,
                                  GlobalLoadBalancer)
    glb = GlobalLoadBalancer(
        col.group, DistArrayWorkload(col),
        GLBConfig(lifeline="hypercube", random_steal_attempts=0,
                  transport=transport), device_loop=device_loop)
    res = glb.steal_loop()
    st = glb.stats
    return {"rounds": res["rounds"], "stolen": res["stolen"],
            "attempted": st.steals_attempted, "served": st.steals_served,
            "hops": st.steal_hops,
            "loads": [col.local_size(p) for p in col.group.members]}


def main_path_glb(shift):
    col = hot_shard(shift)
    res = steal(col, "device", True)          # codec rows, decode kernel
    return col, res


def phase_glb_checks(shift, col_dev, res_dev, report):
    import torch
    want_sum = array_checksum(hot_shard(shift))
    require(array_checksum(col_dev) == want_sum, "steal changed entries")
    col_id = hot_shard(shift)
    res_id = steal(col_id, "host", True)      # id plane
    require(res_id == res_dev, f"planes differ: {res_id} vs {res_dev}")
    require(state_equal((col_dev,), (col_id,)),
            "device planes' final states differ")
    del col_id
    torch.cuda.empty_cache()
    col_h = hot_shard(shift)
    res_h = steal(col_h, "device", False)     # host steal_pass loop
    require(res_h == res_dev, f"host loop {res_h} != device loop {res_dev}")
    require(array_checksum(col_h) == want_sum, "host loop changed entries")
    report["glb"] = res_dev


# ---------------------------------------------------------------------------
def profile_main_path(shift, path):
    """The main path (windows + device steal loop) once under
    torch.profiler: device time by kernel, and the device's busy share
    of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_windows(shift)
        main_path_glb(shift)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies, fills): host ops
        # also carry the device time of the kernels they launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append({"name": e.key, "calls": e.count,
                         "self_device_us": dev_us})
    rows.sort(key=lambda r: -r["self_device_us"])
    busy = sum(r["self_device_us"] for r in rows)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=40))
    return {"wall_us": wall_us, "device_busy_us": busy,
            "busy_share": busy / wall_us, "top": rows[:25]}


def smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shift", type=int, default=0,
                    help="divide every row count by 2^SHIFT")
    ap.add_argument("--out", default=None, help="write a JSON report here")
    ap.add_argument("--profile", default=None,
                    help="after the checks, run the main path once more "
                         "under torch.profiler and write its kernel table "
                         "here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device visible; nothing was run")
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        log(f"chip_smoke: the port's sources are missing under {SRC}")
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import reloc_codec as rc

    report = {"phases": [], "shift": args.shift,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = smi_line()
    with Phase("build", report):
        lib = rc.build()
        rc._lib()
    report["build_log"] = rc.build_log
    log(rc.build_log)
    log(f"[build] {lib}")

    with Phase("kernels", report):
        times = phase_kernels(args.shift, report)

    # the main path: every launch count from zero, read right after
    rc.reset_launch_counts()
    with Phase("windows", report):
        cols, stats, pages = run_windows(args.shift)
    with Phase("glb_device_loop", report):
        col_dev, res_dev = main_path_glb(args.shift)
    torch.cuda.synchronize()
    main_launches = dict(rc.launch_counts)
    missing = [k for k, v in main_launches.items() if v == 0]
    require(not missing, f"main path never launched {missing}")
    with Phase("windows_checks", report):
        check_windows(args.shift, cols, stats, pages, report)
    del cols, stats, pages
    torch.cuda.empty_cache()
    with Phase("windows_parity", report):
        phase_windows_parity(args.shift, report)
    with Phase("glb_checks", report):
        phase_glb_checks(args.shift, col_dev, res_dev, report)
    report["launches"] = main_launches
    if args.profile:
        with Phase("profile", report):
            report["profile"] = profile_main_path(args.shift, args.profile)

    kernels = []
    for name, replaces in rc.KERNELS.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": rc.SOURCE,
            "replaces": replaces, "launches": main_launches[name],
            # phase 1 raised unless every comparison was torch.equal
            "equal": True, "max_abs_err": 0.0,
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": t["library_ms"],
            "library_call": t["library_call"], "shape": t["shape"]})
    report["kernels"] = kernels
    report["smi"] = smi
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    for rec in report["phases"]:
        print(json.dumps(rec))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
