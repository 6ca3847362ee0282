#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's main paths on the card at the sizes below and holds
each hand-written kernel against its plain PyTorch version:

* phase 0: build the kernels from ``src/repro_torch/kernels/csrc`` (one
  ``nvcc`` per source, all started together);
* phase 1: each relocation-codec kernel at the main path's shapes over
  float32, bfloat16, int32, uint8 and float64 (width > row bytes,
  zero-width slots, out-of-range indices, the arena's last row),
  ``torch.equal`` with its plain version, then timed with CUDA events
  beside its bound, its plain version and a one-call PyTorch yardstick;
* phase 2: three relocation windows over ``PlaceGroup(8)``: ``pts``
  (2^23 x 32 float32, all on place 0), ``ids`` (2^22 x 16 int64, block
  distributed), ``kv`` (4096 keys of ``{"k": page, "v": page, "pos"}``
  with ``k`` and ``v`` aliasing one 1 KiB page) and ``tags`` (4096
  pickled tuples); then the same scenario at 1/16 of the rows on the
  ``fused`` and ``composite`` backends, which must agree bit for bit;
* phase 3: ``GlobalLoadBalancer(device_loop=True)`` on a 2^20 x 32
  float32 hot shard over 8 places (codec rows through ``decode_rows``),
  held against the host ``steal_pass`` loop and the id-plane loop;
* phase 4: the flash-attention kernel against ``flash_ref`` at qwen2's
  prefill shape (q 4 x 12 x 4096 x 128, k and v 4 x 2 x 4096 x 128,
  bfloat16, causal; timed beside its bound, ``flash_ref`` and
  ``scaled_dot_product_attention``) and over a sweep of head dims 64 /
  128 / 256, GQA groups 1 / 6 / 8, causal and not, a window, a softcap,
  ragged lengths, ``Sq = 1`` and fully masked rows, in float32 (within
  1e-4), bfloat16 and float16 (within 2e-2 absolute and relative);
* phase 5: qwen2-1.5B (28 layers, full width, random weights from a
  seed) ``prefill_forward`` on 4 prompts of 4096 tokens through the
  flash kernel (``fused``) and through ``flash_ref`` (``composite``),
  then 32 ``decode_step`` s from each state, teacher-forced with the
  greedy tokens of the f32 fused run.  In float32 compute the two paths'
  last logits, K/V caches and decode logits agree within 1e-3 (a kernel
  fault shows there).  In bfloat16 — the main path — both paths are
  held against the f32 run: the fused path may be no further from it
  than the plain path is (x1.25, largest and root-mean-square error);
  the direct fused-vs-composite distance is reported beside it;
* phase 6: ``ElasticServingDriver`` over 4 replicas serving qwen2-1.5B
  (``DecodeEngine``, ``s_cache`` 1024, micro-batches of 8) with the
  ``device`` transport: a hot replica and a slow one, 32 measured decode
  rounds; KV migration windows move ~29.5 MB ``SeqKV`` payloads through
  ``pack_rows``, with zero sequences lost.

The launch counts are set to 0 just before each main path (phases 2-3,
5 and 6) and read just after; a path that launched none of its kernels
fails.  Every check raises on failure.  The output ends with each
phase's wall time and peak memory, the card's name and power limit, a
``kernels`` JSON line and, as the last line, ``{"ok": true, "device":
{...}}``.

Run from the repository root: ``python3 chip_smoke.py``
(``--shift K`` divides every row count of phases 1-3 by 2^K; ``--out
PATH`` writes a JSON report; ``--profile PATH`` adds one profiled pass
of each main path).
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
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core peaks, same sheet
              "float16": 989e12, "float32": 67e12}
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
# phase 4: the flash-attention kernel against flash_ref
# ---------------------------------------------------------------------------
QWEN_PREFILL = (4, 12, 2, 4096, 4096, 128)        # B, Hq, Hkv, Sq, Skv, D

# (B, Hq, Hkv, Sq, Skv, D, causal, window, softcap)
FLASH_SWEEP = [
    (2, 8, 8, 1000, 1000, 64, True, None, 0.0),       # group 1
    (1, 12, 2, 1000, 1000, 128, False, None, 0.0),    # group 6
    (1, 8, 1, 1000, 1000, 256, True, 512, 0.0),       # group 8, window
    (2, 12, 2, 1000, 1000, 128, True, None, 50.0),    # softcap
    (2, 12, 2, 1, 1000, 128, True, None, 0.0),        # Sq = 1
    (1, 8, 1, 1, 1000, 64, False, None, 0.0),
    (1, 12, 2, 1000, 300, 128, True, 64, 0.0),        # rows >= 363 masked
]
FLASH_TOL = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 2e-2),
             "float16": (2e-2, 2e-2)}


def flash_inputs(gen, shape, dtype):
    import torch
    B, Hq, Hkv, Sq, Skv, D = shape
    mk = lambda h, n: torch.randn((B, h, n, D), generator=gen,
                                  device=DEV).to(torch_dtype(dtype))
    return mk(Hq, Sq), mk(Hkv, Skv), mk(Hkv, Skv)


def flash_close(got, want, dtype, what):
    """``max|got - want|`` after the tolerance check."""
    import torch
    atol, rtol = FLASH_TOL[dtype]
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    require(bool(torch.isfinite(g).all()) and bool(
        torch.isclose(g, w, atol=atol, rtol=rtol).all()),
        f"{what}: flash kernel vs flash_ref max|err| {err}")
    return err


def phase_flash(report):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    sweep = []
    for dtype in ("float32", "bfloat16", "float16"):
        for case in FLASH_SWEEP:
            causal, window, softcap = case[6:]
            q, k, v = flash_inputs(gen, case[:6], dtype)
            got = fa.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
            want = ref.flash_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
            torch.cuda.synchronize()
            err = flash_close(got, want, dtype, f"{dtype} {case}")
            if causal and window is not None and case[3] > case[4]:
                dead = case[4] + window - 1
                require(not got[:, :, dead:].float().abs().max().item(),
                        f"fully masked rows not exactly 0 in {case}")
            sweep.append({"case": list(case), "dtype": dtype,
                          "max_abs_err": err})
    report["flash_sweep"] = sweep

    B, Hq, Hkv, Sq, Skv, D = QWEN_PREFILL
    q, k, v = flash_inputs(gen, QWEN_PREFILL, "bfloat16")
    got = fa.flash_attention(q, k, v, causal=True)
    want = ref.flash_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = flash_close(got, want, "bfloat16", "qwen2 prefill shape")
    del got, want
    flops = fa.attention_flops(B, Hq, Sq, Skv, D, causal=True, window=None)
    nbytes = 2 * (q.nelement() + k.nelement() + v.nelement()
                  + q.nelement())
    bound = max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
    out = {
        "shape": f"q ({B}, {Hq}, {Sq}, {D}), k/v ({B}, {Hkv}, {Skv}, {D}) "
                 "bfloat16, causal",
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
        "plain_ms": cuda_ms(lambda: ref.flash_ref(q, k, v, causal=True)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=1.0 / D ** 0.5,
            enable_gqa=True)),
        "library_call": "F.scaled_dot_product_attention(q, k, v, "
                        "is_causal=True, enable_gqa=True)",
        "bound_ms": bound * 1e3, "flops": flops, "bytes": nbytes,
        "bound_by": "operations" if flops / PEAK_FLOPS["bfloat16"]
        >= nbytes / HBM_BYTES_PER_S else "bytes",
        "max_abs_err": err,
        "sweep_max_abs_err": {dt: max(r["max_abs_err"] for r in sweep
                                      if r["dtype"] == dt)
                              for dt in FLASH_TOL}}
    log(f"[flash] {out['ms']:.3f} ms (bound {out['bound_ms']:.3f}, plain "
        f"{out['plain_ms']:.3f}, sdpa {out['library_ms']:.3f})")
    del q, k, v
    torch.cuda.empty_cache()
    report["flash"] = out
    return out


# ---------------------------------------------------------------------------
# phase 5: qwen2-1.5B prefill and decode at full width and depth
# ---------------------------------------------------------------------------
PREFILL_B, PREFILL_S, PREFILL_CACHE = 4, 4096, 4160
DECODE_STEPS = 32
F32_TOL = 1e-3          # fused vs composite in f32 compute
BF16_TOL = 3e-2         # tests/test_arch_smoke.py's bf16 tolerance
# in bf16 the fused path's distance to the f32 run may exceed the plain
# path's by this factor at most
BF16_MARGIN = 1.25


def qwen2_config():
    """qwen2-1.5B at its published widths and full depth."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2_1_5b")
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_padded)
            == (28, 1536, 12, 2, 128, 8960, 152064), "qwen2-1.5B config")
    return cfg


def qwen2_params(cfg):
    """f32 master parameters from the seed, and their bf16 compute cast
    (made once)."""
    from repro_torch.models import transformer as T
    from repro_torch.models import zoo
    master = zoo.init_params(cfg, SEED, device=DEV)
    return master, T.cast_params(master, cfg)


def f32_close(a, b, what):
    """f32 compute, fused vs composite: every element within 1e-3
    (absolute and relative) — a kernel fault shows here."""
    import torch
    a, b = a.float(), b.float()
    err = float((a - b).abs().max())
    require(bool(torch.isfinite(a).all()) and bool(
        torch.isclose(a, b, atol=F32_TOL, rtol=F32_TOL).all()),
        f"{what} (float32): fused vs composite max|err| {err} > {F32_TOL}")
    return err


def bf16_close(fused, plain, truth, what):
    """bf16 compute: both paths are held against the f32 run of the same
    inputs.  Rounding the residual stream to bf16 in 28 layers moves
    either path further from it than 3e-2, and the two paths, which sum
    in f32 in different orders, round differently; so the fused path
    must be no further from the f32 run than the plain path is, within
    ``BF16_MARGIN``, in both the largest and the root-mean-square error.
    The direct fused-vs-composite distance and the share of elements
    outside ``BF16_TOL`` are reported beside it."""
    import torch
    f, c, t = fused.float(), plain.float(), truth.float()
    ek, ep = (f - t).abs(), (c - t).abs()
    rel = lambda e: float(e.norm() / t.norm())  # noqa: E731
    d = (f - c).abs()
    out = {"max_vs_f32": float(ek.max()), "plain_max_vs_f32": float(ep.max()),
           "rel_l2_vs_f32": rel(ek), "plain_rel_l2_vs_f32": rel(ep),
           "max_vs_composite": float(d.max()),
           "share_outside_3e-2": float(
               (d > BF16_TOL + BF16_TOL * c.abs()).float().mean())}
    require(bool(torch.isfinite(f).all())
            and out["max_vs_f32"] <= BF16_MARGIN * out["plain_max_vs_f32"]
            and out["rel_l2_vs_f32"] <= BF16_MARGIN
            * out["plain_rel_l2_vs_f32"],
            f"{what} (bfloat16): the fused path is further from the f32 "
            f"run than the plain path: {out}")
    return out


def prefill(cfg, params, tokens, impl):
    """One prefill; returns (state, last logits, wall seconds)."""
    import torch
    from repro_torch.models import Parallel
    from repro_torch.models import transformer as T

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, lg = T.prefill_forward(params, cfg, Parallel(), {"tokens": tokens},
                               PREFILL_CACHE, impl=impl)
    torch.cuda.synchronize()
    require(tuple(lg.shape) == (tokens.shape[0], cfg.vocab_padded),
            f"prefill logits of shape {tuple(lg.shape)}")
    return st, lg, time.perf_counter() - t0


def decode(cfg, params, st, follow):
    """Teacher-forced decode of ``follow`` (steps, B, 1) from ``st``;
    returns the logits of every step and the median ms per step."""
    import torch
    from repro_torch.models import Parallel
    from repro_torch.models import transformer as T

    logits, times = [], []
    for tok in follow:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, lg = T.decode_step(params, cfg, Parallel(), st, tok)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg)
    return torch.stack(logits), statistics.median(times)


def phase_qwen2(report, main_launches):
    """f32 compute first: fused vs composite within 1e-3 (a kernel fault
    shows there), and the composite run is the reference of the bf16
    runs.  Then the bf16 main path: the fused prefill (counted), the
    composite one, and 32 decode steps from each state, teacher-forced
    with the f32 fused run's greedy tokens."""
    import dataclasses

    import torch
    from repro_torch.kernels import cuda_build
    from repro_torch.models import Parallel
    from repro_torch.models import transformer as T

    cfg = qwen2_config()
    c32 = dataclasses.replace(cfg, dtype="float32")
    master, params = qwen2_params(cfg)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device=DEV, dtype=torch.int32)
    out = {"config": cfg.name, "batch": PREFILL_B, "prompt": PREFILL_S,
           "s_cache": PREFILL_CACHE, "decode_steps": DECODE_STEPS}

    # f32: kernel vs plain version, and the reference of the bf16 runs
    st_f, lg_f, wall_f = prefill(c32, master, tokens, "fused")
    st_c, lg_c, _ = prefill(c32, master, tokens, "composite")
    e32 = {"prefill_logits": f32_close(lg_f, lg_c, "prefill logits")}
    for name in ("k", "v"):
        e32[f"cache_{name}"] = f32_close(
            st_f["scan"][0][name], st_c["scan"][0][name], f"cache {name}")
    # the token stream every decode run is forced with: greedy from the
    # f32 fused run
    follow, st = [], st_f
    tok = lg_f.argmax(-1)[:, None].to(torch.int32)
    for _ in range(DECODE_STEPS):
        follow.append(tok)
        st, lg = T.decode_step(master, c32, Parallel(), st, tok)
        tok = lg.argmax(-1)[:, None].to(torch.int32)
    del st
    dl_f, ms32 = decode(c32, master, st_f, follow)
    dl_c, _ = decode(c32, master, st_c, follow)
    e32["decode_logits"] = f32_close(dl_f, dl_c, "decode logits")
    truth = {"prefill_logits": lg_c, "k": st_c["scan"][0]["k"],
             "v": st_c["scan"][0]["v"], "decode_logits": dl_c}
    out["float32"] = {"max_abs_err": e32, "prefill_s": wall_f,
                      "prefill_tokens_per_s": PREFILL_B * PREFILL_S / wall_f,
                      "decode_ms_per_step": ms32}
    del st_f, st_c, lg_f, dl_f, master
    torch.cuda.empty_cache()

    # bf16: the main path, counted from zero
    cuda_build.reset_launch_counts()
    st_f, lg_f, wall = prefill(cfg, params, tokens, "fused")
    main_launches.update(cuda_build.launch_counts)
    st_c, lg_c, _ = prefill(cfg, params, tokens, "composite")
    e16 = {"prefill_logits": bf16_close(lg_f, lg_c, truth["prefill_logits"],
                                        "prefill logits")}
    for name in ("k", "v"):
        e16[f"cache_{name}"] = bf16_close(st_f["scan"][0][name],
                                          st_c["scan"][0][name],
                                          truth[name], f"cache {name}")
    require(torch.equal(st_f["scan"][0]["pos"], st_c["scan"][0]["pos"])
            and torch.equal(st_f["pos"], st_c["pos"]), "cache positions")
    dl_f, ms = decode(cfg, params, st_f, follow)
    dl_c, _ = decode(cfg, params, st_c, follow)
    e16["decode_logits"] = bf16_close(dl_f, dl_c, truth["decode_logits"],
                                      "decode logits")
    out["bfloat16"] = {"errors": e16, "prefill_s": wall,
                       "prefill_tokens_per_s": PREFILL_B * PREFILL_S / wall,
                       "decode_ms_per_step": ms}
    for dt in ("float32", "bfloat16"):
        r = out[dt]
        log(f"[qwen2 {dt}] prefill {r['prefill_s']:.3f} s "
            f"({r['prefill_tokens_per_s']:.0f} tok/s), decode "
            f"{r['decode_ms_per_step']:.2f} ms/step")
    log(f"[qwen2] errors f32 {e32}, bf16 {e16}")
    require(main_launches.get("flash_attention") == cfg.n_layers,
            f"fused prefill launched the flash kernel "
            f"{main_launches.get('flash_attention')} times, not "
            f"{cfg.n_layers}")
    report["qwen2"] = out


# ---------------------------------------------------------------------------
# phase 6: the elastic serving runtime at full width
# ---------------------------------------------------------------------------
SERVE_ROUNDS = 32


def phase_serving(report, main_launches):
    import numpy as np
    import torch
    from repro_torch.kernels import cuda_build
    from repro_torch.serving import DecodeEngine, RealDecodeSim, SeqKV

    engine = DecodeEngine(qwen2_config(), s_cache=1024, max_batch=8,
                          seed=SEED, device=DEV)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    sim = RealDecodeSim(n_replicas=4, slots=16, work=(1, 1, 3, 1),
                        preload=(2, 24), arrival_rate=3.0,
                        prompt_range=(8, 48), max_new_range=(8, 24),
                        glb_period=4, pipeline_depth=2, seed=SEED,
                        engine=engine, transport="device").run(SERVE_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches.update(cuda_build.launch_counts)
    d = sim.driver
    require(d.lost() == 0, f"{d.lost()} sequences lost")
    seq_kv = None
    for p in d.group.members:
        require(sorted(d.seqs.keys(p)) == sorted(d.kv.keys(p)),
                f"replica {p}: sequences and KV separated")
        for v in d.kv.handle(p).values():
            require(isinstance(v, SeqKV) and v.on_device(DEV),
                    f"replica {p}: KV left the card")
            seq_kv = v
    st, life = d.glb.stats, d.transport.lifetime
    require(st.rebalances > 0 and st.bytes_moved > 0, "no rebalance")
    require(life.exchanges >= 1 and life.row_bytes > 0, "no KV exchange")
    fast = [d.seqs.local_size(p) for p in d.group.members if p != 2]
    require(d.seqs.local_size(2) < np.mean(fast),
            f"slow replica 2 holds {d.seqs.local_size(2)} >= mean "
            f"{np.mean(fast)} of the fast ones")
    require(main_launches.get("reloc_pack_rows", 0) > 0,
            "KV migration never launched pack_rows")
    p95 = sim.window_p95()
    out = {"rounds": SERVE_ROUNDS, "wall_s": wall,
           "tokens_decoded": sim.tokens,
           "throughput_tokens_per_s": sim.throughput(),
           "window_p95_s": p95, "admitted": d.admitted,
           "completed": len(d.completed), "lost": d.lost(),
           "loads": [d.seqs.local_size(p) for p in d.group.members],
           "rebalances": st.rebalances, "glb_bytes_moved": st.bytes_moved,
           "exchanges": life.exchanges, "row_bytes": life.row_bytes,
           "wire_bytes": life.wire_bytes, "width": life.width,
           "seqkv_bytes": seq_kv.nbytes if seq_kv is not None else None}
    log(f"[serving] {sim.tokens} tokens, {out['throughput_tokens_per_s']:.1f}"
        f" tok/s, p95 {p95}, loads {out['loads']}, width {life.width}")
    report["serving"] = out
    del sim, engine
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
def profile_pass(run, path):
    """``run()`` once under torch.profiler: device time by kernel, and
    the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
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


def profile_main_paths(shift, path):
    """Each main path once under the profiler: the windows and the
    device steal loop; qwen2-1.5B prefill through the flash kernel and
    8 decode steps; 8 rounds of the elastic serving runtime."""
    import torch
    from repro_torch.models import Parallel
    from repro_torch.models import transformer as T
    from repro_torch.serving import DecodeEngine, RealDecodeSim

    out = {"windows_glb": profile_pass(
        lambda: (run_windows(shift), main_path_glb(shift)), path)}
    cfg = qwen2_config()
    _, params = qwen2_params(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=torch.Generator(device=DEV)
                           .manual_seed(SEED + 5), device=DEV,
                           dtype=torch.int32)

    def prefill_decode():
        st, lg = T.prefill_forward(params, cfg, Parallel(),
                                   {"tokens": tokens}, PREFILL_CACHE,
                                   impl="fused")
        for _ in range(8):
            st, lg = T.decode_step(params, cfg, Parallel(), st,
                                   lg.argmax(-1)[:, None].to(torch.int32))

    stem = Path(path)
    out["qwen2_prefill_decode"] = profile_pass(
        prefill_decode, stem.with_name(stem.stem + "_qwen2" + stem.suffix))
    del params
    torch.cuda.empty_cache()
    engine = DecodeEngine(cfg, s_cache=1024, max_batch=8, seed=SEED,
                          device=DEV)
    out["serving"] = profile_pass(
        lambda: RealDecodeSim(n_replicas=4, slots=16, work=(1, 1, 3, 1),
                              preload=(2, 24), glb_period=4,
                              pipeline_depth=2, seed=SEED, engine=engine,
                              transport="device").run(8),
        stem.with_name(stem.stem + "_serving" + stem.suffix))
    return out


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
                    help="divide every row count of phases 1-3 by 2^SHIFT")
    ap.add_argument("--out", default=None, help="write a JSON report here")
    ap.add_argument("--profile", default=None,
                    help="after the checks, run each main path once more "
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
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import reloc_codec as rc

    report = {"phases": [], "shift": args.shift,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = smi_line()
    libraries = (rc.LIBRARY, fa.LIBRARY)
    with Phase("build", report):
        paths = cuda_build.build_all(libraries)
        for lib in libraries:
            lib.lib()
    report["build_log"] = {lib.name: lib.build_log for lib in libraries}
    for lib, path in zip(libraries, paths):
        log(lib.build_log)
        log(f"[build] {path}")

    with Phase("kernels", report):
        times = phase_kernels(args.shift, report)
    with Phase("flash_kernel", report):
        times["flash_attention"] = phase_flash(report)

    # main path 1 (phases 2-3): every launch count from zero, read right
    # after
    launches = {}
    cuda_build.reset_launch_counts()
    with Phase("windows", report):
        cols, stats, pages = run_windows(args.shift)
    with Phase("glb_device_loop", report):
        col_dev, res_dev = main_path_glb(args.shift)
    torch.cuda.synchronize()
    launches["windows_glb"] = dict(cuda_build.launch_counts)
    missing = [k for k in rc.KERNELS if launches["windows_glb"][k] == 0]
    require(not missing, f"windows and steal loop never launched {missing}")
    with Phase("windows_checks", report):
        check_windows(args.shift, cols, stats, pages, report)
    del cols, stats, pages
    torch.cuda.empty_cache()
    with Phase("windows_parity", report):
        phase_windows_parity(args.shift, report)
    with Phase("glb_checks", report):
        phase_glb_checks(args.shift, col_dev, res_dev, report)
    del col_dev
    torch.cuda.empty_cache()

    # main path 2 (phase 5): the fused prefill, counted inside
    launches["qwen2_prefill"] = {}
    with Phase("qwen2_prefill_decode", report):
        phase_qwen2(report, launches["qwen2_prefill"])
    # main path 3 (phase 6): the elastic serving runtime, counted inside
    launches["serving"] = {}
    with Phase("elastic_serving", report):
        phase_serving(report, launches["serving"])
    report["launches"] = launches
    if args.profile:
        with Phase("profile", report):
            report["profile"] = profile_main_paths(args.shift, args.profile)

    kernels = []
    for lib in libraries:
        for name, replaces in lib.kernels.items():
            t = times[name]
            n = sum(path.get(name, 0) for path in launches.values())
            require(n > 0, f"no main path launched {name}")
            flash = name == "flash_attention"
            kernels.append({
                "name": name, "route": "cuda", "source": lib.source,
                "replaces": replaces, "launches": n,
                "launches_by_path": {k: v.get(name, 0)
                                     for k, v in launches.items()},
                # the phases raised unless every comparison passed: exact
                # for the codec, within the stated tolerance for flash
                "equal": not flash, "within_tol": True,
                "max_abs_err": t["max_abs_err"] if flash else 0.0,
                "ms": t["ms"], "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t.get("bound_by", "bytes"),
                "library_ms": t["library_ms"],
                "library_call": t["library_call"], "shape": t["shape"]})
    report["kernels"] = kernels
    report["smi"] = smi
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    for rec in report["phases"]:
        print(json.dumps(rec))
    print(json.dumps({"qwen2": report["qwen2"], "serving": {
        k: v for k, v in report["serving"].items()}, "launches": launches}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
