#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's main paths on the card at the sizes below and holds
each hand-written kernel against its plain PyTorch version:

* phase 0: build the kernels from ``src/repro_torch/kernels/csrc`` (one
  ``nvcc`` per source, all started together); count the ``HGMMA``
  (``wgmma``) instructions in the flash library's SASS and read ptxas'
  registers and spills of each of its TMA kernel's 8 instantiations
  (all must be read, none may spill); count the tensor-core (``HMMA``)
  instructions in the mlstm library's SASS, whose kernels may not spill
  either; count the ``HGMMA`` instructions in the flash backward's
  library and read the registers and spills of its 34 instantiations
  (18 of the FMA route, 16 of the tensor-core route; none may spill);
  read the registers and spills of every kernel of the ``rg_lru`` and
  MoE libraries (none may spill) and count their new routes' copy
  instructions in the SASS: ``UTMALDG`` (TMA) in ``librg_lru.so``,
  ``UBLKCP`` (bulk copy) in ``libmoe_dispatch.so``;
* phase 1: each relocation-codec kernel at the main path's shapes over
  float32, bfloat16, int32, uint8 and float64 (width > row bytes,
  zero-width slots, out-of-range indices, the arena's last row),
  ``torch.equal`` with its plain version, then timed with CUDA events
  beside its bound, its plain version and a one-call PyTorch yardstick
  (``decode_rows`` also on a receive block with a row stride of 256 B,
  and in device time beside ``clone``'s);
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
  ``scaled_dot_product_attention``, with its TFLOP/s) and over a sweep
  of head dims 64 / 128 / 192 / 256, GQA groups 1 / 6 / 8 / 10, causal
  and not, windows shorter than a key tile and longer than several, a
  softcap, ragged lengths, ``Sq = 1``, fully masked rows, the models'
  transposed (B, S, H, D) views, rows whose stride is no 16-byte
  multiple, windows 0, -3 and -Skv - 1 (causal or not),
  recurrentgemma-2b's local attention (head dim 256, group 10, causal
  window 2048) and deepseek-v2-lite's MLA (head dim 192, 16 heads), in float32 (within 1e-4), bfloat16 and float16 (within 2e-2
  absolute and relative, and within 1e-4 plus 1e-2 (bf16) or 2e-3
  (f16) of ``|flash_ref|``: one ulp of the output), with bfloat16 also
  held against ``flash_ref`` on float32 copies of its inputs (within
  half an output ulp plus 1e-4: what the P split buys); also timed at deepseek's prefill shape (4 x
  16 x 4096 x 192) and at recurrentgemma-2b's local attention (q 4 x
  10 x 4096 x 256, k and v 4 x 1 x 4096 x 256, causal window 2048,
  SDPA with a boolean band mask), bfloat16;
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
  ``pack_rows``, with zero sequences lost;
* phase 7: ``rg_lru`` and ``mlstm_chunkwise`` against their plain
  versions (``rg_lru_ref``, ``mlstm_ref``) at the recurrent models'
  prefill shapes — x, a (4, 4096, 2560); q, k, v (16, 2048, 512) — and
  over a sweep (ragged S and D, an ``h0``, S shorter than the chunk and
  S = 65, head dims 16 / 24 / 64 / 512 / 1024, strongly negative input
  gates, forget gates near 1) in float32 and bfloat16 (mlstm also
  float16), within the tolerances stated at ``rg_lru_close`` and
  ``mlstm_close``, and 16-bit mlstm within half an output ulp + 1e-4
  max|h| of the f32 recurrence on its own rounded, scaled q and k;
  ``rg_lru`` on every case also launched twice and on the simple route,
  all the same bits as its first launch; each timed beside its bound
  and its plain version (mlstm in bf16, f16 and on the f32 FMA route;
  ``rg_lru`` on both routes, per call and in device time);
* phases 8 and 9: recurrentgemma-2b (26 layers: 18 RG-LRU + 8 local
  attention, d_model 2560; 4 prompts of 4096 tokens, longer than its
  2048 window) and xlstm-350m (24 layers: 21 mLSTM + 3 sLSTM, d_model
  1024; 4 prompts of 2048 tokens) through phase 5's checks, with random
  weights from a seed: the fused prefill launches ``rg_lru`` 18 times,
  all on its TMA route, and ``flash_attention`` 8 times,
  ``mlstm_chunkwise`` 21 times;
* phase 10: phase 6's serving runtime over recurrentgemma-2b (16
  rounds): each ``SeqKV`` holds the local-attention ring caches and the
  RG-LRU hidden state and conv tail of its sequence;
* phase 11: ``gather_rows`` and ``moe_combine`` against their plain
  versions at deepseek-v2-lite's prefill shapes (x 16 385 x 2048 into
  122 880 expert-buffer rows; y 122 880 x 2048 back to 16 384 tokens,
  top-6; bfloat16) and decode shapes, and over a sweep (float32,
  bfloat16, float16; unaligned rows, M = 0, N = 1, repeated indices,
  K = 1, 8 and 16, every slot -1): the gather equal, the combine within
  the tolerance stated at ``combine_close`` and, on every case, launched
  twice and on every route the inputs allow (bulk, registers, simple),
  all the same bits; each timed beside its byte bound, its plain version
  and, for the gather, ``index_select``, at both shapes, per call and in
  device time (the combine on each of its routes);
* phase 12: deepseek-v2-lite-16b (MLA + MoE: 27 layers, d_model 2048,
  64 experts top-6 + 2 shared; random weights from a seed; 4 prompts of
  4096 tokens).  At depth 4 (the dense first layer and 3 MoE layers) in
  float32, fused vs composite within 1e-3 except in sequences where the
  two runs' routers chose differently at a near tie (margin between the
  6th and 7th probabilities at most 1e-5; such flips are reported, a
  flip at a wider margin fails), and bfloat16 against that float32 run
  as in phase 5.  At full depth in bfloat16, parameters drawn in the
  compute dtype: the fused prefill launches ``flash_attention`` 27 and
  ``gather_rows`` and ``moe_combine`` 26 times each (every combine on
  its bulk route), every result is
  finite, layer 1's latent cache agrees within 1e-2 (relative L2) and
  the first MoE layer's routed output on one input within one bfloat16
  ulp, then 32 decode steps from each state;
* phase 13: phase 6's serving runtime over deepseek-v2-lite-16b (16
  rounds): each ``SeqKV`` holds 27 latent caches (1024 x (512 + 64)
  bfloat16 and positions), and every decode step launches both MoE
  kernels, no combine on its simple route;
* phase 14: the paper's workloads.  K-Means: 8 places, 2^24 points
  (rows of 4 f64), k 16, 10 iterations, the GLB relocating every 2
  iterations through the device transport toward a 3x place (the run
  fails unless ``encode_pack`` and ``decode_rows`` launched); inertia
  below 0.8x its start, centroids equal a 1-place run's within 1e-9,
  and at 2^16 points the card equals the port's CPU run (assignments
  equal, centroids within 1e-9).  MolDyn: Java Grande size B (8 788
  particles, 38.6 M pairs a step), 4 places, ``ndivide`` 5, 10 steps;
  replicas in sync, positions equal a 1-place run's and a GLB run's
  (speeds 1, 1, 1, 2) within rtol 1e-10; at size A (2 048) 3 steps on
  the card equal the port's CPU run (rtol 1e-10, equal allreduce
  bytes).  PlhamJ: the nine configurations of ``benchmarks/run.py``
  (evenA, unevenC, disturbA x none, level_extremes, proportional; 800
  agents, 100 rounds), each equal to the port's CPU run (load history
  and relocated bytes exactly, simulated time within rtol 1e-12),
  unevenC/level_extremes gaining >= 5 % and evenA/level_extremes
  within 5 %; then unevenC/level_extremes at 65 536 agents for 20
  rounds, with the share of its wall time spent in the per-trade
  dispatch;
* phases 15-17: phi4-mini-3.8b (32 layers, 4 x 4096), gemma3-12b (48
  layers, 5 local of window 1024 : 1 global, 4 x 4096) and gemma2-27b
  (46 layers, local window 4096 / global, softcaps; 2 x 8192, ``s_cache``
  8256) at published widths through phase 5's checks, the f32 gate and
  the bf16 gate run at the largest depth whose f32 weights and their
  bf16 cast take at most half the card (``gate_depth``); below full
  depth, the bf16 main path then runs at full depth with parameters
  drawn in bf16 (finite results, layer 1's key cache fused vs
  composite within 1e-2 in relative L2); the fused prefill launches
  ``flash_attention`` 32, 48 and 46 times;
* phase 18: the flash backward (``flash_attention_bwd``) against
  ``flash_bwd_ref`` over a sweep (head dims 64 and 128, GQA groups 1
  and 6, causal and not, windows none / 1024 / 0 / -3, softcaps 0 and
  50, ragged lengths, the models' (B, S, H, D) views, rows whose
  stride is no 16-byte multiple; float32, bfloat16, float16), each on
  the route its dtype and alignment call for (16-bit aligned: the
  tensor-core route; float32 and unaligned: the FMA route): float32
  within 1e-4 of the largest gradient element, 16-bit each gradient no
  further (relative L2) from ``flash_bwd_ref`` on float32 copies than
  1.25x the plain version's own 16-bit result and every element within
  half an output ulp of it plus 1e-4 of the largest, two launches the
  same bits, the forward's log-sum-exp within 1e-5 of ``flash_ref``'s;
  then timed at qwen2 training's shape (q 2 x 12 x 4096 x 128, bfloat16,
  causal, (B, S, H, D) views: the tensor-core route) beside its bound,
  ``flash_bwd_ref`` and SDPA's backward;
* phase 19: qwen2-1.5B training at full width and depth (f32 master
  weights, ``remat="full"``; the batch from ``ShardedBatches`` over a
  4-place ``PlaceGroup`` fed by ``TokenSource(seed=0)``).  In float32
  compute, fused (flash forward + backward kernels) vs composite
  (autograd through ``flash_ref``) on a 2 x 4096 micro-batch: loss
  within 1e-4, every gradient leaf and the parameters after one AdamW
  step within 1e-3 (relative L2); in bfloat16 every fused gradient leaf
  no further from the float32 run than 1.25x the composite's.  Then the
  main path: ``build_train_step`` (bf16, ``accum`` 2: 16 384 tokens a
  step, AdamW lr 1e-3) for 8 steps on one repeated batch with
  ``StragglerMitigator`` observing each; the loss must fall, each step
  launches the flash forward 112 times (56 + 56 recomputed) and its
  backward 56 times, every one on the tensor-core route; then a
  ``CheckpointManager`` round trip of the
  parameters and moments, bit for bit.

The launch counts (and ``rg_lru``'s and ``moe_combine``'s counts by
route, reported as ``"rg_lru:tma"`` and so on) are set to 0 just before
each main path (phases 2-3, 5, 6, 8, 9, 10, 12, 13, each app of phase
14, 15-17 and 19) and read just after; a path that launched none of its
kernels fails (MolDyn and PlhamJ have no hand-written kernel on their
path: their counts are recorded, all 0).  Every check raises on failure (a phase logs all its
comparisons first).  The output ends with each
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


# device bytes an earlier phase may leave to the garbage collector
CYCLE_BYTES = 1 << 28


def free_memory(where, report):
    """Collect garbage and return the allocator's cached blocks.  The
    device memory that only the collection frees was held by an earlier
    phase's objects in a reference cycle: it is recorded in
    ``report["cycle_bytes"]``, and more than ``CYCLE_BYTES`` fails."""
    import gc

    import torch
    before = torch.cuda.memory_allocated()
    gc.collect()
    freed = before - torch.cuda.memory_allocated()
    torch.cuda.empty_cache()
    report.setdefault("cycle_bytes", {})[where] = freed
    log(f"[memory] before {where}: {freed} B freed only by gc, "
        f"{torch.cuda.memory_allocated()} B still allocated")
    require(freed <= CYCLE_BYTES, f"before {where}: {freed} B of device "
            "memory held in reference cycles")


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


def device_ms(fn, reps=20) -> float:
    """Milliseconds of device time per call of ``fn``: ``reps`` calls
    captured once in a CUDA graph and the graph replayed (median of 5
    replays), so no call waits on the host's launch, which a short call
    is made of under :func:`cuda_ms`.  (``torch.profiler`` would give
    the same, but its tracing slows every later launch of the run.)"""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def require(cond, what):
    if not cond:
        raise AssertionError(what)


class Gate:
    """Collects failed comparisons so a phase logs every number before
    it raises."""

    def __init__(self, what):
        self.what, self.failed = what, []

    def check(self, cond, msg):
        if not cond:
            log(f"[{self.what}] FAILED: {msg}")
            self.failed.append(msg)

    def close(self):
        require(not self.failed, f"{self.what}: {self.failed}")


def reset_counts():
    """Every launch count, and the routed kernels' counts by route, to 0
    (just before a main path)."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import rg_lru as rl

    cuda_build.reset_launch_counts()
    for table in (rl.route_counts, md.combine_route_counts):
        table.update(dict.fromkeys(table, 0))


def read_counts(main_launches):
    """The launch counts since :func:`reset_counts` into ``main_launches``
    (just after a main path), with the routed kernels' launches by route
    as ``"rg_lru:tma"``, ``"moe_combine:bulk"`` and so on."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import rg_lru as rl

    main_launches.update(cuda_build.launch_counts)
    for kernel, table in (("rg_lru", rl.route_counts),
                          ("moe_combine", md.combine_route_counts)):
        main_launches.update({f"{kernel}:{r}": n for r, n in table.items()})


def same_bits(first, *others) -> bool:
    """Every one of ``others`` (a tensor or a tuple of tensors, as
    ``first``) holds the same bits as ``first``."""
    flat = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
    return all(len(flat(o)) == len(flat(first)) and all(
        bytes_equal(p, q) for p, q in zip(flat(first), flat(o)))
        for o in others)


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
def decode_times(block, W, dt):
    """decode_rows on one receive block, timed beside its bound, its plain
    version and ``rows[:, :nbytes].clone()``: per single call (host launch
    included) and in device time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import reloc_codec as rc

    m = block.shape[0]
    nbytes = 2 * m * W
    run = lambda: rc.decode_rows(block, nbytes=W, dtype=dt)  # noqa: E731
    clone = lambda: block[:, :W].clone()  # noqa: E731
    out = {"shape": f"rows ({m}, {W}) uint8, row stride {block.stride(0)} "
                    f"-> ({m}, {W // dt.itemsize}) {str(dt)[6:]}",
           "ms": cuda_ms(run), "device_ms": device_ms(run),
           "plain_ms": cuda_ms(lambda: ref.reloc_decode_rows_ref(
               block, nbytes=W, dtype=dt)),
           "library_ms": cuda_ms(clone), "library_device_ms":
               device_ms(clone),
           "library_call": "rows[:, :nbytes].clone()",
           "bound_ms": bound_ms(nbytes), "bytes": nbytes}
    log(f"[decode_rows {out['shape']}] {out['ms']:.4f} ms "
        f"(device {out['device_ms']:.4f}), clone {out['library_ms']:.4f} "
        f"(device {out['library_device_ms']:.4f}), bound "
        f"{out['bound_ms']:.4f}")
    return out


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
            out["reloc_decode_rows"] = decode_times(block, W, dt)
    # a strided receive block: 2^20 rows of 128 B, a row stride of 2 x 128
    del buf, block
    torch.cuda.empty_cache()
    buf = torch.randint(0, 256, (md, 2 * W), generator=gen, device=DEV,
                        dtype=torch.uint8)
    block = buf[:, W:]
    for dtype in DTYPES:
        dt = torch_dtype(dtype)
        require(bytes_equal(rc.decode_rows(block, nbytes=W, dtype=dt),
                            ref.reloc_decode_rows_ref(block, nbytes=W,
                                                      dtype=dt)),
                f"decode_rows row stride {2 * W} {dtype} != plain")
    out["reloc_decode_rows"]["strided"] = decode_times(
        block, W, torch.float32)
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
DEEPSEEK_PREFILL = (4, 16, 16, 4096, 4096, 192)   # MLA: qk 128 + 64
RG_LOCAL = (4, 10, 1, 4096, 4096, 256)            # recurrentgemma-2b's
RG_WINDOW = 2048                                  # local attention

# (B, Hq, Hkv, Sq, Skv, D, causal, window, softcap[, layout]); layout
# "bshd" passes q, k, v as the models do, (B, S, H, D) transposed to
# (B, H, S, D) views; "pad" gives rows a stride of D + 4 elements (not a
# 16-byte multiple in bf16/f16: the FMA path)
FLASH_SWEEP = [
    (2, 8, 8, 1000, 1000, 64, True, None, 0.0),       # group 1
    (1, 12, 2, 1000, 1000, 128, False, None, 0.0),    # group 6
    (1, 8, 1, 1000, 1000, 256, True, 512, 0.0),       # group 8, window
    (2, 12, 2, 1000, 1000, 128, True, None, 50.0),    # softcap
    (2, 12, 2, 1, 1000, 128, True, None, 0.0),        # Sq = 1
    (1, 8, 1, 1, 1000, 64, False, None, 0.0),
    (1, 12, 2, 1000, 300, 128, True, 64, 0.0),        # rows >= 363 masked
    (1, 10, 1, 2500, 2500, 256, True, 2048, 0.0),     # recurrentgemma-2b
    (2, 16, 16, 1000, 1000, 192, True, None, 0.0),    # deepseek's MLA
    (1, 16, 16, 777, 777, 192, False, None, 0.0),     # ragged, not causal
    (2, 16, 16, 1, 1000, 192, True, None, 0.0),       # Sq = 1
    (1, 16, 16, 1000, 300, 192, True, 64, 0.0),       # rows >= 363 masked
    (1, 6, 1, 129, 200, 128, True, None, 0.0),        # ragged tiles
    (1, 8, 1, 1000, 129, 64, True, 16, 0.0),          # window < a tile
    (1, 10, 1, 200, 1000, 256, False, 700, 0.0),      # window > 5 tiles
    (1, 12, 2, 1000, 1000, 128, True, 2 ** 32 + 16, 0.0),  # > 2^31
    (2, 12, 2, 1000, 1000, 128, True, None, 0.0, "bshd"),
    (1, 16, 16, 1000, 1000, 192, True, None, 0.0, "bshd"),
    (1, 10, 1, 1000, 1000, 256, True, 300, 0.0, "bshd"),
    (1, 8, 8, 300, 300, 128, True, None, 0.0, "pad"),
    # windows <= 0 keep keys j > i - window: after the row (non-causal;
    # each head's last row keeps none) or none (causal), the TMA path
    # (16-bit, aligned) and the FMA path (float32, "pad")
    (1, 8, 2, 300, 300, 128, False, 0, 0.0),
    (1, 8, 2, 300, 300, 64, True, 0, 0.0),
    (1, 8, 2, 200, 260, 192, False, -3, 0.0),
    (1, 8, 2, 300, 300, 256, True, -3, 0.0),
    (1, 8, 2, 300, 300, 128, False, -301, 0.0),       # -Skv - 1
    (1, 8, 2, 300, 300, 128, False, 0, 0.0, "pad"),
    (1, 8, 2, 300, 300, 128, True, -3, 0.0, "pad"),
]
FLASH_TOL = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 2e-2),
             "float16": (2e-2, 2e-2)}
# the 16-bit outputs again, mostly relative: kernel and flash_ref sum in
# f32 and round to the output type once, so they differ by one ulp at most
FLASH_ULP_TOL = {"bfloat16": (1e-4, 1e-2), "float16": (1e-4, 2e-3)}
# bfloat16 output against flash_ref on float32 copies of the inputs:
# within half an output ulp plus this; P rounded once to bfloat16 (no
# hi + lo split) lands about 1e-3 beyond half an ulp
FLASH_SPLIT_ATOL = 1e-4


def flash_inputs(gen, shape, dtype, layout="bhsd"):
    import torch
    B, Hq, Hkv, Sq, Skv, D = shape
    dt = torch_dtype(dtype)

    def mk(h, n):
        if layout == "bshd":
            return torch.randn((B, n, h, D), generator=gen,
                               device=DEV).to(dt).transpose(1, 2)
        if layout == "pad":
            return torch.randn((B, h, n, D + 4), generator=gen,
                               device=DEV).to(dt)[..., :D]
        return torch.randn((B, h, n, D), generator=gen, device=DEV).to(dt)
    return mk(Hq, Sq), mk(Hkv, Skv), mk(Hkv, Skv)


def flash_close(got, want, dtype, what):
    """``max|got - want|`` after the tolerance checks, and (16-bit
    dtypes) the largest share of the one-ulp gate ``FLASH_ULP_TOL`` that
    an element uses (at most 1)."""
    import torch
    atol, rtol = FLASH_TOL[dtype]
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    require(bool(torch.isfinite(g).all()) and bool(
        torch.isclose(g, w, atol=atol, rtol=rtol).all()),
        f"{what}: flash kernel vs flash_ref max|err| {err}")
    if dtype not in FLASH_ULP_TOL or not g.numel():
        return err, None
    atol, rtol = FLASH_ULP_TOL[dtype]
    share = float(((g - w).abs() / (atol + rtol * w.abs())).max())
    require(share <= 1.0, f"{what}: flash kernel vs flash_ref beyond one "
            f"ulp: |err| / ({atol} + {rtol} |want|) reaches {share}")
    return err, share


def flash_split_excess(got, q, k, v, what, **kw):
    """bfloat16 ``got`` against ``flash_ref`` on float32 copies of q, k,
    v: the largest ``|got - want| - ulp(want) / 2``, which must stay
    under ``FLASH_SPLIT_ATOL``."""
    import torch
    from repro_torch.kernels import ref

    want = ref.flash_ref(q.float(), k.float(), v.float(), **kw)
    _, e = torch.frexp(want)              # |want| in [2^(e-1), 2^e)
    half_ulp = torch.where(want == 0, 0.0, torch.ldexp(
        torch.ones_like(want), e.clamp_min(-125) - 9))
    excess = float(((got.float() - want).abs() - half_ulp).max())
    require(excess <= FLASH_SPLIT_ATOL,
            f"{what}: bfloat16 flash vs float32 flash_ref {excess} beyond "
            f"half an ulp (P's hi + lo split lost?)")
    return excess


def phase_flash(report):
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    sweep = []
    for dtype in ("float32", "bfloat16", "float16"):
        for case in FLASH_SWEEP:
            causal, window, softcap = case[6:9]
            q, k, v = flash_inputs(gen, case[:6], dtype, *case[9:])
            got = fa.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
            want = ref.flash_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
            torch.cuda.synchronize()
            err, share = flash_close(got, want, dtype, f"{dtype} {case}")
            row = {"case": list(case), "dtype": dtype, "max_abs_err": err,
                   "ulp_gate_share": share}
            if dtype == "bfloat16":
                row["split_excess"] = flash_split_excess(
                    got, q, k, v, f"{case}", causal=causal, window=window,
                    softcap=softcap)
            if causal and window is not None and case[3] > case[4]:
                dead = case[4] + window - 1
                require(not got[:, :, dead:].float().abs().max().item(),
                        f"fully masked rows not exactly 0 in {case}")
            sweep.append(row)
            del q, k, v, got, want
    report["flash_sweep"] = sweep
    out = flash_at(gen, QWEN_PREFILL, "qwen2 prefill shape")
    out["sweep_max_abs_err"] = {dt: max(r["max_abs_err"] for r in sweep
                                        if r["dtype"] == dt)
                                for dt in FLASH_TOL}
    out["sweep_max_ulp_gate_share"] = {
        dt: max(r["ulp_gate_share"] for r in sweep if r["dtype"] == dt)
        for dt in FLASH_ULP_TOL}
    out["sweep_max_split_excess"] = max(
        r["split_excess"] for r in sweep if "split_excess" in r)
    report["flash"] = out
    report["flash_d192"] = flash_at(gen, DEEPSEEK_PREFILL,
                                    "deepseek prefill shape")
    report["flash_d256"] = flash_at(gen, RG_LOCAL,
                                    "recurrentgemma local attention shape",
                                    window=RG_WINDOW)
    return out


def flash_at(gen, shape, what, window=None):
    """The kernel against ``flash_ref`` at one prefill shape (bfloat16,
    causal, an optional window), timed beside its bound, ``flash_ref``
    and SDPA (with a boolean band mask where there is a window)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, Hq, Hkv, Sq, Skv, D = shape
    q, k, v = flash_inputs(gen, shape, "bfloat16")
    run = lambda: fa.flash_attention(q, k, v, causal=True,  # noqa: E731
                                     window=window)
    got = run()
    want = ref.flash_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    err, share = flash_close(got, want, "bfloat16", what)
    del want
    excess = flash_split_excess(got, q, k, v, what, causal=True,
                                window=window)
    del got
    flops = fa.attention_flops(B, Hq, Sq, Skv, D, causal=True, window=window)
    nbytes = 2 * (q.nelement() + k.nelement() + v.nelement()
                  + q.nelement())
    bound = max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
    if window is None:
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, scale=1.0 / D ** 0.5, enable_gqa=True)
        call = ("F.scaled_dot_product_attention(q, k, v, is_causal=True, "
                "enable_gqa=True)")
    else:
        i = torch.arange(Sq, device=DEV)[:, None]
        j = torch.arange(Skv, device=DEV)[None, :]
        band = (j <= i) & (j > i - window)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=band, scale=1.0 / D ** 0.5, enable_gqa=True)
        call = ("F.scaled_dot_product_attention(q, k, v, attn_mask=band, "
                f"enable_gqa=True), band = causal window {window}")
    ms = cuda_ms(run)
    out = {
        "shape": f"q ({B}, {Hq}, {Sq}, {D}), k/v ({B}, {Hkv}, {Skv}, {D}) "
                 "bfloat16, causal"
                 + (f", window {window}" if window is not None else ""),
        "ms": ms, "tflops": flops / ms / 1e9,
        "plain_ms": cuda_ms(lambda: ref.flash_ref(q, k, v, causal=True,
                                                  window=window)),
        "library_ms": cuda_ms(sdpa), "library_call": call,
        "bound_ms": bound * 1e3, "flops": flops, "bytes": nbytes,
        "bound_by": "operations" if flops / PEAK_FLOPS["bfloat16"]
        >= nbytes / HBM_BYTES_PER_S else "bytes",
        "max_abs_err": err, "ulp_gate_share": share,
        "split_excess": excess}
    log(f"[flash {what}] {out['ms']:.3f} ms, {out['tflops']:.1f} TFLOP/s "
        f"(bound {out['bound_ms']:.3f}, plain {out['plain_ms']:.3f}, "
        f"sdpa {out['library_ms']:.3f})")
    del q, k, v
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: the recurrence kernels against their plain versions
# ---------------------------------------------------------------------------
RG_LRU_SHAPE = (4, 4096, 2560)          # recurrentgemma-2b's prefill scan
MLSTM_SHAPE = (16, 2048, 512)           # xlstm-350m's: (B*H, S, d)
# (B, S, D, with h0)
RG_LRU_SWEEP = [(3, 1000, 1000, True), (1, 17, 33, False),
                (2, 4096, 2560, True), (1, 1, 2560, True), (2, 70, 8, True)]
# (BH, S, d, i offset, f offset): S < 64, S = 65, head dims 16 / 64 /
# 512 / 1024 (the tensor-core route) and 24 (the FMA route in 16 bits)
MLSTM_SWEEP = [(4, 40, 16, 0.0, 2.0), (2, 1000, 64, 0.0, 2.0),
               (2, 130, 512, 0.0, 2.0), (3, 300, 64, -30.0, 2.0),
               (3, 300, 64, 0.0, 60.0), (1, 63, 512, -30.0, 60.0),
               (2, 65, 64, 0.0, 2.0), (1, 130, 1024, 0.0, 2.0),
               (2, 150, 24, 0.0, 2.0)]
# bfloat16 / float16 h against the f32 recurrence on the kernel's own
# rounded, scaled q and k: within half an output ulp plus this share of
# max|h| (the exact result rounds once; the slack covers f32 summation
# order)
MLSTM_CONTRACT_ATOL = 1e-4


def rg_lru_inputs(gen, shape, dtype, with_h0=False):
    """Unit-scale inputs: x ~ N(0, 1), decays in (0.5, 0.99)."""
    import torch
    B, S, D = shape
    dt = torch_dtype(dtype)
    x = torch.randn(shape, generator=gen, device=DEV).to(dt)
    a = (0.5 + 0.49 * torch.rand(shape, generator=gen, device=DEV)).to(dt)
    h0 = torch.randn((B, D), generator=gen, device=DEV) if with_h0 \
        else None
    return x, a, h0


def rg_lru_close(gate, got, want, dtype, what):
    """Within 1e-5 absolute in f32: nvcc contracts a*h + b into one FMA
    where the plain version rounds the product first.  A 16-bit h_seq may
    differ from the plain one by the last bit of its own rounding
    (relative 2^-7 in bfloat16)."""
    import torch
    (hs, hl), (ws, wl) = got, want
    rtol = 2 ** -7 if dtype == "bfloat16" else 0.0
    err = max(float((hs.float() - ws.float()).abs().max()),
              float((hl - wl).abs().max()))
    gate.check(bool(torch.isfinite(hs.float()).all())
               and bool(torch.isclose(hs.float(), ws.float(), atol=1e-5,
                                      rtol=rtol).all())
               and bool(torch.isclose(hl, wl, atol=1e-5, rtol=0).all()),
               f"rg_lru {what} {dtype}: max|err| {err}")
    return err


def mlstm_inputs(gen, shape, dtype, i_off=0.0, f_off=2.0):
    import torch
    BH, S, d = shape
    dt = torch_dtype(dtype)
    q, k, v = (torch.randn(shape, generator=gen, device=DEV).to(dt)
               for _ in range(3))
    ig = (torch.randn((BH, S), generator=gen, device=DEV) + i_off).to(dt)
    fg = (torch.randn((BH, S), generator=gen, device=DEV) + f_off).to(dt)
    return q, k, v, ig, fg


def mlstm_close(gate, got, want, dtype, what):
    """float32: h within 5e-4 of max|h|, C and n within 1e-3, m within
    1e-4 (the JAX package's chunkwise-vs-sequential tolerance).  bfloat16:
    the kernel scales q and k in bfloat16 as the Pallas wrapper does, the
    plain version in f32 — one rounding of each (2^-9): h within 1e-2 of
    max|h|, C and n within 1e-2 of their largest, m within 1e-3."""
    import torch
    (h, (C, n, m)), (hr, (Cr, nr, mr)) = got, want
    f32 = dtype == "float32"
    top = lambda t: float(t.float().abs().max()) + 1e-9  # noqa: E731
    err_h = float((h.float() - hr.float()).abs().max())
    ok = all(bool(torch.isfinite(t.float()).all()) for t in (h, C, n, m))
    ok &= err_h / top(hr) < (5e-4 if f32 else 1e-2)
    if f32:
        ok &= bool(torch.isclose(C, Cr, atol=1e-3, rtol=1e-3).all())
        ok &= bool(torch.isclose(n, nr, atol=1e-3, rtol=1e-3).all())
        ok &= bool(torch.isclose(m, mr, atol=1e-4, rtol=0).all())
    else:
        ok &= float((C - Cr).abs().max()) / top(Cr) < 1e-2
        ok &= float((n - nr).abs().max()) / top(nr) < 1e-2
        ok &= bool(torch.isclose(m, mr, atol=1e-3, rtol=1e-3).all())
    err = max(err_h, float((C - Cr).abs().max()))
    gate.check(ok, f"mlstm {what} {dtype}: max|err| h {err_h}, C "
               f"{float((C - Cr).abs().max())} (max|h| {top(hr)})")
    return err


def mlstm_contract_share(h, q, k, v, ig, fg):
    """The largest share of the contract gate that the 16-bit ``h`` of
    ``mlstm_chunkwise`` uses: ``|h - h32| / (ulp(h32) / 2 +
    MLSTM_CONTRACT_ATOL max|h32|)``, h32 the f32 recurrence on f32 copies
    of the kernel's rounded, scaled q and k."""
    import torch
    from repro_torch.kernels import ref

    dt, d = q.dtype, q.shape[-1]
    s = float(torch.tensor(1.0 / d ** 0.5).to(dt))
    qs, ks = ((t.float() * s).to(dt).float() for t in (q, k))
    want, _ = ref.mlstm_ref(qs, ks, v.float(), ig, fg, scale=1.0)
    mant = 8 if dt == torch.bfloat16 else 11
    _, e = torch.frexp(want)              # |want| in [2^(e-1), 2^e)
    half_ulp = torch.where(want == 0, 0.0, torch.ldexp(
        torch.ones_like(want), e.clamp_min(-125) - mant - 1))
    bound = half_ulp + MLSTM_CONTRACT_ATOL * float(want.abs().max())
    return float(((h.float() - want).abs() / bound).max())


def route_times(runs):
    """Each route's time (``runs``: route -> a call on it), per single call
    with the host's launch (``ms``) and in device time (``device_ms``)."""
    return {r: {"ms": cuda_ms(run), "device_ms": device_ms(run)}
            for r, run in runs.items()}


def phase_recurrence_kernels(report):
    """rg_lru and mlstm_chunkwise against their plain versions at the
    main paths' shapes and over a sweep, in float32 and bfloat16 (mlstm
    also in float16, both 16-bit types within the contract gate); each
    timed at its main path's shape and dtype (rg_lru: f32, as
    ``rglru_block`` feeds it; mlstm: bf16, the compute dtype, with f16 and
    the f32 FMA route beside it)."""
    import torch
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import ref
    from repro_torch.kernels import rg_lru as rl

    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    gate = Gate("recurrence kernels")
    out, sweep = {}, []
    for dtype in ("float32", "bfloat16", "float16"):
        for case in ([RG_LRU_SHAPE + (False,)] + RG_LRU_SWEEP
                     if dtype != "float16" else []):
            x, a, h0 = rg_lru_inputs(gen, case[:3], dtype, case[3])
            got = rl.rg_lru(x, a, h0)
            want = ref.rg_lru_ref(x, a, h0)
            # its route again and the simple route: the same bits
            route = rl.rg_lru_route(x, a)
            same = same_bits(got, rl.rg_lru(x, a, h0),
                             rl.rg_lru(x, a, h0, route="simple"))
            torch.cuda.synchronize()
            gate.check(same, f"rg_lru {case} {dtype}: the {route} route "
                       "twice and the simple route give other bits")
            sweep.append({"kernel": "rg_lru", "case": list(case),
                          "dtype": dtype, "route": route, "same_bits": same,
                          "max_abs_err": rg_lru_close(
                              gate, got, want, dtype, str(case))})
            del x, a, h0, got, want
        for case in [MLSTM_SHAPE + (0.0, 2.0)] + MLSTM_SWEEP:
            ins = mlstm_inputs(gen, case[:3], dtype, *case[3:])
            got = ml.mlstm_chunkwise(*ins)
            want = ref.mlstm_ref(*ins)
            torch.cuda.synchronize()
            row = {"kernel": "mlstm_chunkwise", "case": list(case),
                   "dtype": dtype, "route": "tensor cores"
                   if ml.tensor_core_route(*ins[:3]) else "fma",
                   "max_abs_err": mlstm_close(gate, got, want, dtype,
                                              str(case))}
            if dtype != "float32":
                row["contract_share"] = mlstm_contract_share(got[0], *ins)
                gate.check(row["contract_share"] <= 1.0,
                           f"mlstm {case} {dtype}: h beyond half an ulp + "
                           f"{MLSTM_CONTRACT_ATOL} max|h| of the f32 "
                           f"recurrence ({row['contract_share']} of it)")
            sweep.append(row)
            del ins, got, want
    torch.cuda.empty_cache()
    report["recurrence_sweep"] = sweep
    gate.close()

    def worst(kernel, dtype, key="max_abs_err"):
        return max(r[key] for r in sweep
                   if r["kernel"] == kernel and r["dtype"] == dtype)

    # rg_lru at recurrentgemma's prefill shape, f32
    B, S, D = RG_LRU_SHAPE
    x, a, _ = rg_lru_inputs(gen, RG_LRU_SHAPE, "float32")
    nbytes = x.nbytes + a.nbytes + x.nbytes + B * D * 4   # x, a, h, h_last
    flops = 8 * x.nelement()     # a*a, 1-, clip (2), sqrt, *x, fma (2)
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    route = rl.rg_lru_route(x, a)
    routes = route_times({r: (lambda r=r: rl.rg_lru(x, a, route=r))
                          for r in rl.ROUTES})
    out["rg_lru"] = {
        "shape": f"x, a ({B}, {S}, {D}) float32, no h0",
        "route": route, "ms": routes[route]["ms"],
        "device_ms": routes[route]["device_ms"], "routes": routes,
        "plain_ms": cuda_ms(lambda: ref.rg_lru_ref(x, a), reps=3, warm=1),
        "library_ms": None, "library_call": None,
        "bound_ms": max(b_bytes, b_ops) * 1e3, "bytes": nbytes,
        "flops": flops, "bound_by": "bytes" if b_bytes >= b_ops
        else "operations",
        "max_abs_err": worst("rg_lru", "float32"),
        "sweep_max_abs_err": {dt: worst("rg_lru", dt)
                              for dt in ("float32", "bfloat16")}}
    del x, a
    # mlstm_chunkwise at xlstm's prefill shape, bf16 (f16 and the f32
    # FMA route timed beside it)
    BH, S, d = MLSTM_SHAPE
    ins = mlstm_inputs(gen, MLSTM_SHAPE, "bfloat16")
    q = ins[0]
    nbytes = (sum(t.nbytes for t in ins) + q.nbytes       # inputs, h
              + BH * d * d * 4 + BH * d * 4 + BH * 4)     # C, n, m
    flops = ml.mlstm_flops(BH, S, d)
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]
    run = lambda: ml.mlstm_chunkwise(*ins)  # noqa: E731
    ms = cuda_ms(run)
    other = {}
    for dtype in ("float16", "float32"):
        o = mlstm_inputs(gen, MLSTM_SHAPE, dtype)
        other[dtype] = cuda_ms(lambda: ml.mlstm_chunkwise(*o))
        del o
    out["mlstm_chunkwise"] = {
        "shape": f"q, k, v ({BH}, {S}, {d}) bfloat16, gates ({BH}, {S})",
        "ms": ms, "device_ms": device_ms(run, reps=5),
        "tflops": flops / ms / 1e9,
        "float16_ms": other["float16"], "float32_ms": other["float32"],
        "plain_ms": cuda_ms(lambda: ref.mlstm_ref(*ins), reps=3, warm=1),
        "library_ms": None, "library_call": None,
        "bound_ms": max(b_bytes, b_ops) * 1e3, "bytes": nbytes,
        "flops": flops, "bound_by": "bytes" if b_bytes >= b_ops
        else "operations",
        "max_abs_err": worst("mlstm_chunkwise", "bfloat16"),
        "sweep_max_abs_err": {dt: worst("mlstm_chunkwise", dt)
                              for dt in ("float32", "bfloat16", "float16")},
        "sweep_max_contract_share": {
            dt: worst("mlstm_chunkwise", dt, "contract_share")
            for dt in ("bfloat16", "float16")}}
    del ins, q
    torch.cuda.empty_cache()
    for name, t in out.items():
        log(f"[{name}] {t['ms']:.3f} ms (bound {t['bound_ms']:.3f} "
            f"{t['bound_by']}, plain {t['plain_ms']:.3f}); sweep max|err| "
            f"{t['sweep_max_abs_err']}")
    log(f"[rg_lru] {out['rg_lru']['route']} route; routes "
        f"{out['rg_lru']['routes']}")
    report["recurrence_kernels"] = out
    return out


# ---------------------------------------------------------------------------
# phase 11: the MoE dispatch kernels against their plain versions
# ---------------------------------------------------------------------------
# deepseek-v2-lite's MoE at 4 x 4096 tokens: T tokens, E experts, top-K,
# d_model; capacity int(1.25 * T * K / E) = 1920 rows an expert
MOE_PREFILL = (16384, 64, 6, 2048)
MOE_DECODE = (4, 64, 6, 2048)           # B = 4: capacity min(T, 64) = 4
# gather (N, M, D): aligned and unaligned rows, M = 0, N = 1, repeats
GATHER_SWEEP = [(300, 500, 2048), (50, 64, 24), (37, 100, 13), (1, 9, 24),
                (20, 0, 24), (4097, 2048, 2048)]
# combine (T, K, S, D): K = 1, 8 and 16, unaligned D, tokens on either
# side of moe_dispatch.RING_MIN_TOKENS
COMBINE_SWEEP = [(200, 6, 640, 2048), (33, 1, 40, 24), (50, 8, 400, 24),
                 (17, 6, 60, 13), (300, 16, 900, 512), (40, 16, 300, 2048)]


def moe_tables(gen, shape):
    """A routing of ``shape``'s tokens as the main path makes it (top-K
    of random router scores, capacity dispatch): the gather's (x, src)
    and the combine's (y, slots, weights), bfloat16 rows."""
    import torch
    from repro_torch.models import moe as M

    T, E, K, D = shape
    cap = max(int(1.25 * T * K / E), min(T, 64))
    scores = torch.randn((T, E), generator=gen, device=DEV)
    w, idx = torch.softmax(scores, -1).topk(K, dim=-1)
    src, slot = M.dispatch_tables(idx.to(torch.int32), E, cap)
    x = torch.randn((T + 1, D), generator=gen, device=DEV).to(
        torch.bfloat16)
    x[T] = 0                                      # the empty rows' source
    y = torch.randn((E * cap, D), generator=gen, device=DEV).to(
        torch.bfloat16)
    return x, src, y, slot.view(T, K).to(torch.int32), w / w.sum(-1,
                                                                 keepdim=True)


def ulp(x, dtype):
    """One unit in the last place of ``x`` in a 16-bit ``dtype``."""
    import torch
    bits = {"bfloat16": 8, "float16": 11}[dtype]
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -14)))
    return torch.exp2(e - (bits - 1))


def combine_close(gate, got, want, y, slots, w, dtype, what):
    """The kernel and the plain version both sum the K products in f32,
    in their own order: within 1e-6 of the row's largest |w * y| term;
    a 16-bit output adds one ulp of its own rounding."""
    import torch
    ok = slots >= 0
    terms = (w[:, :, None] * y[slots.clamp(min=0).long()].float()
             * ok[:, :, None]).abs().amax(dim=(1, 2)) \
        if slots.numel() else w.new_zeros(slots.shape[0])
    err = (got.float() - want.float()).abs()
    tol = 1e-6 * terms[:, None]
    if dtype != "float32":
        tol = tol + ulp(torch.maximum(got.float().abs(),
                                      want.float().abs()), dtype)
    gate.check(bool(torch.isfinite(got.float()).all())
               and bool((err <= tol).all()),
               f"moe_combine {what} {dtype}: max|err| "
               f"{float(err.max()) if err.numel() else 0.0}")
    return float(err.max()) if err.numel() else 0.0


def combine_same_bits(gate, y, slots, w, got, what):
    """Hold ``got``, the combine's first launch on these inputs, against a
    second launch and against every route the inputs allow (the simple
    route always): the same bits.  Returns the route it took."""
    import torch
    from repro_torch.kernels import moe_dispatch as md

    route = md.combine_route(y, slots)
    others = [md.moe_combine(y, slots, w)] + [
        md.moe_combine(y, slots, w, route=r) for r in md.COMBINE_ROUTES
        if route != "simple" or r == "simple"]
    torch.cuda.synchronize()
    gate.check(same_bits(got, *others), f"moe_combine {what}: the {route} "
               "route twice and the other routes give other bits")
    return route


def phase_moe_kernels(report):
    """gather_rows and moe_combine against their plain versions at
    deepseek's prefill and decode shapes and over a sweep, in float32,
    bfloat16 and float16; each timed at both shapes."""
    import torch
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref

    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    gate = Gate("moe kernels")
    sweep = []
    for shape in (MOE_PREFILL, MOE_DECODE):
        x, src, y, slots, w = moe_tables(gen, shape)
        got = md.gather_rows(x, src)
        gate.check(torch.equal(got, ref.gather_rows_ref(x, src)),
                   f"gather_rows at {shape}")
        got = md.moe_combine(y, slots, w)
        want = ref.moe_combine_ref(y, slots, w)
        torch.cuda.synchronize()
        sweep.append({"kernel": "moe_combine", "case": list(shape),
                      "dtype": "bfloat16", "route": combine_same_bits(
                          gate, y, slots, w, got, str(shape)),
                      "max_abs_err": combine_close(
                          gate, got, want, y, slots, w, "bfloat16",
                          str(shape))})
        del x, src, y, slots, w, got, want
    for dtype in ("float32", "bfloat16", "float16"):
        dt = torch_dtype(dtype)
        for N, M, D in GATHER_SWEEP:
            x = torch.randn((N, D), generator=gen, device=DEV).to(dt)
            idx = torch.randint(0, N, (M,), generator=gen, device=DEV,
                                dtype=torch.int32)
            if N > 1000:
                idx = idx % 7                     # mostly repeated rows
            got = md.gather_rows(x, idx)
            torch.cuda.synchronize()
            gate.check(torch.equal(got, ref.gather_rows_ref(x, idx)),
                       f"gather_rows {(N, M, D)} {dtype}")
        for Tn, K, S, D in COMBINE_SWEEP:
            y = torch.randn((S, D), generator=gen, device=DEV).to(dt)
            w = torch.rand((Tn, K), generator=gen, device=DEV)
            for lo in (-1, -S):                   # some dropped; all
                slots = torch.randint(lo, S, (Tn, K), generator=gen,
                                      device=DEV, dtype=torch.int32)
                if lo == -S:
                    slots = slots.clamp(max=-1)
                got = md.moe_combine(y, slots, w)
                want = ref.moe_combine_ref(y, slots, w)
                torch.cuda.synchronize()
                sweep.append({"kernel": "moe_combine",
                              "case": [Tn, K, S, D, lo], "dtype": dtype,
                              "route": combine_same_bits(
                                  gate, y, slots, w, got,
                                  f"{(Tn, K, S, D, lo)} {dtype}"),
                              "max_abs_err": combine_close(
                                  gate, got, want, y, slots, w, dtype,
                                  str((Tn, K, S, D, lo)))})
    torch.cuda.empty_cache()
    report["moe_sweep"] = sweep
    gate.close()

    x, src, y, slots, w = moe_tables(gen, MOE_PREFILL)
    T, E, K, D = MOE_PREFILL
    item = x.element_size()
    rows_read = int((slots >= 0).sum())
    out = {}
    # each input byte read once (the distinct rows the table names),
    # each output byte written once
    nbytes = (int(torch.unique(src).numel()) * D * item + src.nbytes
              + src.numel() * D * item)
    out["gather_rows"] = {
        "shape": f"x ({T + 1}, {D}) bfloat16, idx ({src.numel()},) int32",
        "ms": cuda_ms(lambda: md.gather_rows(x, src)),
        "plain_ms": cuda_ms(lambda: ref.gather_rows_ref(x, src)),
        "library_ms": cuda_ms(lambda: torch.index_select(x, 0, src)),
        "library_call": "torch.index_select(x, 0, idx)",
        "bound_ms": bound_ms(nbytes), "bytes": nbytes, "bound_by": "bytes",
        "max_abs_err": 0.0}
    nbytes = (rows_read * D * item + T * D * item       # rows read, out
              + slots.nbytes + w.nbytes)
    route = md.combine_route(y, slots)
    routes = route_times({r: (lambda r=r: md.moe_combine(y, slots, w,
                                                         route=r))
                          for r in md.COMBINE_ROUTES})
    out["moe_combine"] = {
        "shape": f"y ({y.shape[0]}, {D}) bfloat16, slots and weights "
                 f"({T}, {K}), {rows_read} slots live",
        "route": route, "ms": routes[route]["ms"],
        "device_ms": routes[route]["device_ms"], "routes": routes,
        "plain_ms": cuda_ms(lambda: ref.moe_combine_ref(y, slots, w)),
        "library_ms": None,
        "library_call": "none: no one-call equivalent",
        "bound_ms": bound_ms(nbytes), "bytes": nbytes, "bound_by": "bytes",
        "max_abs_err": max(r["max_abs_err"] for r in sweep
                           if r["dtype"] == "bfloat16")}
    out["moe_combine"]["sweep_max_abs_err"] = {
        dt: max(r["max_abs_err"] for r in sweep if r["dtype"] == dt)
        for dt in ("float32", "bfloat16", "float16")}
    del x, src, y, slots, w
    # the decode shape (every serving step launches both kernels): per
    # single call, and in device time, where the launch no longer hides
    x, src, y, slots, w = moe_tables(gen, MOE_DECODE)
    T, E, K, D = MOE_DECODE
    rows_read = int((slots >= 0).sum())
    nbytes = (int(torch.unique(src).numel()) * D * item + src.nbytes
              + src.numel() * D * item)
    run = lambda: md.gather_rows(x, src)  # noqa: E731
    lib = lambda: torch.index_select(x, 0, src)  # noqa: E731
    out["gather_rows"]["decode"] = {
        "shape": f"x ({T + 1}, {D}) bfloat16, idx ({src.numel()},) int32",
        "ms": cuda_ms(run), "device_ms": device_ms(run),
        "library_ms": cuda_ms(lib), "library_device_ms": device_ms(lib),
        "bound_ms": bound_ms(nbytes), "bytes": nbytes}
    nbytes = (rows_read * D * item + T * D * item
              + slots.nbytes + w.nbytes)
    route = md.combine_route(y, slots)
    routes = route_times({r: (lambda r=r: md.moe_combine(y, slots, w,
                                                         route=r))
                          for r in md.COMBINE_ROUTES})
    out["moe_combine"]["decode"] = {
        "shape": f"y ({y.shape[0]}, {D}) bfloat16, slots and weights "
                 f"({T}, {K}), {rows_read} slots live",
        "route": route, "ms": routes[route]["ms"],
        "device_ms": routes[route]["device_ms"], "routes": routes,
        "bound_ms": bound_ms(nbytes), "bytes": nbytes}
    del x, src, y, slots, w
    torch.cuda.empty_cache()
    for name, t in out.items():
        log(f"[{name}] {t['ms']:.3f} ms (bound {t['bound_ms']:.3f} bytes, "
            f"plain {t['plain_ms']:.3f}, library {t['library_ms']}); "
            f"decode shape {t['decode']}")
    report["moe_kernels"] = out
    return out


# ---------------------------------------------------------------------------
# phases 5, 8, 9: a language model's prefill and decode at full width and
# depth
# ---------------------------------------------------------------------------
DECODE_STEPS = 32
F32_TOL = 1e-3          # fused vs composite in f32 compute
BF16_TOL = 3e-2         # tests/test_arch_smoke.py's bf16 tolerance
# in bf16 the fused path's distance to the f32 run may exceed the plain
# path's by this factor at most
BF16_MARGIN = 1.25
# share of the card's memory the f32 gate's weights and their bf16 cast
# may take (``gate_depth``)
F32_FIT = 0.5


def _slot(i, name, layer=None):
    """State leaf ``name`` of scan slot ``i`` (all periods, or one)."""
    def get(st):
        leaf = st["scan"][i][name]
        return leaf if layer is None else leaf[layer]
    return get


# Each model: its config and published widths (n_layers, d_model,
# n_heads, n_kv_heads, head_dim, d_ff, vocab_padded), the prefill batch,
# prompt and cache, the launches of one fused prefill, the decode-state
# leaves held fused vs composite in f32 (and, named in ``bf16``, against
# the f32 run in bf16), and the integer leaves that must be equal.
LM = {
    "qwen2": {
        "config": "qwen2_1_5b",
        "widths": (28, 1536, 12, 2, 128, 8960, 152064),
        "batch": 4, "prompt": 4096, "s_cache": 4160,
        "launches": {"flash_attention": 28},
        "leaves": {"cache_k": _slot(0, "k"), "cache_v": _slot(0, "v")},
        "bf16": ("cache_k", "cache_v"),
        "exact": (_slot(0, "pos"),),
    },
    "recurrentgemma": {
        "config": "recurrentgemma_2b",
        "widths": (26, 2560, 10, 1, 256, 7680, 256000),
        "batch": 4, "prompt": 4096, "s_cache": 4160,
        "launches": {"rg_lru": 18, "rg_lru:tma": 18, "flash_attention": 8},
        "leaves": {"rec_h": _slot(0, "h"),
                   "rec_conv_tail": _slot(0, "conv_tail"),
                   "suffix_rec_h": lambda st: st["suffix"][1]["h"],
                   "cache_k": _slot(2, "k"), "cache_v": _slot(2, "v")},
        "bf16": ("rec_h", "cache_k", "cache_v"),
        "exact": (_slot(2, "pos"),),
    },
    "xlstm": {
        "config": "xlstm_350m",
        "widths": (24, 1024, 4, 4, 256, 0, 50432),
        "batch": 4, "prompt": 2048, "s_cache": 2112,
        "launches": {"mlstm_chunkwise": 21},
        "leaves": {"mlstm_C": _slot(0, "C"), "mlstm_n": _slot(0, "n"),
                   "mlstm_m": _slot(0, "m"),
                   "mlstm_C_layer0": _slot(0, "C", 0),
                   "slstm_h": _slot(7, "h"), "slstm_c": _slot(7, "c")},
        "bf16": ("mlstm_C_layer0",),
        "exact": (),
    },
    # phases 15-17, the dense configs at their published widths (the
    # reference's configs; ROADMAP.md section 3 lists where they depart
    # from the published models).  arXiv:2503.01743 (phi-4-mini): 32
    # layers, d_model 3072, 24 / 8 heads of 128, d_ff 8192, vocab 200064
    "phi4": {
        "config": "phi4_mini_3_8b",
        "widths": (32, 3072, 24, 8, 128, 8192, 200192),
        "batch": 4, "prompt": 4096, "s_cache": 4160,
        "launches": {"flash_attention": 32},
        "leaves": {"cache_k": _slot(0, "k"), "cache_v": _slot(0, "v")},
        "bf16": ("cache_k", "cache_v"),
        "exact": (_slot(0, "pos"),),
        "layer1": _slot(0, "k", 1),
    },
    # Gemma 3 12B (Hugging Face google/gemma-3-12b-pt config): 48 layers,
    # 5 local (window 1024) : 1 global, d_model 3840, 16 / 8 heads of
    # 256, d_ff 15360, vocab 262144, QK norm
    "gemma3": {
        "config": "gemma3_12b",
        "widths": (48, 3840, 16, 8, 256, 15360, 262144),
        "batch": 4, "prompt": 4096, "s_cache": 4160,
        "launches": {"flash_attention": 48},
        "leaves": {"local_k": _slot(0, "k"), "local_v": _slot(0, "v"),
                   "global_k": _slot(5, "k"), "global_v": _slot(5, "v")},
        "bf16": ("local_k", "global_k"),
        "exact": (_slot(0, "pos"), _slot(5, "pos")),
        "layer1": _slot(1, "k", 0),
    },
    # arXiv:2408.00118 (Gemma 2 27B): 46 layers alternating local
    # (window 4096) and global, d_model 4608, 32 / 16 heads of 128, d_ff
    # 36864, vocab 256000, attention softcap 50, final softcap 30; two
    # prompts of 8192 so the local window masks
    "gemma2": {
        "config": "gemma2_27b",
        "widths": (46, 4608, 32, 16, 128, 36864, 256000),
        "batch": 2, "prompt": 8192, "s_cache": 8256,
        "launches": {"flash_attention": 46},
        "leaves": {"local_k": _slot(0, "k"), "local_v": _slot(0, "v"),
                   "global_k": _slot(1, "k"), "global_v": _slot(1, "v")},
        "bf16": ("local_k", "global_k"),
        "exact": (_slot(0, "pos"), _slot(1, "pos")),
        "layer1": _slot(1, "k", 0),
    },
    # arXiv:2405.04434 and DeepSeek-V2-Lite's config.json (Hugging Face):
    # 27 layers, d_model 2048, 16 heads, d_ff 10944, vocab 102400; MoE
    # (64 routed experts top-6, 2 shared, d_ff 1408, first layer dense);
    # MLA (kv_lora 512, qk 128 + 64, v 128); phase 12 drives it
    "deepseek": {
        "config": "deepseek_v2_lite_16b",
        "widths": (27, 2048, 16, 16, 128, 10944, 102400),
        "moe_mla": (64, 6, 2, 1408, 1, 512, 0, 128, 64, 128),
        "batch": 4, "prompt": 4096, "s_cache": 4160,
        "launches": {"flash_attention": 27, "gather_rows": 26,
                     "moe_combine": 26, "moe_combine:bulk": 26},
        "layer1": _slot(0, "ckv", 0),
    },
}


def lm_config(key):
    """The model at its published widths and full depth."""
    from repro_torch.configs import get_config

    spec = LM[key]
    cfg = get_config(spec["config"])
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_padded)
            == spec["widths"], f"{cfg.name} config")
    if "moe_mla" in spec:
        require((cfg.n_experts, cfg.top_k, cfg.n_shared_experts,
                 cfg.d_ff_expert, cfg.first_dense_layers, cfg.kv_lora_rank,
                 cfg.q_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                 cfg.v_head_dim) == spec["moe_mla"],
                f"{cfg.name} MoE / MLA config")
    slots = [s.mixer for s in cfg.layer_slots()]
    n_moe = [s.ffn for s in cfg.layer_slots()].count("moe")
    per_kernel = {"flash_attention": sum(m.startswith(("attn", "mla"))
                                         for m in slots),
                  "rg_lru": slots.count("rec"),
                  "mlstm_chunkwise": slots.count("mlstm"),
                  "gather_rows": n_moe, "moe_combine": n_moe}
    kernels = {k: v for k, v in spec["launches"].items()
               if ":" not in k}              # without the counts by route
    require({k: v for k, v in per_kernel.items() if v} == kernels,
            f"{cfg.name}: layer slots {per_kernel} != {kernels}")
    return cfg


def lm_params(cfg, master=True):
    """f32 master parameters from the seed and their compute cast (made
    once); or, with ``master=False``, only the compute parameters, drawn
    in the compute dtype: the same values without the f32 copy (a full
    deepseek-v2-lite is 63 GB in f32)."""
    import dataclasses

    from repro_torch.models import transformer as T
    from repro_torch.models import zoo
    if not master:
        return None, T.cast_params(zoo.init_params(
            dataclasses.replace(cfg, param_dtype=cfg.dtype), SEED,
            device=DEV), cfg)
    master = zoo.init_params(cfg, SEED, device=DEV)
    return master, T.cast_params(master, cfg)


def f32_close(gate, a, b, what):
    """f32 compute, fused vs composite: every element within 1e-3
    (absolute and relative) — a kernel fault shows here."""
    import torch
    a, b = a.float(), b.float()
    err = float((a - b).abs().max())
    gate.check(bool(torch.isfinite(a).all()) and bool(
        torch.isclose(a, b, atol=F32_TOL, rtol=F32_TOL).all()),
        f"{what} (float32): fused vs composite max|err| {err} > {F32_TOL}")
    return err


def bf16_close(gate, fused, plain, truth, what):
    """bf16 compute: both paths are held against the f32 run of the same
    inputs.  Rounding the residual stream to bf16 in every layer moves
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
    gate.check(bool(torch.isfinite(f).all())
               and out["max_vs_f32"] <= BF16_MARGIN * out["plain_max_vs_f32"]
               and out["rel_l2_vs_f32"] <= BF16_MARGIN
               * out["plain_rel_l2_vs_f32"],
               f"{what} (bfloat16): the fused path is further from the f32 "
               f"run than the plain path: {out}")
    return out


def prefill(cfg, params, tokens, impl, s_cache):
    """One prefill; returns (state, last logits, wall seconds)."""
    import torch
    from repro_torch.models import Parallel
    from repro_torch.models import transformer as T

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, lg = T.prefill_forward(params, cfg, Parallel(), {"tokens": tokens},
                               s_cache, impl=impl)
    torch.cuda.synchronize()
    require(tuple(lg.shape) == (tokens.shape[0], cfg.vocab_padded),
            f"prefill logits of shape {tuple(lg.shape)}")
    return st, lg, time.perf_counter() - t0


def decode(cfg, params, st, follow, impl=None):
    """Teacher-forced decode of ``follow`` (steps, B, 1) from ``st``;
    returns the logits of every step and the median ms per step."""
    import torch
    from repro_torch.models import Parallel
    from repro_torch.models import transformer as T

    logits, times = [], []
    for tok in follow:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, lg = T.decode_step(params, cfg, Parallel(), st, tok, impl=impl)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg)
    return torch.stack(logits), statistics.median(times)


def gate_depth(cfg):
    """The full depth if the model's f32 weights and their bf16 cast (6
    bytes a parameter) take at most ``F32_FIT`` of the card's memory
    (the rest holds both paths' states and the prefill's activations),
    else the largest depth in whole pattern periods that does."""
    import dataclasses

    import torch
    total = torch.cuda.get_device_properties(0).total_memory
    fits = lambda d: 6 * dataclasses.replace(  # noqa: E731
        cfg, n_layers=d).param_counts()["total"] <= F32_FIT * total
    if fits(cfg.n_layers):
        return cfg.n_layers
    period = len(cfg.pattern)
    depths = [d for d in range(period, cfg.n_layers, period) if fits(d)]
    return max(depths, default=min(period, cfg.n_layers))


def phase_lm(key, report, main_launches):
    """f32 compute first: fused vs composite within 1e-3 (a kernel fault
    shows there), and the composite run is the reference of the bf16
    runs.  Then bf16: the fused prefill, the composite one, and 32
    decode steps from each state, teacher-forced with the f32 fused
    run's greedy tokens.  Both run at ``gate_depth``; where that is the
    full depth the bf16 run is the main path (counted), else the main
    path runs at full depth in :func:`lm_full_depth`."""
    import dataclasses

    import torch
    from repro_torch.models import Parallel
    from repro_torch.models import transformer as T

    spec = LM[key]
    cfg = lm_config(key)
    depth = gate_depth(cfg)
    full = depth == cfg.n_layers
    cfg_g = cfg if full else dataclasses.replace(cfg, n_layers=depth)
    B, S, s_cache = spec["batch"], spec["prompt"], spec["s_cache"]
    leaves = spec["leaves"]
    gate = Gate(key)
    c32 = dataclasses.replace(cfg_g, dtype="float32")
    master, params = lm_params(cfg_g)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=DEV, dtype=torch.int32)
    out = {"config": cfg.name, "batch": B, "prompt": S, "s_cache": s_cache,
           "decode_steps": DECODE_STEPS, "gate_depth": depth}
    times = {}
    log(f"[{key}] f32 gate at depth {depth} of {cfg.n_layers}")

    # f32: kernel vs plain version, and the reference of the bf16 runs
    t0 = time.perf_counter()
    st_f, lg_f, wall_f = prefill(c32, master, tokens, "fused", s_cache)
    st_c, lg_c, wall_fc = prefill(c32, master, tokens, "composite", s_cache)
    e32 = {"prefill_logits": f32_close(gate, lg_f, lg_c, "prefill logits")}
    for name, get in leaves.items():
        e32[name] = f32_close(gate, get(st_f), get(st_c), name)
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
    e32["decode_logits"] = f32_close(gate, dl_f, dl_c, "decode logits")
    truth = {"prefill_logits": lg_c, "decode_logits": dl_c}
    truth.update({n: leaves[n](st_c) for n in spec["bf16"]})
    out["float32"] = {"max_abs_err": e32, "prefill_s": wall_f,
                      "composite_prefill_s": wall_fc,
                      "prefill_tokens_per_s": B * S / wall_f,
                      "decode_ms_per_step": ms32}
    times["float32_s"] = time.perf_counter() - t0
    del st_f, st_c, lg_f, dl_f, master
    torch.cuda.empty_cache()

    # bf16 at the gate depth: the main path (counted from zero) when
    # that is the full depth
    t0 = time.perf_counter()
    if full:
        reset_counts()
    st_f, lg_f, wall = prefill(cfg_g, params, tokens, "fused", s_cache)
    if full:
        read_counts(main_launches)
    st_c, lg_c, wall_c = prefill(cfg_g, params, tokens, "composite",
                                 s_cache)
    e16 = {"prefill_logits": bf16_close(gate, lg_f, lg_c,
                                        truth["prefill_logits"],
                                        "prefill logits")}
    for name in spec["bf16"]:
        e16[name] = bf16_close(gate, leaves[name](st_f), leaves[name](st_c),
                               truth[name], name)
    for get in spec["exact"]:
        gate.check(torch.equal(get(st_f), get(st_c)), "cache positions")
    gate.check(torch.equal(st_f["pos"], st_c["pos"]), "state positions")
    dl_f, ms = decode(cfg_g, params, st_f, follow)
    dl_c, _ = decode(cfg_g, params, st_c, follow)
    e16["decode_logits"] = bf16_close(gate, dl_f, dl_c,
                                      truth["decode_logits"],
                                      "decode logits")
    out["bfloat16" if full else "bfloat16_gate"] = {
        "errors": e16, "prefill_s": wall, "composite_prefill_s": wall_c,
        "prefill_tokens_per_s": B * S / wall, "decode_ms_per_step": ms}
    times["bfloat16_s" if full else "bfloat16_gate_s"] = \
        time.perf_counter() - t0
    log(f"[{key}] errors f32 {e32}, bf16 {e16}")
    del st_f, st_c, lg_f, lg_c, dl_f, dl_c, truth, params
    torch.cuda.empty_cache()
    if not full:
        t0 = time.perf_counter()
        out["bfloat16"] = lm_full_depth(key, cfg, tokens, follow, gate,
                                        main_launches)
        times["bfloat16_s"] = time.perf_counter() - t0
    out["times"] = times
    for dt in ("float32", "bfloat16"):
        r = out[dt]
        log(f"[{key} {dt}] prefill {r['prefill_s']:.3f} s "
            f"({r['prefill_tokens_per_s']:.0f} tok/s; composite "
            f"{r['composite_prefill_s']:.3f} s), decode "
            f"{r['decode_ms_per_step']:.2f} ms/step")
    for name, n in spec["launches"].items():
        gate.check(main_launches.get(name) == n,
                   f"fused prefill launched {name} "
                   f"{main_launches.get(name)} times, not {n}")
    report[key] = out
    gate.close()


def lm_full_depth(key, cfg, tokens, follow, gate, main_launches,
                  extra=None):
    """The bf16 main path at full depth, parameters drawn in the compute
    dtype (no f32 run of this depth fits beside it): the counted fused
    prefill, the composite one, 32 decode steps from each.  Checks:
    every logit and state leaf finite; layer 1's cache (``layer1`` in
    the model's ``LM`` entry, the first downstream of a flash launch)
    fused vs composite within 1e-2 in relative L2: its input differs
    from layer 0's flash launch by bf16 rounding, which compounds to a
    few ulps at the largest elements, while a fault is O(1).  The
    logits' fused-vs-composite distance is reported.  ``extra(params)``,
    if given, runs the model's own checks on the full-depth parameters
    and returns entries for the report."""
    import torch
    from torch.utils import _pytree as pytree

    spec = LM[key]
    B, S, s_cache = spec["batch"], spec["prompt"], spec["s_cache"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the blocks the init's draws leave cached serve the prefill, which
    # so times no fresh cudaMalloc
    _, params = lm_params(cfg, master=False)
    # one path at a time, prefill then decode, so one prefill state is
    # alive at a time (gemma2-27b's weights leave ~25 GB for states,
    # decode clones and activations)
    reset_counts()
    st_f, lg_f, wall = prefill(cfg, params, tokens, "fused", s_cache)
    read_counts(main_launches)
    l1f = spec["layer1"](st_f).float()
    finite = [all(bool(torch.isfinite(x.float()).all())
                  for x in pytree.tree_leaves(st_f))]
    dl_f, ms = decode(cfg, params, st_f, follow, "fused")
    del st_f
    st_c, lg_c, wall_c = prefill(cfg, params, tokens, "composite", s_cache)
    l1c = spec["layer1"](st_c).float()
    finite.append(all(bool(torch.isfinite(x.float()).all())
                      for x in pytree.tree_leaves(st_c)))
    dl_c, ms_c = decode(cfg, params, st_c, follow, "composite")
    del st_c
    gate.check(all(finite), f"decode state not finite (fused, composite: "
               f"{finite})")
    for name, t in (("prefill logits", lg_f), ("composite prefill logits",
                                               lg_c),
                    ("decode logits", dl_f), ("composite decode logits",
                                              dl_c)):
        gate.check(bool(torch.isfinite(t).all()), f"{name} not finite")
    err_l1 = float((l1f - l1c).abs().max())
    rel_l1 = float((l1f - l1c).norm() / l1c.norm())
    gate.check(bool(torch.isfinite(l1f).all()) and rel_l1 <= 1e-2,
               f"layer 1 cache: fused vs composite relative L2 {rel_l1} > "
               f"1e-2 (max|err| {err_l1})")
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    out = {"prefill_s": wall, "composite_prefill_s": wall_c,
           "prefill_tokens_per_s": B * S / wall,
           "decode_ms_per_step": ms, "composite_decode_ms_per_step": ms_c,
           "layer1_cache_max_abs_err": err_l1,
           "layer1_cache_rel_l2": rel_l1,
           # reported, not gated: no f32 run of this depth fits the card
           "logits_fused_vs_composite": {
               "prefill_max": float((lg_f - lg_c).abs().max()),
               "prefill_rel_l2": rel(lg_f, lg_c),
               "decode_max": float((dl_f - dl_c).abs().max()),
               "decode_rel_l2": rel(dl_f, dl_c)}}
    if extra is not None:
        out.update(extra(params))
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[{key} bf16 full depth] prefill {wall:.3f} s "
        f"({out['prefill_tokens_per_s']:.0f} tok/s; composite {wall_c:.3f} "
        f"s), decode {ms:.2f} ms/step (composite {ms_c:.2f}), peak "
        f"{out['peak_mem_bytes'] / 2**30:.2f} GiB; {out}")
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 12: deepseek-v2-lite-16b prefill and decode
# ---------------------------------------------------------------------------
GATE_DEPTH = 4          # the dense first layer and 3 MoE layers
NEAR_TIE = 1e-5         # router margin at or under which a flip is no fault
FLIPS_LISTED = 20


class RouterLog:
    """While entered, records every routing decision of the MoE layers
    of ``cfg``: for each call, the experts each token chose and those
    whose capacity kept it (both (T, E) masks), and its router margin,
    the k-th minus the (k+1)-th probability."""

    def __init__(self, cfg):
        self.cfg = cfg

    def __enter__(self):
        import torch
        from repro_torch.core.relocation import _pack_slots
        from repro_torch.models import moe as M

        self.calls, self._mod, self._route = [], M, M.route

        def route(p, x, top_k, *, n_experts):
            w, idx, aux = self._route(p, x, top_k, n_experts=n_experts)
            T = idx.shape[0]
            probs = torch.softmax(x.float() @ p["w"]["w"].float(), dim=-1)
            top = probs.topk(top_k + 1, dim=-1).values
            _, keep = _pack_slots(idx.reshape(1, -1), n_experts,
                                  M.moe_capacity(self.cfg, T))
            chose = torch.zeros((T, n_experts), dtype=torch.bool,
                                device=idx.device)
            kept = chose.clone()
            chose.scatter_(1, idx.long(), True)
            kept.scatter_(1, idx.long(), keep.view(T, top_k))
            self.calls.append((chose, kept,
                               top[:, top_k - 1] - top[:, top_k]))
            return w, idx, aux

        M.route = route
        return self

    def __exit__(self, *exc):
        self._mod.route = self._route
        return False


def router_flips(gate, fused, plain, batch, n_moe, first, touched, what):
    """Tokens whose expert sets differ between two runs, call by call.

    A token of a sequence no earlier flip has touched is held to the
    plain run's router margin: a flip at a margin above ``NEAR_TIE`` is a
    fault; at or under it, it is a near tie of two sums taken in
    different orders, and the sequence is touched from then on (its rows
    from that token on, and its later layers and decode steps, may
    differ by O(1)).  Flips inside touched sequences are counted as
    downstream.  A flip also shifts the capacity ranks of the tokens
    after it in the flattened batch: a token that chose the same experts
    but was kept by other ones ("knocked") is allowed after a flip of
    the same call, touches its sequence, and is a fault otherwise.
    Returns {layer: {"differ", "downstream", "knocked", "near_ties"}}."""
    require(len(fused.calls) == len(plain.calls),
            f"{what}: {len(fused.calls)} vs {len(plain.calls)} router calls")
    out = {}
    for c, ((fc, fk, _), (pc, pk, margin)) in enumerate(zip(fused.calls,
                                                            plain.calls)):
        layer = out.setdefault(first + c % n_moe, {
            "differ": 0, "downstream": 0, "knocked": 0, "near_ties": []})
        differ = (fc != pc).any(dim=-1)
        rows = differ.nonzero()[:, 0].tolist()
        knocked = (~differ & (fk != pk).any(dim=-1)).nonzero()[:, 0].tolist()
        per = fc.shape[0] // batch
        new = set()
        layer["differ"] += len(rows)
        layer["knocked"] += len(knocked)
        for t in knocked:
            gate.check(bool(rows) and t > rows[0],
                       f"{what}: layer {first + c % n_moe}, step "
                       f"{c // n_moe}: token {t} kept by other experts "
                       "with no flip before it")
            new.add(t // per)
        for t in rows:
            b = t // per
            if b in touched:
                layer["downstream"] += 1
                continue
            m = float(margin[t])
            gate.check(m <= NEAR_TIE,
                       f"{what}: layer {first + c % n_moe}, step "
                       f"{c // n_moe}: sequence {b} token {t % per} took "
                       f"other experts at router margin {m} > {NEAR_TIE}")
            if len(layer["near_ties"]) < FLIPS_LISTED:
                layer["near_ties"].append({"step": c // n_moe, "seq": b,
                                           "token": t % per, "margin": m})
            new.add(b)
        touched |= new
    return out


def phase_deepseek(report, main_launches):
    """deepseek-v2-lite-16b at published widths, random weights.

    Depth 4, float32: fused vs composite within 1e-3 (prefill logits,
    latent caches, 32 decode steps on each path's backend) in every
    sequence no router near tie has touched; bfloat16 at depth 4 held
    against that float32 run as in phase 5.  Full depth, bfloat16 (the
    main path, parameters drawn in the compute dtype): the counted fused
    prefill, the composite one, 32 decode steps from each; no float32
    run fits beside it, so the checks are finiteness, the launch counts,
    layer 1's latent cache (the first downstream of a flash launch)
    within 1e-2 in relative L2, and the first MoE layer's routed output
    on one input through both paths within one bfloat16 ulp."""
    import dataclasses

    import torch
    from repro_torch.models import Parallel
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import rmsnorm
    from torch.utils import _pytree as pytree

    spec = LM["deepseek"]
    cfg = lm_config("deepseek")
    B, S, s_cache = spec["batch"], spec["prompt"], spec["s_cache"]
    first = cfg.first_dense_layers
    gate = Gate("deepseek")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=DEV, dtype=torch.int32)
    out = {"config": cfg.name, "batch": B, "prompt": S, "s_cache": s_cache,
           "decode_steps": DECODE_STEPS, "gate_depth": GATE_DEPTH,
           "near_tie": NEAR_TIE}
    times = {}
    ckv = _slot(0, "ckv")
    krope = _slot(0, "krope")

    # depth 4, f32: kernel vs plain version, the truth of the bf16 runs
    t0 = time.perf_counter()
    cfg4 = dataclasses.replace(cfg, n_layers=GATE_DEPTH)
    c32 = dataclasses.replace(cfg4, dtype="float32")
    n_moe = GATE_DEPTH - first
    master, params4 = lm_params(cfg4)
    with RouterLog(c32) as rf:
        st_f, lg_f, wall_f = prefill(c32, master, tokens, "fused", s_cache)
    with RouterLog(c32) as rc:
        st_c, lg_c, wall_fc = prefill(c32, master, tokens, "composite",
                                      s_cache)
    touched = set()
    flips = {"prefill": router_flips(gate, rf, rc, B, n_moe, first, touched,
                                     "f32 prefill")}
    f32_prefill_calls = rc.calls
    follow, st = [], st_f
    tok = lg_f.argmax(-1)[:, None].to(torch.int32)
    for _ in range(DECODE_STEPS):
        follow.append(tok)
        st, lg = T.decode_step(master, c32, Parallel(), st, tok,
                               impl="fused")
        tok = lg.argmax(-1)[:, None].to(torch.int32)
    del st
    with RouterLog(c32) as rf:
        dl_f, ms32 = decode(c32, master, st_f, follow, "fused")
    with RouterLog(c32) as rc:
        dl_c, _ = decode(c32, master, st_c, follow, "composite")
    flips["decode"] = router_flips(gate, rf, rc, B, n_moe, first, touched,
                                   "f32 decode")
    held = [b for b in range(B) if b not in touched]
    gate.check(bool(held), "every sequence touched by a router near tie")
    rows = torch.tensor(held, device=DEV, dtype=torch.long)
    e32 = {}
    for name, a, b, axis in (
            ("prefill_logits", lg_f, lg_c, 0),
            ("prefix_ckv", st_f["prefix"][0]["ckv"],
             st_c["prefix"][0]["ckv"], 0),
            ("ckv", ckv(st_f), ckv(st_c), 1),
            ("krope", krope(st_f), krope(st_c), 1),
            ("decode_logits", dl_f, dl_c, 1)):
        e32[name] = f32_close(gate, a.index_select(axis, rows),
                              b.index_select(axis, rows), name)
    gate.check(torch.equal(_slot(0, "pos")(st_f), _slot(0, "pos")(st_c)),
               "cache positions")
    truth = {"prefill_logits": lg_c, "decode_logits": dl_c,
             "ckv": ckv(st_c)}
    out["float32"] = {"max_abs_err": e32, "held_sequences": held,
                      "router_flips": flips, "prefill_s": wall_f,
                      "composite_prefill_s": wall_fc,
                      "prefill_tokens_per_s": B * S / wall_f,
                      "decode_ms_per_step": ms32}
    times["float32_depth4_s"] = time.perf_counter() - t0
    log(f"[deepseek f32 depth {GATE_DEPTH}] held sequences {held}, router "
        f"flips {flips}, errors {e32}")
    del st_f, st_c, lg_f, dl_f, master

    # depth 4, bf16: both paths against the f32 run
    t0 = time.perf_counter()
    with RouterLog(cfg4) as rf:
        st_f, lg_f, _ = prefill(cfg4, params4, tokens, "fused", s_cache)
    with RouterLog(cfg4) as rc:
        st_c, lg_c, _ = prefill(cfg4, params4, tokens, "composite", s_cache)
    dl_f, _ = decode(cfg4, params4, st_f, follow, "fused")
    dl_c, _ = decode(cfg4, params4, st_c, follow, "composite")
    e16 = {"prefill_logits": bf16_close(gate, lg_f, lg_c,
                                        truth["prefill_logits"],
                                        "prefill logits"),
           "ckv": bf16_close(gate, ckv(st_f), ckv(st_c), truth["ckv"],
                             "ckv"),
           "decode_logits": bf16_close(gate, dl_f, dl_c,
                                       truth["decode_logits"],
                                       "decode logits")}
    out["bfloat16_depth4"] = {
        "errors": e16,
        # tokens routed differently from each other, layer by layer
        "router_differ_fused_vs_composite": [
            int((f[0] != c[0]).any(-1).sum())
            for f, c in zip(rf.calls, rc.calls)],
        "router_differ_vs_f32": [
            int((f[0] != c[0]).any(-1).sum())
            for f, c in zip(rc.calls, f32_prefill_calls)]}
    times["bfloat16_depth4_s"] = time.perf_counter() - t0
    log(f"[deepseek bf16 depth {GATE_DEPTH}] {out['bfloat16_depth4']}")
    del st_f, st_c, lg_f, lg_c, dl_f, dl_c, truth, params4, rf, rc
    del f32_prefill_calls
    torch.cuda.empty_cache()

    # full depth, bf16: the main path, counted from zero
    t0 = time.perf_counter()
    follow = [torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                            device=DEV, dtype=torch.int32)
              for _ in range(DECODE_STEPS)]

    def routed(params):
        """The first MoE layer (layer 1) on one input through both
        paths, within one bfloat16 ulp."""
        p1 = pytree.tree_map(lambda a: a[0], params["scan"][0])
        x1 = rmsnorm(p1["norm2"], params["embed"]["table"][tokens.long()],
                     cfg.norm_eps).reshape(B * S, cfg.d_model)
        w1, idx1, _ = M.route(p1["ffn"]["router"], x1, cfg.top_k,
                              n_experts=cfg.n_experts)
        cap = M.moe_capacity(cfg, B * S)
        fb, fs = M.moe_dispatch(x1, idx1, cfg.n_experts, cap, impl="fused")
        cb, cs = M.moe_dispatch(x1, idx1, cfg.n_experts, cap,
                                impl="composite")
        gate.check(torch.equal(fb, cb) and torch.equal(fs, cs),
                   "layer 1 dispatch buffers differ")
        yf = M._expert_ffn(p1["ffn"]["experts"], fb).reshape(
            -1, cfg.d_model)
        got = M.moe_combine(yf, fs, w1, impl="fused")
        want = M.moe_combine(yf, cs, w1, impl="composite")
        err = combine_close(gate, got, want, yf, fs.view(B * S, -1).to(
            torch.int32), w1, "bfloat16", "layer 1 routed output")
        return {"layer1_routed_max_abs_err": err,
                "dropped_rows_layer1": int((fs < 0).sum())}

    out["bfloat16"] = lm_full_depth("deepseek", cfg, tokens, follow, gate,
                                    main_launches, routed)
    times["bfloat16_s"] = time.perf_counter() - t0
    out["times"] = times
    for name, n in spec["launches"].items():
        gate.check(main_launches.get(name) == n,
                   f"fused prefill launched {name} "
                   f"{main_launches.get(name)} times, not {n}")
    report["deepseek"] = out
    gate.close()


# ---------------------------------------------------------------------------
# phase 14: the paper's workloads (K-Means, MolDyn, PlhamJ) on the card
# ---------------------------------------------------------------------------
KM_POINTS = 1 << 24        # rows of 4 f64 (x, y, z, cluster): 512 MiB
KM_CHECK_POINTS = 1 << 16  # card vs the port's CPU run
KM = {"n_places": 8, "dim": 3, "k": 16, "seed": SEED}
KM_SPEEDS = (1,) * 7 + (3,)
KM_PERIOD = 2
KM_ITERS = 10
MD_B = 8788                # Java Grande section 3, size B
MD_A = 2048                # size A
MD = {"n_places": 4, "ndivide": 5, "seed": SEED}
MD_STEPS = 10
MD_CHECK_STEPS = 3
MD_SPEEDS = (1, 1, 1, 2)
# benchmarks/run.py's PlhamJ rows (the paper's Fig 7 configurations)
PLHAM_CASES = {
    "evenA": dict(n_places=5, speeds=(1, 1, 1, 1, 1)),
    "unevenC": dict(n_places=6, speeds=(1, 1, 1, 1, 1, 3)),
    "disturbA": dict(n_places=5, speeds=(1, 1, 1, 1, 1),
                     disturb_period=25),
}
PLHAM_STRATEGIES = ("none", "level_extremes", "proportional")
PLHAM = {"n_agents": 800, "lb_period": 5, "seed": 1}
PLHAM_ROUNDS = 100
PLHAM_BIG = {"n_agents": 65536, "rounds": 20}


def kmeans_glb():
    from repro_torch.core import GLBConfig
    return GLBConfig(period=KM_PERIOD, transport="device")


def kmeans_points(km):
    """Every point's row (coordinates, cluster) on its place's device,
    in global index order; fails unless the places hold each index
    once."""
    import torch
    idx, rows = [], []
    for p in km.group.members:
        if km.points.local_size(p):
            r, i = km.points.to_local_matrix(p)
            idx.append(torch.as_tensor(i, device=r.device))
            rows.append(r)
    idx = torch.cat(idx)
    require(torch.equal(idx.sort().values,
                        torch.arange(km.n_points, device=idx.device)),
            "the places do not hold every point once")
    out = torch.empty_like(torch.cat(rows))
    out[idx] = torch.cat(rows)
    return out


def timed_ms(step, n, end=None):
    """Milliseconds per call of ``step`` over ``n`` calls (then ``end``,
    if given, inside the time), closed by a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    if end is not None:
        end()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def phase_kmeans(report, main_launches):
    """8 places, 2^24 points, k 16, 10 iterations, the GLB relocating
    through the device transport (the codec kernels) toward the fast
    place: inertia falls below 0.8x its start, the centroids equal a
    1-place run's within 1e-9 (the same points), every row the windows
    moved is exact (coordinates equal to the draw bit for bit, cluster
    equal to the 1-place run's), and at 2^16 points the card equals the
    port's CPU run (assignments equal, centroids within 1e-9)."""
    import torch
    from repro_torch.apps import KMeans
    from repro_torch.apps.kmeans import draw_points

    gate = Gate("kmeans")
    t0 = time.perf_counter()
    km = KMeans(n_points=KM_POINTS, glb=kmeans_glb(), speeds=KM_SPEEDS,
                device=DEV, **KM)
    setup_s = time.perf_counter() - t0
    i0 = km.inertia()
    reset_counts()
    ms = timed_ms(km.iterate, KM_ITERS, km.finish)
    read_counts(main_launches)
    i1 = km.inertia()
    st = km.balancer.stats
    out = {"points": KM_POINTS, **KM, "iterations": KM_ITERS,
           "speeds": KM_SPEEDS, "glb_period": KM_PERIOD,
           "ms_per_iteration": ms, "setup_s": setup_s, "inertia_start": i0,
           "inertia_end": i1,
           "loads": [km.points.local_size(p) for p in km.group.members],
           "rebalances": st.rebalances, "glb_bytes_moved": st.bytes_moved}
    gate.check(i1 < 0.8 * i0, f"inertia {i1} not below 0.8 x {i0}")
    for name in ("reloc_encode_pack", "reloc_decode_rows"):
        gate.check(main_launches.get(name, 0) > 0,
                   f"the relocation windows never launched {name}")
    gate.check(out["loads"][-1] > max(out["loads"][:-1]),
               f"the fast place did not gain points: {out['loads']}")
    centroids = km.centroids.clone()
    # the rows after the last window, by global index: the coordinates
    # are never written, so each equals the draw bit for bit
    rows = kmeans_points(km)
    del km
    torch.cuda.empty_cache()
    drawn = torch.from_numpy(draw_points(KM_POINTS, KM["dim"], KM["k"],
                                         KM["seed"])[1]).to(DEV)
    moved = int((rows[:, :KM["dim"]] != drawn[:, :KM["dim"]]).any(1).sum())
    out["points_differing_from_draw"] = moved
    gate.check(moved == 0, f"{moved} points' coordinates differ from the "
               "draw after relocation")
    del drawn

    one = KMeans(n_places=1, n_points=KM_POINTS, dim=KM["dim"], k=KM["k"],
                 seed=KM["seed"], device=DEV)
    out["one_place_ms_per_iteration"] = timed_ms(one.iterate, KM_ITERS)
    err = float((one.centroids - centroids).abs().max())
    out["centroids_vs_one_place_max_abs_err"] = err
    gate.check(err <= 1e-9, f"centroids vs 1 place: {err} > 1e-9")
    # the same centroids in every iteration assign every point alike:
    # the cluster column of each relocated row is held too
    differ = int((kmeans_points(one)[:, KM["dim"]]
                  != rows[:, KM["dim"]]).sum())
    out["assignments_differing_from_one_place"] = differ
    gate.check(differ == 0, f"{differ} assignments differ from the "
               "1-place run")
    del one, rows
    torch.cuda.empty_cache()

    runs = {}
    for dev in (DEV, "cpu"):
        km = KMeans(n_points=KM_CHECK_POINTS, glb=kmeans_glb(),
                    speeds=KM_SPEEDS, device=dev, **KM)
        for _ in range(KM_ITERS):
            km.iterate()
        km.finish()
        runs[dev] = (km.centroids.cpu(),
                     kmeans_points(km)[:, KM["dim"]].cpu(),
                     [km.points.local_size(p) for p in km.group.members])
    err = float((runs[DEV][0] - runs["cpu"][0]).abs().max())
    out["card_vs_cpu"] = {"points": KM_CHECK_POINTS,
                          "centroids_max_abs_err": err,
                          "loads": runs[DEV][2]}
    gate.check(err <= 1e-9, f"card vs CPU centroids: {err} > 1e-9")
    gate.check(torch.equal(runs[DEV][1], runs["cpu"][1]),
               "card vs CPU: assignments differ")
    gate.check(runs[DEV][2] == runs["cpu"][2],
               f"card vs CPU loads {runs[DEV][2]} != {runs['cpu'][2]}")
    log(f"[kmeans] {out}")
    report["kmeans"] = out
    gate.close()


def phase_moldyn(report, main_launches):
    """Java Grande size B (8 788 particles) over 4 places, 10 steps: the
    replicas stay in sync and the positions equal a 1-place run's within
    rtol 1e-10; with the GLB at speeds (1, 1, 1, 2) too.  At size A, 3
    steps on the card equal the port's CPU run (rtol 1e-10, equal
    allreduce bytes)."""
    import torch
    from repro_torch.apps import MolDyn
    from repro_torch.core import GLBConfig

    gate = Gate("moldyn")
    reset_counts()
    md = MolDyn(n_particles=MD_B, device=DEV, **MD)
    pairs = sum(s.total_pairs() for s in md.tiles)
    first_ms = timed_ms(md.step, 1)         # builds each tile's pairs
    ms = timed_ms(md.step, MD_STEPS - 1)
    read_counts(main_launches)
    out = {"particles": MD_B, **MD, "steps": MD_STEPS,
           "pairs_per_step": pairs, "first_step_ms": first_ms,
           "ms_per_step": ms, "allreduce_bytes": md.allreduce_bytes,
           "energy": md.energy()}
    gate.check(md.replicas_in_sync(), "replicas out of sync")
    pos = md.positions().clone()
    del md
    one = MolDyn(n_places=1, n_particles=MD_B, ndivide=MD["ndivide"],
                 seed=MD["seed"], device=DEV)
    out["one_place_ms_per_step"] = timed_ms(one.step, MD_STEPS)
    gate.check(torch.allclose(one.positions(), pos, rtol=1e-10, atol=0),
               "positions differ from the 1-place run")
    out["vs_one_place_max_abs_err"] = float(
        (one.positions() - pos).abs().max())
    del one
    glb = MolDyn(n_particles=MD_B, glb=GLBConfig(period=2),
                 speeds=MD_SPEEDS, device=DEV, **MD)
    out["glb_ms_per_step"] = timed_ms(glb.step, MD_STEPS)
    out["glb_rebalances"] = glb.balancer.stats.rebalances
    out["glb_pairs_by_place"] = [s.total_pairs() for s in glb.tiles]
    gate.check(glb.replicas_in_sync(), "GLB run: replicas out of sync")
    gate.check(torch.allclose(glb.positions(), pos, rtol=1e-10, atol=0),
               "GLB run: positions differ from the 4-place run")
    gate.check(glb.balancer.stats.rebalances > 0, "GLB run never moved")
    del glb
    torch.cuda.empty_cache()

    runs = {}
    for dev in (DEV, "cpu"):
        m = MolDyn(n_particles=MD_A, device=dev, **MD)
        for _ in range(MD_CHECK_STEPS):
            m.step()
        runs[dev] = (m.positions().cpu(), m.allreduce_bytes)
    a, b = runs[DEV][0], runs["cpu"][0]
    out["card_vs_cpu"] = {"particles": MD_A, "steps": MD_CHECK_STEPS,
                          "max_abs_err": float((a - b).abs().max()),
                          "allreduce_bytes": runs[DEV][1]}
    gate.check(torch.allclose(a, b, rtol=1e-10, atol=0),
               "size A: card vs CPU positions differ")
    gate.check(runs[DEV][1] == runs["cpu"][1],
               f"allreduce bytes {runs[DEV][1]} != CPU {runs['cpu'][1]}")
    log(f"[moldyn] {out}")
    report["moldyn"] = out
    gate.close()


def counted(main_launches, run):
    """``run()`` with the launch counts set to 0 just before it; its
    launches are added to ``main_launches``."""
    from repro_torch.kernels import cuda_build

    reset_counts()
    out = run()
    for name, n in cuda_build.launch_counts.items():
        main_launches[name] = main_launches.get(name, 0) + n
    return out


def plham_run(case, strategy, device, n_agents=None, rounds=PLHAM_ROUNDS):
    """One PlhamJ configuration; returns (sim, wall seconds)."""
    import torch
    from repro_torch.apps import PlhamSim

    kw = dict(PLHAM_CASES[case], **PLHAM, strategy=strategy)
    if n_agents is not None:
        kw["n_agents"] = n_agents
    sim = PlhamSim(**kw, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(rounds)
    torch.cuda.synchronize()
    return sim, time.perf_counter() - t0


def phase_plham(report, main_launches):
    """The nine configurations of ``benchmarks/run.py`` (evenA, unevenC,
    disturbA x none, level_extremes, proportional; 800 agents, 100
    rounds): unevenC/level_extremes gains >= 5 %, evenA/level_extremes
    stays within 5 %, and every run's load history and relocated bytes
    equal the port's CPU run, its simulated time within rtol 1e-12.
    Then unevenC/level_extremes at 65 536 agents for 20 rounds."""
    import numpy as np

    gate = Gate("plham")
    rows = {}
    for case in PLHAM_CASES:
        base = None
        for strat in PLHAM_STRATEGIES:
            sim, wall = counted(main_launches,
                                lambda: plham_run(case, strat, DEV))
            ref, _ = plham_run(case, strat, "cpu")
            if strat == "none":
                base = sim.sim_time
            name = f"{case}_{strat}"
            rows[name] = {
                "simtime": sim.sim_time,
                "gain_pct": (base - sim.sim_time) / base * 100,
                "relocated_bytes": sim.relocated,
                "wall_us_per_round": wall / PLHAM_ROUNDS * 1e6,
                "dispatch_us_per_round": sim.dispatch_s / PLHAM_ROUNDS
                * 1e6}
            gate.check(np.isclose(sim.sim_time, ref.sim_time, rtol=1e-12,
                                  atol=0),
                       f"{name}: sim_time {sim.sim_time} vs CPU "
                       f"{ref.sim_time}")
            gate.check(sim.relocated == ref.relocated,
                       f"{name}: relocated {sim.relocated} vs CPU "
                       f"{ref.relocated}")
            for i, (a, b) in enumerate(zip(sim.distribution_history,
                                           ref.distribution_history)):
                if not np.array_equal(a, b):
                    gate.check(False, f"{name}: round {i} loads {a.tolist()} "
                               f"vs CPU {b.tolist()} (margin "
                               f"{(a - b).tolist()})")
                    break
            gate.check(len(sim.distribution_history)
                       == len(ref.distribution_history) == PLHAM_ROUNDS,
                       f"{name}: history lengths")
    gate.check(rows["unevenC_level_extremes"]["gain_pct"] >= 5.0,
               f"unevenC/level_extremes gains "
               f"{rows['unevenC_level_extremes']['gain_pct']} % < 5 %")
    gate.check(abs(rows["evenA_level_extremes"]["gain_pct"]) < 5.0,
               f"evenA/level_extremes moves "
               f"{rows['evenA_level_extremes']['gain_pct']} % >= 5 %")
    sim, wall = counted(main_launches, lambda: plham_run(
        "unevenC", "level_extremes", DEV, n_agents=PLHAM_BIG["n_agents"],
        rounds=PLHAM_BIG["rounds"]))
    big = {"case": "unevenC_level_extremes", **PLHAM_BIG,
           "wall_ms_per_round": wall / PLHAM_BIG["rounds"] * 1e3,
           "dispatch_ms_per_round": sim.dispatch_s / PLHAM_BIG["rounds"]
           * 1e3, "dispatch_share": sim.dispatch_s / wall,
           "trades_per_round": sim.trades / PLHAM_BIG["rounds"],
           "dispatch_us_per_trade": sim.dispatch_s / max(sim.trades, 1)
           * 1e6,
           "simtime": sim.sim_time, "relocated_bytes": sim.relocated}
    for name, r in rows.items():
        log(f"[plham] {name}: {r}")
    log(f"[plham] {PLHAM_BIG['n_agents']} agents: {big}")
    report["plham"] = {"rows": rows, "big": big}
    gate.close()


# ---------------------------------------------------------------------------
# phases 6 and 10: the elastic serving runtime at full width
# ---------------------------------------------------------------------------
SERVE_ROUNDS = {"qwen2": 32, "recurrentgemma": 16, "deepseek": 16}


def phase_serving(report, main_launches, key="qwen2"):
    """``ElasticServingDriver`` over 4 replicas (``DecodeEngine``,
    ``s_cache`` 1024, micro-batches of 8, device transport): a hot
    replica and a slow one; zero sequences lost, sequences and states
    co-resident, every ``SeqKV`` on the card, migrations through
    ``pack_rows``."""
    import numpy as np
    import torch
    from repro_torch.serving import DecodeEngine, RealDecodeSim, SeqKV

    rounds = SERVE_ROUNDS[key]
    engine = DecodeEngine(lm_config(key), s_cache=1024, max_batch=8,
                          seed=SEED, device=DEV)
    reset_counts()
    t0 = time.perf_counter()
    sim = RealDecodeSim(n_replicas=4, slots=16, work=(1, 1, 3, 1),
                        preload=(2, 24), arrival_rate=3.0,
                        prompt_range=(8, 48), max_new_range=(8, 24),
                        glb_period=4, pipeline_depth=2, seed=SEED,
                        engine=engine, transport="device").run(rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    read_counts(main_launches)
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
    if engine.cfg.is_moe:            # every decode step dispatches
        for name in ("gather_rows", "moe_combine"):
            require(main_launches.get(name, 0) > 0,
                    f"serving decode never launched {name}")
        require(main_launches["moe_combine:simple"] == 0,
                f"serving: {main_launches['moe_combine:simple']} of "
                f"{main_launches['moe_combine']} moe_combine calls took the "
                "simple route")
    p95 = sim.window_p95()
    out = {"config": engine.cfg.name, "rounds": rounds, "wall_s": wall,
           "tokens_decoded": sim.tokens,
           "throughput_tokens_per_s": sim.throughput(),
           "window_p95_s": p95, "admitted": d.admitted,
           "completed": len(d.completed), "lost": d.lost(),
           "loads": [d.seqs.local_size(p) for p in d.group.members],
           "rebalances": st.rebalances, "glb_bytes_moved": st.bytes_moved,
           "exchanges": life.exchanges, "row_bytes": life.row_bytes,
           "wire_bytes": life.wire_bytes, "width": life.width,
           "seqkv_bytes": seq_kv.nbytes if seq_kv is not None else None}
    log(f"[serving {key}] {sim.tokens} tokens, "
        f"{out['throughput_tokens_per_s']:.1f} tok/s, p95 {p95}, loads "
        f"{out['loads']}, SeqKV {out['seqkv_bytes']} B, width class "
        f"{life.width} B")
    report["serving" if key == "qwen2" else f"{key}_serving"] = out
    del sim, engine
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 18: the flash backward against its plain version
# ---------------------------------------------------------------------------
# one micro-batch of qwen2-1.5B training: q (2, 12, 4096, 128), k and v
# (2, 2, 4096, 128), bfloat16, causal
QWEN_TRAIN_ATTN = (2, 12, 2, 4096, 4096, 128)
# (B, Hq, Hkv, Sq, Skv, D, causal, window, softcap[, layout]): head dims
# 64 and 128, GQA groups 1 and 6, windows none, 1024, 0 and -3, softcaps
# 0 and 50, Sq = Skv and lengths no multiple of the tiles; 16-bit cases
# take the tensor-core route but for the unaligned "pad" views (the FMA
# route, as float32 always does)
FLASH_BWD_SWEEP = [
    (2, 4, 4, 512, 512, 64, True, None, 0.0),          # group 1
    (1, 12, 2, 512, 512, 128, False, None, 0.0),       # group 6
    (1, 12, 2, 1500, 1500, 128, True, 1024, 0.0),      # window 1024
    (1, 8, 8, 1500, 1500, 64, False, 1024, 50.0),      # and a softcap
    (1, 12, 2, 777, 777, 128, True, None, 50.0),       # ragged, softcap
    (1, 6, 6, 300, 300, 64, False, 0, 0.0),            # keys after the row
    (1, 12, 2, 300, 300, 128, True, 0, 0.0),           # no key: zero grads
    (1, 12, 2, 300, 300, 128, False, -3, 0.0),
    (1, 4, 4, 300, 300, 64, True, -3, 0.0),
    (1, 6, 1, 129, 200, 128, True, None, 0.0),         # Sq < Skv
    (2, 12, 2, 1000, 1000, 128, True, None, 0.0, "bshd"),  # the models'
    (1, 12, 2, 300, 300, 128, True, None, 0.0, "pad"),     # unaligned rows
]
# float32: every gradient element within this share of the largest
FLASH_BWD_F32_TOL = 1e-4
# 16-bit: every gradient element within half an output ulp of
# flash_bwd_ref on float32 copies plus this share of the largest; P or dS
# rounded to 16 bits inside the kernel lands about 1e-3 beyond half an ulp
FLASH_BWD_ULP_ATOL = 1e-4
# the forward's row log-sum-exp against flash_ref's
FLASH_LSE_TOL = 1e-5


def rel_l2(a, b) -> float:
    b = b.float()
    return float((a.float() - b).norm() / b.norm().clamp_min(1e-30))


def half_ulp_excess(got, want, dtype) -> float:
    """The largest ``|got - want| - ulp(want) / 2`` over the elements, in
    ``got``'s 16-bit ``dtype``, as a share of ``max|want|``."""
    import torch
    _, e = torch.frexp(want)              # |want| in [2^(e-1), 2^e)
    lo, bits = {"bfloat16": (-125, 9), "float16": (-13, 12)}[dtype]
    half_ulp = torch.where(want == 0, 0.0, torch.ldexp(
        torch.ones_like(want), e.clamp_min(lo) - bits))
    excess = float(((got.float() - want).abs() - half_ulp).max())
    return excess / max(float(want.abs().max()), 1e-30)


def flash_bwd_check(gate, q, k, v, do, dtype, what, layout="bhsd", **kw):
    """The backward kernel on (q, k, v, do) against ``flash_bwd_ref``:
    float32 within ``FLASH_BWD_F32_TOL`` of the largest gradient element;
    16-bit, each of dq / dk / dv no further (relative L2) from
    ``flash_bwd_ref`` on float32 copies than ``BF16_MARGIN`` times the
    plain version's own 16-bit result is, and every element within half
    an output ulp of it plus ``FLASH_BWD_ULP_ATOL``; two launches the
    same bits; the forward's log-sum-exp within ``FLASH_LSE_TOL`` of
    flash_ref's; the route the one the dtype and ``layout`` call for."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    _, lse_ref = ref.flash_ref(q, k, v, return_lse=True, **kw)
    live = torch.isfinite(lse_ref)
    lse_err = float((lse[live] - lse_ref[live]).abs().max()) \
        if live.any() else 0.0
    gate.check(torch.equal(live, torch.isfinite(lse))
               and lse_err <= FLASH_LSE_TOL,
               f"{what}: forward log-sum-exp off flash_ref's by {lse_err}")
    before = dict(fa.bwd_route_counts)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    taken = {r: n - before[r] for r, n in fa.bwd_route_counts.items()}
    route = max(taken, key=taken.get)
    expect = "fma" if dtype == "float32" or layout == "pad" \
        else "tensor_core"
    gate.check(taken[expect] == 2 and sum(taken.values()) == 2,
               f"{what}: backward routes {taken}, not 2 x {expect}")
    want = ref.flash_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                             lse, do.float(), **kw)
    plain = want if dtype == "float32" else ref.flash_bwd_ref(
        q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    row = {"dtype": dtype, "route": route, "lse_max_abs_err": lse_err,
           "deterministic": all(torch.equal(a, b)
                                for a, b in zip(got, again))}
    gate.check(row["deterministic"], f"{what}: two launches differ")
    for name, a, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        scale = float(w.abs().max())
        err = float((a.float() - p.float()).abs().max())
        r = {"max_abs_err": err, "max_share": err / max(scale, 1e-30),
             "rel_l2_vs_f32": rel_l2(a, w),
             "plain_rel_l2_vs_f32": rel_l2(p, w)}
        ok = bool(torch.isfinite(a.float()).all())
        if dtype == "float32":
            ok = ok and err <= FLASH_BWD_F32_TOL * scale
        else:
            r["ulp_excess"] = half_ulp_excess(a, w, dtype)
            r["plain_ulp_excess"] = half_ulp_excess(p, w, dtype)
            ok = ok and r["rel_l2_vs_f32"] <= BF16_MARGIN \
                * r["plain_rel_l2_vs_f32"] + 1e-7 \
                and r["ulp_excess"] <= FLASH_BWD_ULP_ATOL
        gate.check(ok, f"{what}: {name} {r}")
        row[name] = r
    return row


def phase_flash_backward(report):
    """The sweep, then the training shape: timed beside its bound (2.5x
    the forward's operations at the bf16 peak), ``flash_bwd_ref`` and
    SDPA's backward (``torch.autograd.grad`` of its output)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    gate = Gate("flash_backward")
    sweep = []
    for dtype in ("float32", "bfloat16", "float16"):
        for case in FLASH_BWD_SWEEP:
            q, k, v = flash_inputs(gen, case[:6], dtype, *case[9:])
            do = flash_inputs(gen, case[:6], dtype, *case[9:])[0]
            kw = dict(zip(("causal", "window", "softcap"), case[6:9]))
            row = flash_bwd_check(gate, q, k, v, do, dtype,
                                  f"{dtype} {case}", *case[9:], **kw)
            sweep.append(dict(row, case=list(case)))
            del q, k, v, do
    report["flash_backward_sweep"] = sweep

    B, Hq, Hkv, S, _, D = QWEN_TRAIN_ATTN
    q, k, v = flash_inputs(gen, QWEN_TRAIN_ATTN, "bfloat16", "bshd")
    do = flash_inputs(gen, QWEN_TRAIN_ATTN, "bfloat16", "bshd")[0]
    train = flash_bwd_check(gate, q, k, v, do, "bfloat16",
                            "qwen2 training shape", "bshd", causal=True)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, with_lse=True)
    run = lambda: fa.flash_attention_bwd(  # noqa: E731
        q, k, v, out, lse, do, causal=True)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o_sdpa = F.scaled_dot_product_attention(
        *leaves, is_causal=True, scale=1.0 / D ** 0.5, enable_gqa=True)
    flops = 5 * fa.attention_flops(B, Hq, S, S, D, causal=True,
                                   window=None) // 2
    nbytes = 2 * (4 * q.nelement() + 4 * k.nelement()) + 4 * lse.nelement()
    bound = max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
    res = {
        "shape": f"q ({B}, {Hq}, {S}, {D}), k/v ({B}, {Hkv}, {S}, {D}) "
                 "bfloat16, causal, (B, S, H, D) views",
        "ms": cuda_ms(run, reps=5, warm=1),
        "plain_ms": cuda_ms(lambda: ref.flash_bwd_ref(
            q, k, v, out, lse, do, causal=True), reps=3, warm=1),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            o_sdpa, leaves, do, retain_graph=True)),
        "library_call": "torch.autograd.grad(F.scaled_dot_product_attention"
                        "(q, k, v, is_causal=True, enable_gqa=True), "
                        "(q, k, v), do)",
        "bound_ms": bound * 1e3, "flops": flops, "bytes": nbytes,
        "bound_by": "operations" if flops / PEAK_FLOPS["bfloat16"]
        >= nbytes / HBM_BYTES_PER_S else "bytes",
        "route": train["route"],
        "max_abs_err": max(train[n]["max_abs_err"] for n in ("dq", "dk",
                                                             "dv")),
        "check": train}
    res["tflops"] = flops / res["ms"] / 1e9
    res["sweep_max_f32_share"] = max(
        r[n]["max_share"] for r in sweep if r["dtype"] == "float32"
        for n in ("dq", "dk", "dv"))
    res["sweep_max_lse_err"] = max(r["lse_max_abs_err"] for r in sweep)
    res["sweep_max_ulp_excess"] = max(
        r[n]["ulp_excess"] for r in sweep if r["dtype"] != "float32"
        for n in ("dq", "dk", "dv"))
    res["sweep_max_16bit_ratio"] = max(
        r[n]["rel_l2_vs_f32"] / max(r[n]["plain_rel_l2_vs_f32"], 1e-30)
        for r in sweep if r["dtype"] != "float32" for n in ("dq", "dk", "dv")
        if r[n]["plain_rel_l2_vs_f32"] > 0)
    res["sweep_routes"] = {r: sum(x["route"] == r for x in sweep)
                           for r in ("tensor_core", "fma")}
    log(f"[flash backward] {res['route']} route {res['ms']:.3f} ms, "
        f"{res['tflops']:.1f} TFLOP/s "
        f"(bound {res['bound_ms']:.4f}, plain {res['plain_ms']:.3f}, sdpa "
        f"backward {res['library_ms']:.3f}); sweep f32 share "
        f"{res['sweep_max_f32_share']:.2e}, 16-bit ratio "
        f"{res['sweep_max_16bit_ratio']:.3f}, half-ulp excess "
        f"{res['sweep_max_ulp_excess']:.2e}, lse {res['sweep_max_lse_err']}")
    report["flash_backward"] = res
    del q, k, v, do, out, lse, leaves, o_sdpa
    torch.cuda.empty_cache()
    gate.close()
    return res


# ---------------------------------------------------------------------------
# phase 19: qwen2-1.5B training
# ---------------------------------------------------------------------------
# micro-batches of 2 x 4096 tokens (the reference's train_4k length), 2
# accumulated a step: 16 384 tokens; 8 steps on one repeated batch
TRAIN = {"micro": 2, "accum": 2, "seq": 4096, "steps": 8, "places": 4,
         "lr": 1e-3}
TRAIN_LOSS_RTOL = 1e-4   # f32 compute: fused vs composite loss
TRAIN_GRAD_RL2 = 1e-3    # ... every gradient leaf, and the parameters after
                         # one AdamW step, in relative L2
# a leaf whose exact gradient is 0 (the key bias: it adds q . b to every
# score of a row, which the softmax cancels) is held to the whole
# gradient's norm instead of its own
ZERO_GRAD_LEAF = "['wk']['b']"
TRAIN_CKPT = ROOT / "build" / "smoke_ckpt"


def train_batch(cfg):
    """The global batch the loop repeats: ``ShardedBatches`` over a
    4-place ``PlaceGroup`` fed by ``TokenSource(seed=0)``, every place's
    ``local_batch`` concatenated in place order (which must equal the
    reference's ``make_global_batch``), as (accum, micro, seq) numpy."""
    import numpy as np
    from repro_torch.core import PlaceGroup
    from repro_torch.data import ShardedBatches, TokenSource
    from repro_torch.data import make_global_batch

    n = TRAIN["micro"] * TRAIN["accum"]
    group = PlaceGroup(TRAIN["places"], device=DEV)
    src = TokenSource(cfg.vocab_size, TRAIN["seq"], seed=0)
    shards = ShardedBatches(group, n, src)
    parts = [shards.local_batch(p) for p in group.members]
    batch = {k: np.concatenate([b[k] for b in parts])
             for k in ("tokens", "labels")}
    want = make_global_batch(src, 0, 0, n)
    require(all(np.array_equal(batch[k], want[k]) for k in batch),
            "ShardedBatches' rows differ from make_global_batch's")
    shape = (TRAIN["accum"], TRAIN["micro"], TRAIN["seq"])
    return shards, {k: v.reshape(shape) for k, v in batch.items()}


def train_grads(cfg, params, batch, impl):
    """(loss, gradient leaves) of ``train_loss`` at ``params``."""
    import torch
    from repro_torch.models import Parallel
    from repro_torch.models import transformer as T
    from torch.utils import _pytree as pytree

    leaves, spec = pytree.tree_flatten(params)
    live = [x.detach().requires_grad_() for x in leaves]
    loss, _ = T.train_loss(pytree.tree_unflatten(live, spec), cfg,
                           Parallel(), batch, impl=impl)
    grads = torch.autograd.grad(loss, live)
    return float(loss.detach()), list(grads)


def leaf_distances(paths, got, want, total):
    """Relative L2 of each leaf of ``got`` from ``want``; a zero-gradient
    leaf against ``total`` (the whole of ``want``'s norm)."""
    out = {}
    for path, a, b in zip(paths, got, want):
        if ZERO_GRAD_LEAF in path:
            out[path] = float((a.float() - b.float()).norm()) / total
        else:
            out[path] = rel_l2(a, b)
    return out


def phase_train(report, main_launches):
    """qwen2-1.5B training at full width and depth.  The gates at
    ``gate_depth`` first, with f32 master weights and ``remat="full"``:
    f32 compute, fused (flash forward + backward kernels) vs composite
    (autograd through ``flash_ref``): loss within ``TRAIN_LOSS_RTOL``,
    every gradient leaf and the parameters after one AdamW step within
    ``TRAIN_GRAD_RL2``; bf16 compute, every fused gradient leaf no
    further from the f32 composite run than ``BF16_MARGIN`` times the
    bf16 composite's.  Then the main path, counted: ``build_train_step``
    (bf16 compute, ``accum`` 2, AdamW lr 1e-3 without warmup) for 8 steps
    on one repeated batch, ``StragglerMitigator`` observing each; the
    loss must fall; then a ``CheckpointManager`` round trip of the
    parameters and moments, bit for bit."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Parallel, zoo
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.runtime import StragglerMitigator
    from repro_torch.train import build_train_step
    from torch.utils import _pytree as pytree

    cfg = lm_config("qwen2")
    depth = gate_depth(cfg)
    require(depth == cfg.n_layers, f"qwen2 training gate at depth {depth}")
    cfg = dataclasses.replace(cfg, remat="full")
    gate = Gate("qwen2_train")
    shards, batch = train_batch(cfg)
    micro = {k: torch.from_numpy(v[0]).to(DEV) for k, v in batch.items()}
    opt = AdamWConfig(lr=TRAIN["lr"], warmup_steps=0)
    out = {"config": cfg.name, "remat": cfg.remat, "gate_depth": depth,
           "micro_batch": [TRAIN["micro"], TRAIN["seq"]],
           "accum": TRAIN["accum"], "steps": TRAIN["steps"]}
    times = {}

    # f32 compute: the kernels against the plain versions
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    master = zoo.init_params(cfg, SEED, device=DEV)
    paths = [pytree.keystr(p) for p, _ in
             pytree.tree_flatten_with_path(master)[0]]
    c32 = dataclasses.replace(cfg, dtype="float32")
    loss_f, g_f = train_grads(c32, master, micro, "fused")
    loss_c, g_c = train_grads(c32, master, micro, "composite")
    total = float(torch.sqrt(sum(g.float().square().sum() for g in g_c)))
    d32 = leaf_distances(paths, g_f, g_c, total)
    gate.check(abs(loss_f - loss_c) <= TRAIN_LOSS_RTOL * abs(loss_c),
               f"f32 loss: fused {loss_f} vs composite {loss_c}")
    worst = max(d32, key=d32.get)
    gate.check(d32[worst] <= TRAIN_GRAD_RL2,
               f"f32 gradient {worst}: relative L2 {d32[worst]}")
    spec = pytree.tree_structure(master)

    def one_step(grads):
        p = pytree.tree_map(torch.clone, master)
        state = adamw_init(p, opt)
        adamw_update(pytree.tree_unflatten(grads, spec), state, p, opt)
        return pytree.tree_leaves(p)

    p_f = one_step(g_f)
    del g_f
    p_c = one_step(g_c)
    # the zero-gradient leaf's first AdamW step is ~lr times the sign of
    # rounding noise in either path: left out
    dstep = {path: rel_l2(a, b) for path, a, b in zip(paths, p_f, p_c)
             if ZERO_GRAD_LEAF not in path}
    dmove = {path: rel_l2(a - m, b - m) for path, a, b, m in zip(
        paths, p_f, p_c, pytree.tree_leaves(master))
        if ZERO_GRAD_LEAF not in path}
    worst_step = max(dstep, key=dstep.get)
    gate.check(dstep[worst_step] <= TRAIN_GRAD_RL2,
               f"parameters after one AdamW step: {worst_step} "
               f"{dstep[worst_step]}")
    del p_f, p_c
    out["float32"] = {
        "loss": loss_f, "composite_loss": loss_c,
        "loss_rel_err": abs(loss_f - loss_c) / abs(loss_c),
        "grad_rel_l2_max": d32[worst], "grad_rel_l2_worst_leaf": worst,
        "grad_rel_l2": d32, "grad_norm": total,
        "step_params_rel_l2_max": dstep[worst_step],
        "step_params_worst_leaf": worst_step,
        "step_update_rel_l2_max": max(dmove.values()),
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    times["float32_s"] = time.perf_counter() - t0
    log(f"[qwen2_train f32] loss {loss_f} vs {loss_c}; worst gradient "
        f"{worst} {d32[worst]:.3e}; one step {max(dstep.values()):.3e} "
        f"(update {max(dmove.values()):.3e})")

    # bf16 compute: both paths against the f32 composite gradients
    t0 = time.perf_counter()
    loss16_f, g16_f = train_grads(cfg, master, micro, "fused")
    loss16_c, g16_c = train_grads(cfg, master, micro, "composite")
    df = leaf_distances(paths, g16_f, g_c, total)
    dc = leaf_distances(paths, g16_c, g_c, total)
    ratio = {p: df[p] / max(dc[p], 1e-30) for p in paths}
    bad = {p: (df[p], dc[p]) for p in paths
           if not df[p] <= BF16_MARGIN * dc[p] + 1e-7}
    gate.check(not bad and all(bool(torch.isfinite(g).all())
                               for g in g16_f),
               f"bf16 gradients further from the f32 run than the "
               f"composite's (x{BF16_MARGIN}): {bad}")
    out["bfloat16_gate"] = {
        "loss": loss16_f, "composite_loss": loss16_c,
        "grad_rel_l2_vs_f32_max": max(df.values()),
        "composite_grad_rel_l2_vs_f32_max": max(dc.values()),
        "ratio_max": max(ratio.values()),
        "ratio_worst_leaf": max(ratio, key=ratio.get),
        "grad_rel_l2_vs_f32": df, "composite_grad_rel_l2_vs_f32": dc}
    times["bfloat16_gate_s"] = time.perf_counter() - t0
    log(f"[qwen2_train bf16] loss {loss16_f} vs {loss16_c}; distance to "
        f"f32 {max(df.values()):.3e} vs composite {max(dc.values()):.3e}, "
        f"worst ratio {max(ratio.values()):.3f}")
    del g_c, g16_f, g16_c, micro

    # the main path: 8 steps of the train step, counted from zero
    step, _, _ = build_train_step(cfg, Parallel(), opt,
                                  accum=TRAIN["accum"], impl="fused")
    state = adamw_init(master, opt)
    mitigator = StragglerMitigator(TRAIN["places"], period=2)
    params = master
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_counts()
    fa.bwd_route_counts.update(tensor_core=0, fma=0)
    for _ in range(TRAIN["steps"]):
        s0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))    # synchronizes
        walls.append(time.perf_counter() - s0)
        loads = shards.loads()
        mitigator.observe_and_maybe_rebalance(
            walls[-1] * loads / loads.sum(), shards)
    torch.cuda.synchronize()
    read_counts(main_launches)
    times["train_s"] = time.perf_counter() - t0
    n = TRAIN["steps"]
    per_step = {k: v / n for k, v in main_launches.items() if v}
    # steps 2-8 (the first is the warm-up): all their time over all
    # their work, so a stall in any of them shows
    ms = sum(walls[1:]) / (n - 1) * 1e3
    tokens = TRAIN["micro"] * TRAIN["accum"] * TRAIN["seq"]
    out["bfloat16"] = {
        "losses": losses, "step_ms": [w * 1e3 for w in walls],
        "ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
        "median_ms_per_step": statistics.median(walls[1:]) * 1e3,
        "tokens_per_step": tokens,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches_per_step": per_step,
        "flash_bwd_routes": dict(fa.bwd_route_counts),
        "grad_norm": float(metrics["grad_norm"]),
        "straggler_moves": mitigator.moves_applied}
    gate.check(all(np.isfinite(losses)) and losses[-1] < losses[0],
               f"the loss did not fall over {n} steps: {losses}")
    want = {"flash_attention": 4 * cfg.n_layers,
            "flash_attention_bwd": 2 * cfg.n_layers}
    gate.check(all(per_step.get(k) == v for k, v in want.items()),
               f"launches per step {per_step}, not {want}")
    gate.check(fa.bwd_route_counts == {"tensor_core": n * want[
        "flash_attention_bwd"], "fma": 0},
        f"flash backward routes {fa.bwd_route_counts}: every call of the "
        "bf16 main path takes the tensor-core route")
    gate.check(mitigator.moves_applied == 0, "the even cluster moved rows")
    log(f"[qwen2_train] {ms:.1f} ms/step, "
        f"{out['bfloat16']['tokens_per_s']:.0f} tokens/s, peak "
        f"{out['bfloat16']['peak_mem_bytes'] / 2**30:.2f} GiB, losses "
        f"{losses}, launches per step {per_step}")

    # checkpoint round trip of the parameters and the moments
    t0 = time.perf_counter()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    mgr = CheckpointManager(TRAIN_CKPT, keep=1, n_shards=TRAIN["places"])
    tree = {"params": params, "opt": state}
    mgr.save(n, tree)
    saved = time.perf_counter() - t0
    restored, manifest = mgr.restore(tree)
    same = manifest["step"] == n and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves(restored), pytree.tree_leaves(tree)))
    gate.check(same, "checkpoint round trip not bit for bit")
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    out["checkpoint"] = {"save_s": saved,
                         "restore_s": time.perf_counter() - t0 - saved,
                         "bytes": sum(x.nelement() * x.element_size()
                                      for x in pytree.tree_leaves(tree)),
                         "bit_for_bit": same}
    times["checkpoint_s"] = time.perf_counter() - t0
    out["times"] = times
    report["qwen2_train"] = out
    del restored, tree, params, state, master
    torch.cuda.empty_cache()
    gate.close()


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
    device steal loop; each model's bf16 prefill through its kernels and
    8 decode steps; 8 rounds of each elastic serving runtime; the
    paper's workloads; one qwen2-1.5B train step."""
    import torch
    from repro_torch.models import Parallel
    from repro_torch.models import transformer as T
    from repro_torch.serving import DecodeEngine, RealDecodeSim

    stem = Path(path)
    named = lambda tag: stem.with_name(  # noqa: E731
        f"{stem.stem}_{tag}{stem.suffix}")
    out = {"windows_glb": profile_pass(
        lambda: (run_windows(shift), main_path_glb(shift)), path)}
    for key, spec in LM.items():
        free_memory(f"profile {key}", out)
        cfg = lm_config(key)
        params = lm_params(cfg, master=False)[1]
        tokens = torch.randint(0, cfg.vocab_size,
                               (spec["batch"], spec["prompt"]),
                               generator=torch.Generator(device=DEV)
                               .manual_seed(SEED + 5), device=DEV,
                               dtype=torch.int32)

        def prefill_decode():
            st, lg = T.prefill_forward(params, cfg, Parallel(),
                                       {"tokens": tokens}, spec["s_cache"],
                                       impl="fused")
            for _ in range(8):
                st, lg = T.decode_step(
                    params, cfg, Parallel(), st,
                    lg.argmax(-1)[:, None].to(torch.int32))

        out[f"{key}_prefill_decode"] = profile_pass(prefill_decode,
                                                    named(key))
        del params, tokens
        torch.cuda.empty_cache()
    out.update(profile_apps(named, out))
    free_memory("profile qwen2_train", out)
    out["qwen2_train"] = profile_pass(train_step_once(), named("qwen2_train"))
    torch.cuda.empty_cache()
    for key in SERVE_ROUNDS:
        tag = "serving" if key == "qwen2" else f"{key}_serving"
        engine = DecodeEngine(lm_config(key), s_cache=1024, max_batch=8,
                              seed=SEED, device=DEV)
        out[tag] = profile_pass(
            lambda: RealDecodeSim(n_replicas=4, slots=16, work=(1, 1, 3, 1),
                                  preload=(2, 24), glb_period=4,
                                  pipeline_depth=2, seed=SEED,
                                  engine=engine,
                                  transport="device").run(8),
            named(tag))
        del engine
        torch.cuda.empty_cache()
    return out


def train_step_once():
    """One qwen2-1.5B train step of phase 19's main path (a first step
    already taken, so the allocator and the kernels are warm), as a
    closure for the profiler."""
    import dataclasses

    from repro_torch.models import Parallel, zoo
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step

    cfg = dataclasses.replace(lm_config("qwen2"), remat="full")
    _, batch = train_batch(cfg)
    opt = AdamWConfig(lr=TRAIN["lr"], warmup_steps=0)
    step, _, _ = build_train_step(cfg, Parallel(), opt,
                                  accum=TRAIN["accum"], impl="fused")
    params = zoo.init_params(cfg, SEED, device=DEV)
    state = adamw_init(params, opt)
    step(params, state, batch)
    return lambda: step(params, state, batch)


def profile_apps(named, report):
    """The paper's workloads once each under the profiler: 3 K-Means
    iterations (2^24 points, the GLB on the device transport), 2 MolDyn
    steps at size B, 20 PlhamJ rounds of unevenC/level_extremes."""
    from repro_torch.apps import KMeans, MolDyn, PlhamSim

    free_memory("profile apps", report)
    km = KMeans(n_points=KM_POINTS, glb=kmeans_glb(), speeds=KM_SPEEDS,
                device=DEV, **KM)
    md = MolDyn(n_particles=MD_B, device=DEV, **MD)
    md.step()                      # the tiles' pairs, built once
    sim = PlhamSim(**PLHAM_CASES["unevenC"], **PLHAM,
                   strategy="level_extremes", device=DEV)
    out = {"kmeans": profile_pass(
               lambda: [km.iterate() for _ in range(3)] and km.finish(),
               named("kmeans")),
           "moldyn": profile_pass(lambda: [md.step() for _ in range(2)],
                                  named("moldyn")),
           "plham": profile_pass(lambda: sim.run(20), named("plham"))}
    del km, md, sim
    return out


def sass_count(so_path, *ops) -> int:
    """Lines of a built library's SASS (``cuobjdump -sass``) that hold
    any of ``ops``."""
    from repro_torch.kernels import cuda_build

    sass = subprocess.run(
        [str(Path(cuda_build._nvcc()).parent / "cuobjdump"), "-sass",
         str(so_path)], capture_output=True, text=True, timeout=300)
    return sum(any(op in line for op in ops)
               for line in sass.stdout.splitlines())


def flash_build(build_log, so_path):
    """What phase 0 built for flash: ``HGMMA`` (wgmma) instructions in
    the library's SASS, and ptxas' registers and spills for each of the
    TMA kernel's 8 instantiations (bf16/f16 x D 64/128/192/256), from the
    compiler's output that ``cuda_build`` keeps beside the library."""
    import re

    hgmma = sass_count(so_path, "HGMMA")
    kernels, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for \S*flash_tma_kernelI"
                      r"(\w+?)Li(\d+)E", line)
        if m:
            cur = f"{'f16' if 'half' in m.group(1) else 'bf16'} " \
                  f"D={m.group(2)}"
            kernels[cur] = {}
        elif cur and "spill stores" in line:
            kernels[cur]["spill_bytes"] = sum(
                int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif cur and "Used" in line:
            kernels[cur]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            cur = None
    out = {"hgmma": hgmma, "tma_kernels": kernels,
           "serialized": [line.strip() for line in build_log.splitlines()
                          if "C7512" in line]}
    log(f"[build] flash: {hgmma} HGMMA in the SASS; TMA kernels {kernels}")
    require(hgmma > 0, "flash: no wgmma (HGMMA) in libflash_attention.so")
    want = {f"{t} D={d}" for t in ("bf16", "f16") for d in (64, 128, 192,
                                                           256)}
    require(set(kernels) == want and all(
        k.get("spill_bytes") == 0 and "registers" in k
        for k in kernels.values()),
        f"flash: ptxas must report 0 spill bytes and the registers of "
        f"each of {sorted(want)}; the build log gave {kernels}")
    return out


def flash_bwd_build(build_log, so_path):
    """What phase 0 built for the flash backward: ``HGMMA`` (wgmma)
    instructions in the library's SASS (the tensor-core route), and
    ptxas' registers and spills of each kernel: the FMA route's (delta,
    dK/dV, dQ) x (f32, bf16, f16) and the tensor-core route's (rows,
    dK/dV, group sum, dQ) x (bf16, f16), each at D 64 and 128; none may
    spill."""
    import re

    hgmma = sass_count(so_path, "HGMMA")
    kernels, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for \S*?\d(flash_bwd_[a-z_]+)I"
                      r"(\w+?)Li(\d+)E", line)
        if m:
            dt = "f16" if "half" in m.group(2) else \
                "bf16" if "bfloat16" in m.group(2) else "f32"
            cur = f"{m.group(1)} {dt} D={m.group(3)}"
            kernels[cur] = {}
        elif cur and "spill stores" in line:
            kernels[cur]["spill_bytes"] = sum(
                int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif cur and "Used" in line:
            kernels[cur]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            cur = None
    log(f"[build] flash backward: {hgmma} HGMMA in the SASS; {kernels}")
    require(hgmma > 0, "flash backward: no wgmma (HGMMA) in "
            "libflash_attention_bwd.so")
    want = {f"flash_bwd_{k} {t} D={d}" for k in ("delta", "dkdv", "dq")
            for t in ("f32", "bf16", "f16") for d in (64, 128)} \
        | {f"flash_bwd_{k} {t} D={d}" for k in ("rows", "dkdv_tc", "gsum",
                                                 "dq_tc")
           for t in ("bf16", "f16") for d in (64, 128)}
    require(set(kernels) == want and all(
        k.get("spill_bytes") == 0 and "registers" in k
        for k in kernels.values()),
        f"flash backward: ptxas must report 0 spill bytes and the registers "
        f"of each of {sorted(want)}; the build log gave {kernels}")
    return {"hgmma": hgmma, "kernels": kernels}


def mlstm_build(build_log, so_path):
    """What phase 0 built for mlstm: ``HMMA`` (``mma.sync``) instructions
    in the library's SASS, and ptxas' spills for every kernel
    instantiation, from the compiler's output kept beside the library."""
    import re

    hmma = sass_count(so_path, "HMMA", "HGMMA")
    spills, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for \S*?\d(mlstm_[a-z]+_kernel)"
                      r"I(\w+)", line)
        if m:
            cur = f"{m.group(1)}<{m.group(2)}>"
        elif cur and "spill stores" in line:
            spills[cur] = sum(int(x) for x in
                              re.findall(r"(\d+) bytes spill", line))
            cur = None
    out = {"hmma": hmma, "kernels": len(spills),
           "spill_bytes": {k: v for k, v in spills.items() if v}}
    log(f"[build] mlstm: {hmma} HMMA/HGMMA in the SASS; {len(spills)} "
        f"kernels, spills {out['spill_bytes']}")
    require(hmma > 0, "mlstm: no tensor-core (HMMA/HGMMA) instruction in "
            "libmlstm.so")
    kinds = {k.split("<")[0] for k in spills}
    require(kinds >= {"mlstm_gate_kernel", "mlstm_intra_kernel",
                      "mlstm_state_kernel", "mlstm_fma_kernel"}
            and not out["spill_bytes"],
            f"mlstm: ptxas must report 0 spill bytes for every kernel; the "
            f"build log gave {spills}")
    return out


def routed_build(lib, so_path, want, op):
    """What phase 0 built for a library whose kernels have routes: ptxas'
    registers and spill bytes of every kernel instantiation, from the
    compiler's output kept beside the library (``want``: kernel name ->
    the instantiations it must have; none may spill), and the count of
    ``op`` in the library's SASS: ``UTMALDG`` (a TMA tensor load) or
    ``UBLKCP`` (a 1-D bulk copy), the instruction of the new route."""
    import re

    kernels, cur = {}, None
    for line in lib.build_log.splitlines():
        m = re.search(r"Function properties for \S*?\d([a-z_]+_kernel)"
                      r"I(\w+?)E", line)
        if m:
            cur = f"{m.group(1)}<{m.group(2)}>"
            kernels[cur] = {}
        elif cur and "spill stores" in line:
            kernels[cur]["spill_bytes"] = sum(
                int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif cur and "Used" in line:
            kernels[cur]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            cur = None
    n_op = sass_count(so_path, op)
    found = {k: sum(name.startswith(k + "<") for name in kernels)
             for k in want}
    log(f"[build] {lib.name}: {n_op} {op} in the SASS; {kernels}")
    require(n_op > 0, f"{lib.name}: no {op} in lib{lib.name}.so")
    require(found == want and all(
        k.get("spill_bytes") == 0 and "registers" in k
        for k in kernels.values()),
        f"{lib.name}: ptxas must report 0 spill bytes and the registers of "
        f"each of {want} (found {found}); the build log gave {kernels}")
    return {op: n_op, "kernels": kernels}


def brief(rec):
    """``rec`` without its per-leaf tables (they stay in ``--out``)."""
    if isinstance(rec, dict):
        return {k: brief(v) for k, v in rec.items()
                if not k.endswith(("grad_rel_l2", "grad_rel_l2_vs_f32"))}
    return rec


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
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import reloc_codec as rc
    from repro_torch.kernels import rg_lru as rl

    report = {"phases": [], "shift": args.shift,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = smi_line()
    libraries = (rc.LIBRARY, fa.LIBRARY, fa.BWD_LIBRARY, rl.LIBRARY,
                 ml.LIBRARY, md.LIBRARY)
    with Phase("build", report):
        paths = cuda_build.build_all(libraries)
        for lib in libraries:
            lib.lib()
    report["build_log"] = {lib.name: lib.build_log for lib in libraries}
    for lib, path in zip(libraries, paths):
        log(lib.build_log)
        log(f"[build] {path}")
    report["flash_build"] = flash_build(fa.LIBRARY.build_log,
                                        paths[libraries.index(fa.LIBRARY)])
    report["mlstm_build"] = mlstm_build(ml.LIBRARY.build_log,
                                        paths[libraries.index(ml.LIBRARY)])
    report["flash_bwd_build"] = flash_bwd_build(
        fa.BWD_LIBRARY.build_log, paths[libraries.index(fa.BWD_LIBRARY)])
    report["rg_lru_build"] = routed_build(
        rl.LIBRARY, paths[libraries.index(rl.LIBRARY)],
        {"rg_lru_kernel": 3, "rg_lru_tma_kernel": 3}, "UTMALDG")
    report["moe_build"] = routed_build(
        md.LIBRARY, paths[libraries.index(md.LIBRARY)],
        {"gather_rows_kernel": 3, "moe_combine_kernel": 6,
         "moe_combine_bulk_kernel": 3, "moe_combine_regs_kernel": 3},
        "UBLKCP")

    with Phase("kernels", report):
        times = phase_kernels(args.shift, report)
    with Phase("flash_kernel", report):
        times["flash_attention"] = phase_flash(report)
    with Phase("flash_backward", report):
        times["flash_attention_bwd"] = phase_flash_backward(report)
    with Phase("recurrence_kernels", report):
        times.update(phase_recurrence_kernels(report))
    with Phase("moe_kernels", report):
        times.update(phase_moe_kernels(report))

    # main path 1 (phases 2-3): every launch count from zero, read right
    # after
    launches = {}
    reset_counts()
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
        phase_lm("qwen2", report, launches["qwen2_prefill"])
    # main path 3 (phase 6): the elastic serving runtime, counted inside
    launches["serving"] = {}
    with Phase("elastic_serving", report):
        phase_serving(report, launches["serving"])
    # main paths 4-5 (phases 8-9): the recurrent models' fused prefills
    for key in ("recurrentgemma", "xlstm"):
        launches[f"{key}_prefill"] = {}
        with Phase(f"{key}_prefill_decode", report):
            phase_lm(key, report, launches[f"{key}_prefill"])
    # main path 6 (phase 10): serving recurrentgemma-2b
    launches["recurrentgemma_serving"] = {}
    with Phase("recurrentgemma_serving", report):
        phase_serving(report, launches["recurrentgemma_serving"],
                      "recurrentgemma")
    # main path 7 (phase 12): deepseek-v2-lite's fused prefill
    launches["deepseek_prefill"] = {}
    with Phase("deepseek_prefill_decode", report):
        phase_deepseek(report, launches["deepseek_prefill"])
    # main path 8 (phase 13): serving deepseek-v2-lite
    launches["deepseek_serving"] = {}
    with Phase("deepseek_serving", report):
        phase_serving(report, launches["deepseek_serving"], "deepseek")
    # main paths 9-11 (phase 14): the paper's workloads, each counted
    # inside
    for name, run in (("kmeans", phase_kmeans), ("moldyn", phase_moldyn),
                      ("plham", phase_plham)):
        launches[name] = {}
        free_memory(name, report)
        with Phase(name, report):
            run(report, launches[name])
    # main paths 12-14 (phases 15-17): the dense configs' fused prefills
    for key in ("phi4", "gemma3", "gemma2"):
        launches[f"{key}_prefill"] = {}
        free_memory(key, report)
        with Phase(f"{key}_prefill_decode", report):
            phase_lm(key, report, launches[f"{key}_prefill"])
    # main path 15 (phase 19): qwen2-1.5B training, counted inside
    launches["qwen2_train"] = {}
    free_memory("qwen2_train", report)
    with Phase("qwen2_train", report):
        phase_train(report, launches["qwen2_train"])
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
            exact = name.startswith("reloc_")
            kernels.append({
                "name": name, "route": "cuda", "source": lib.source,
                "replaces": replaces, "launches": n,
                "launches_by_path": {k: v.get(name, 0)
                                     for k, v in launches.items()},
                # the phases raised unless every comparison passed: exact
                # for the codec, within the stated tolerance otherwise
                "equal": exact, "within_tol": True,
                "max_abs_err": 0.0 if exact else t["max_abs_err"],
                "ms": t["ms"], "kernel_ms": t["ms"],
                "device_ms": t.get("device_ms"),
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t.get("bound_by", "bytes"),
                "library_ms": t["library_ms"],
                "library_call": t["library_call"], "shape": t["shape"],
                "kernel_route": t.get("route"),
                "kernel_routes": t.get("routes")})
    report["kernels"] = kernels
    report["smi"] = smi
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    for rec in report["phases"]:
        print(json.dumps(rec))
    print(json.dumps({k: report[k] for k in (
        "qwen2", "serving", "recurrentgemma", "xlstm",
        "recurrentgemma_serving", "deepseek", "deepseek_serving",
        "kmeans", "moldyn", "plham", "phi4", "gemma3", "gemma2",
        "flash_d192", "flash_d256", "flash_build", "mlstm_build",
        "flash_backward", "flash_bwd_build", "rg_lru_build", "moe_build")}
        | {"qwen2_train": brief(report["qwen2_train"])}
        | {"launches": launches}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
