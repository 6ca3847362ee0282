"""Device-side lifeline steal loop — the GLB hot path on the card.

The PyTorch port of ``repro.core.spmd_glb``.  The JAX package runs the
whole K-round steal loop inside one jitted SPMD program; here the same
program is tensor code over an explicit leading place dimension:

* **outstanding-work counters** — each place's valid-row count; the
  (n,) load vector every place of the JAX program holds after its psum;
* **lifeline-masked victim selection** — the host policy's BFS
  candidate order is precomputed per thief (:func:`steal_candidates`)
  as a static table; victim selection is a masked first-match over it;
* **hand-off** — a round's move matrix is realized by
  :func:`_ship_hop`: pack per destination, exchange over the place
  dimension (a transpose on one card), compact the receive slots back
  into each place's fixed buffer — cumsum/searchsorted gathers, no
  sort;
* **termination detection** — the round loop (a Python loop, one
  ``.item()`` per round) exits when a whole round acquires nothing.

The plan (:func:`spmd_steal_plan`) mirrors the host ``steal_pass``
semantics *exactly* (``GLBConfig(random_steal_attempts=0)``): thieves
are visited in place order, idleness is judged on round-start loads,
victims on live loads, and the serve count is ``max(1, floor(surplus *
steal_ratio))`` in float32, clamped to the surplus — so the final
per-place load vector and every steal statistic match the host policy.
Which *specific* entries land where may differ between the host loop
and the device loop (count moves let the library pick the entries).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import telemetry
from .distribution import LongRange

__all__ = [
    "steal_candidates",
    "spmd_steal_plan",
    "spmd_steal_step",
    "spmd_steal_loop",
    "run_device_steal",
]


def steal_candidates(lifelines: dict[int, tuple[int, ...]], n: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Per-thief victim candidate order + hop depth, as static tables.

    Row ``t`` lists the places a thief at ``t`` would try, in exactly
    the host ``GlobalLoadBalancer.steal`` order — both consume
    :func:`repro_torch.core.glb.lifeline_bfs`.  Padded with -1; places
    absent from ``lifelines`` (evicted) get all-pad rows.
    """
    from .glb import lifeline_bfs

    k = max(n - 1, 1)
    cand = np.full((n, k), -1, np.int32)
    hops = np.zeros((n, k), np.int32)
    for t in range(n):
        if t not in lifelines:
            continue
        for j, (v, h) in enumerate(lifeline_bfs(lifelines, t)):
            cand[t, j] = v
            hops[t, j] = h
    return cand, hops


def spmd_steal_plan(loads, *, candidates, hops, alive, steal_ratio: float,
                    min_keep: int, idle_threshold: int, capacity: int):
    """One steal round's move plan from the (n,) load vector.

    Deterministic mirror of one host ``steal_pass``: thieves in place
    order; each idle live thief picks the first lifeline candidate whose
    *live* load exceeds ``min_keep`` and steals ``max(1, floor(surplus *
    steal_ratio))`` (clamped to the surplus and to the thief's free
    buffer slots — the latter never binds when the per-place capacity
    covers the global entry count).  Runs on ``loads``' device.

    Returns ``(loads_after, move_matrix, attempted, served, stolen,
    hop_sum)`` as tensors.
    """
    loads = torch.as_tensor(loads).to(torch.int64)
    dev = loads.device
    n = loads.shape[0]
    cand = torch.as_tensor(candidates).to(dev, torch.int64)
    hops = torch.as_tensor(hops).to(dev, torch.int64)
    alive = torch.as_tensor(alive).to(dev, torch.bool)
    ratio = torch.tensor(steal_ratio, dtype=torch.float32, device=dev)
    places = torch.arange(n, device=dev)
    loads0 = loads
    moves = torch.zeros((n, n), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    att, served, stolen, hop_sum = zero, zero, zero, zero
    for i in range(n):
        idle = alive[i] & (loads0[i] <= idle_threshold)
        ci = cand[i]                               # (n-1,) BFS order, -1 pad
        vload = loads[ci.clamp(0, n - 1)]
        can = (ci >= 0) & (vload > min_keep)
        j = torch.argmax(can.to(torch.int8))       # first eligible candidate
        found = idle & can.any()
        victim = ci[j].clamp(0, n - 1)
        surplus = loads[victim] - min_keep
        cnt = torch.floor(surplus.to(torch.float32) * ratio) \
            .to(torch.int64).clamp(min=1)
        cnt = torch.minimum(cnt, surplus.clamp(min=0))
        cnt = torch.minimum(cnt, capacity - loads[i])   # buffer headroom
        cnt = torch.where(found, cnt, zero)
        at_victim = (places == victim).to(torch.int64)
        moves[:, i] += at_victim * cnt
        loads = loads - at_victim * cnt
        loads[i] += cnt
        att = att + idle.to(torch.int64)
        served = served + (cnt > 0).to(torch.int64)
        stolen = stolen + cnt
        hop_sum = hop_sum + torch.where(cnt > 0, hops[i, j], zero)
    return loads, moves, att, served, stolen, hop_sum


def _compact_prefix(x, valid, gids):
    """Establish the prefix invariant: each place's valid rows move to
    slots [0, count) in original order (cumsum rank + scatter into a
    dump slot)."""
    n, S = valid.shape
    vmask = valid.to(torch.bool)
    rank = vmask.to(torch.int64).cumsum(1) - 1
    slot = torch.where(vmask, rank, torch.full_like(rank, S))
    rows = torch.arange(n, device=x.device)[:, None].expand(n, S)
    nx = x.new_zeros((n, S + 1) + tuple(x.shape[2:]))
    nx[rows, slot] = x
    ng = torch.full((n, S + 1), -1, dtype=gids.dtype, device=gids.device)
    ng[rows, slot] = gids
    return nx[:, :-1], ng[:, :-1], vmask.sum(1)


def _ship_hop(x, gids, count, ship):
    """One hand-off of ``ship[s, d]`` rows from every place ``s`` to
    every place ``d``, under the *prefix invariant*: each place's valid
    rows occupy buffer slots ``[0, count)``.

    ``x``: (n, S, ...) row buffers, ``gids``: (n, S) global ids,
    ``count``: (n,) valid rows, ``ship``: (n, n) rows to send.  The first
    ``sum(ship[s])`` rows of place ``s`` leave, grouped by destination
    in rank order; kept rows shift to the front; received rows append
    in source-place order.  Pack and compaction are cumsum/searchsorted
    gathers; the exchange is a transpose of the (src, dest) send
    blocks.  Returns ``(x, gids, new_count)`` with buffer shapes
    unchanged.
    """
    n, S = x.shape[0], x.shape[1]
    dev = x.device
    tail1 = (1,) * (x.dim() - 2)
    ship = torch.as_tensor(ship).to(dev, torch.int64)
    count = torch.as_tensor(count).to(dev, torch.int64)
    k = torch.arange(S, device=dev)
    me = torch.arange(n, device=dev)

    # send buffer (src, dest, S): slot (d, r) <- outgoing row offs[d] + r
    total_out = ship.sum(1)
    offs = ship.cumsum(1) - ship
    src = (offs[:, :, None] + k).clamp_(0, S - 1)
    send_mask = k < ship[:, :, None]
    sx = x[me[:, None, None], src]
    sx.masked_fill_(~send_mask.reshape(send_mask.shape + tail1), 0)
    sg = gids[me[:, None, None], src].masked_fill_(~send_mask, -1)
    # the exchange: what src s packed for d lands at rx[d, s]
    rx = sx.transpose(0, 1)
    rg = sg.transpose(0, 1)

    rc = ship.t()                                  # incoming counts
    crc = rc.cumsum(1)
    crc_prev = crc - rc
    kept = count - total_out
    new_count = kept + crc[:, -1]
    # slot k: kept rows first (shifted down past the departed prefix),
    # then each source block's contiguous received prefix
    j = k[None, :] - kept[:, None]
    b = torch.searchsorted(crc, j, right=True).clamp_(0, n - 1)
    flat = (b * S + (j - crc_prev.gather(1, b))).clamp_(0, n * S - 1)
    rb, rt = flat // S, flat % S
    from_kept = k[None, :] < kept[:, None]
    live = k[None, :] < new_count[:, None]
    keep_src = (total_out[:, None] + k).clamp_(0, S - 1)
    rows = me[:, None].expand(n, S)
    nx = torch.where(from_kept.reshape(from_kept.shape + tail1),
                     x[rows, keep_src], rx[rows, rb, rt])
    ng = torch.where(from_kept, gids[rows, keep_src], rg[rows, rb, rt])
    nx.masked_fill_(~live.reshape(live.shape + tail1), 0)
    ng = ng.masked_fill(~live, -1)
    return nx, ng, new_count


def _transport(before, after):
    """(n, n) row-flow matrix realizing the load change ``before →
    after`` with minimal shuffling: every place keeps ``min(before,
    after)`` rows, and the residual surpluses route to the residual
    deficits by the northwest-corner rule (zero diagonal)."""
    keep = torch.minimum(before, after)
    supply = before - keep
    demand = after - keep
    cum_s = supply.cumsum(0)
    cum_d = demand.cumsum(0)
    lo = torch.maximum((cum_s - supply)[:, None], (cum_d - demand)[None, :])
    hi = torch.minimum(cum_s[:, None], cum_d[None, :])
    return (hi - lo).clamp(min=0)


def _apply_moves(x, gids, count, moves, loads):
    """Execute a round's (n, n) move matrix with hand-offs, honoring
    intra-round steal *chains*: every hop each place ships what its
    current inventory covers (greedy, in destination order) and the
    remainder waits for the next hop; at most n-1 hops resolve
    everything."""
    n = loads.shape[0]
    remaining = torch.as_tensor(moves).to(x.device, torch.int64)
    inv = torch.as_tensor(loads).to(x.device, torch.int64)
    hop = 0
    while hop < n and int(remaining.sum()) > 0:
        cum = remaining.cumsum(1)
        prev = cum - remaining
        ship = torch.minimum(
            (torch.minimum(cum, inv[:, None]) - prev).clamp(min=0),
            remaining)
        x, gids, count = _ship_hop(x, gids, count, ship)
        inv = inv - ship.sum(1) + ship.sum(0)
        remaining = remaining - ship
        hop += 1
    return x, gids, count


def spmd_steal_step(x, valid, gids, *, candidates, hops, alive,
                    steal_ratio: float, min_keep: int, idle_threshold: int):
    """One steal round: count the outstanding work, plan
    (lifeline-masked victim selection), and hand off rows (one exchange
    per intra-round chain hop, see :func:`_apply_moves`).

    ``x``/``valid``/``gids`` are every place's fixed-size row buffer
    ``(n, S, ...)``, validity mask and global entry ids.  Returns ``(x,
    valid, gids, info)`` with shapes unchanged (rows compact to a
    prefix of each place's buffer).
    """
    x, gids, count = _compact_prefix(x, valid, gids)
    S = x.shape[1]
    loads = count
    loads_after, moves, att, served, stolen, hop_sum = spmd_steal_plan(
        loads, candidates=candidates, hops=hops, alive=alive,
        steal_ratio=steal_ratio, min_keep=min_keep,
        idle_threshold=idle_threshold, capacity=S)
    x, gids, count = _apply_moves(x, gids, count, moves, loads)
    info = {"moved": moves.sum(), "loads": loads_after, "attempted": att,
            "served": served, "stolen": stolen, "hops": hop_sum}
    k = torch.arange(S, device=x.device)
    return x, k[None, :] < count[:, None], gids, info


def spmd_steal_loop(x, valid, gids, *, candidates, hops, alive,
                    steal_ratio: float, min_keep: int, idle_threshold: int,
                    max_rounds: int, assume_prefix: bool = False):
    """K steal rounds: a loop of :func:`spmd_steal_plan` over the load
    vector that exits as soon as a whole round acquires nothing (the
    host loop's ``while steal_pass() > 0``), then one :func:`_ship_hop`
    realizes the rounds' net row flow.

    Returns a dict with the final ``x``/``valid``/``gids`` buffers,
    ``rounds`` executed, aggregate steal stats (ints), and
    ``terminated`` — nothing moved and every live place idle."""
    gids = gids.to(torch.int32)
    S = x.shape[1]
    k = torch.arange(S, device=x.device)
    if assume_prefix:
        # caller guarantees valid rows occupy slots [0, count) — as
        # run_device_steal packs them — so the compaction is skipped
        count = valid.to(torch.int64).sum(1)
        gids = torch.where(k[None, :] < count[:, None], gids,
                           torch.full_like(gids, -1))
    else:
        x, gids, count = _compact_prefix(x, valid, gids)
    loads0 = count

    # the rounds iterate on the counters only: each round's plan is a
    # pure function of the load vector, and rows are fungible, so the
    # rounds' cumulative effect on data is realized afterwards by one
    # hand-off
    loads = loads0
    rounds = att = served = stolen = hop_sum = 0
    moved_last = 1
    while rounds < max_rounds and moved_last != 0:
        loads, moves, a, s, st_, h = spmd_steal_plan(
            loads, candidates=candidates, hops=hops, alive=alive,
            steal_ratio=steal_ratio, min_keep=min_keep,
            idle_threshold=idle_threshold, capacity=S)
        stats = torch.stack([moves.sum(), a, s, st_, h]).tolist()
        moved_last = stats[0]
        att += stats[1]
        served += stats[2]
        stolen += stats[3]
        hop_sum += stats[4]
        rounds += 1
    # keep min(before, after) rows in place, route the residual
    # surpluses to the residual deficits (northwest-corner transport)
    ship = _transport(loads0, loads)
    x, gids, count = _ship_hop(x, gids, count, ship)
    alive_t = torch.as_tensor(alive).to(x.device, torch.bool)
    all_idle = bool(torch.all(torch.where(
        alive_t, loads <= idle_threshold, torch.ones_like(alive_t))))
    return {
        "x": x, "valid": k[None, :] < count[:, None], "gids": gids,
        "rounds": rounds, "attempted": att, "served": served,
        "stolen": stolen, "hops": hop_sum,
        "terminated": moved_last == 0 and all_idle,
    }


# ---------------------------------------------------------------------------
# Host wrapper: DistArray -> place buffers -> steal loop -> DistArray
# ---------------------------------------------------------------------------
def run_device_steal(col, lifelines: dict[int, tuple[int, ...]],
                     alive: Sequence[int], *, steal_ratio: float,
                     min_keep: int, idle_threshold: int,
                     max_rounds: int = 12,
                     capacity: int | None = None,
                     ship_rows: bool = False) -> dict:
    """Run the device steal loop over a tracked :class:`DistArray`.

    Packs each place's entries into a fixed ``capacity``-slot buffer on
    the collection's device, runs all rounds, then rebuilds the
    per-place chunks and reconciles the tracked distribution **once**
    at the end (a single ``update_dist``, versus one per host steal).

    Two data planes, selected by ``ship_rows``:

    * ``ship_rows=False`` — entry ids are the relocated payload; the
      rows are gathered by id from the original chunks afterwards.
    * ``ship_rows=True`` — each row is encoded to bytes by the
      collection's row codec and rides the hand-off next to its id; the
      receiver decodes the block (through the ``decode_rows`` kernel on
      the fused backend).  Both planes run the identical plan, so they
      produce *bit-identical* final collection state.

    ``capacity`` defaults to the global entry count — the always-safe
    bound under which the plan's buffer clamp never binds.
    """
    with telemetry.span("glb.device_loop", ship_rows=ship_rows) as sp:
        res = _run_device_steal(
            col, lifelines, alive, steal_ratio=steal_ratio,
            min_keep=min_keep, idle_threshold=idle_threshold,
            max_rounds=max_rounds, capacity=capacity, ship_rows=ship_rows)
        if sp:
            sp.set(rounds=res["rounds"], stolen=res["stolen"],
                   capacity=res["capacity"])
        return res


def _run_device_steal(col, lifelines, alive, *, steal_ratio, min_keep,
                      idle_threshold, max_rounds, capacity,
                      ship_rows) -> dict:
    from .collections import _dtype_token
    from .transport import _encode_rows

    members = tuple(col.group.members)
    n = len(members)
    dev = col.device
    empty = {"rounds": 0, "attempted": 0, "served": 0, "stolen": 0,
             "hops": 0, "bytes_moved": 0, "terminated": True,
             "capacity": 0}
    if n < 2:
        return empty
    per_place = [col.to_local_matrix(p) for p in members]
    sizes = [len(idx) for _, idx in per_place]
    total = sum(sizes)
    if total == 0:
        return empty
    first = next(rows for rows, idx in per_place if len(idx))
    trail = tuple(first.shape[1:])
    orig_dtype = first.dtype
    row_nbytes = int(np.prod(trail, dtype=np.int64)) * orig_dtype.itemsize
    S = int(capacity) if capacity is not None else total
    if max(sizes) > S:
        raise ValueError(
            f"capacity {S} < largest resident shard {max(sizes)}")
    valid = torch.zeros((n, S), dtype=torch.bool, device=dev)
    gids = torch.full((n, S), -1, dtype=torch.int32, device=dev)
    for i, (rows, idx) in enumerate(per_place):
        m = len(idx)
        if m == 0:
            continue
        if idx.max() >= np.iinfo(np.int32).max:
            raise ValueError("global indices exceed the int32 id payload")
        valid[i, :m] = True
        gids[i, :m] = torch.from_numpy(idx.astype(np.int32)).to(dev)
    if ship_rows:
        # codec-encoded byte rows ride the hand-off (via the transport's
        # donation probe: DistArray hands back zero-copy byte views)
        x = torch.zeros((n, S, row_nbytes), dtype=torch.uint8, device=dev)
        for i, (rows, idx) in enumerate(per_place):
            m = len(idx)
            if m:
                u8, _ = _encode_rows(col, (LongRange(0, m), rows))
                x[i, :m] = u8
    else:
        # the id column doubles as the payload for the id plane
        x = torch.where(valid, gids, torch.zeros_like(gids))[:, :, None]
    cand, hops = steal_candidates(lifelines, n)
    alive_mask = np.zeros(n, np.bool_)
    alive_mask[list(alive)] = True
    out = spmd_steal_loop(
        x, valid, gids, candidates=torch.from_numpy(cand).to(dev),
        hops=torch.from_numpy(hops).to(dev),
        alive=torch.from_numpy(alive_mask).to(dev),
        steal_ratio=float(steal_ratio), min_keep=int(min_keep),
        idle_threshold=int(idle_threshold), max_rounds=int(max_rounds),
        assume_prefix=True)

    nvalid, ngids = out["valid"], out["gids"]
    if int(nvalid.sum()) != total:
        raise RuntimeError(f"device steal lost rows: {int(nvalid.sum())} "
                           f"of {total} left")
    if not ship_rows:
        # id -> row lookup over the original chunks (dtype-exact)
        all_rows = torch.cat([rows for rows, idx in per_place if len(idx)])
        all_idx = torch.from_numpy(np.concatenate(
            [idx for _, idx in per_place if len(idx)])).to(dev)
        order = torch.argsort(all_idx, stable=True)
        all_rows, all_idx = all_rows[order], all_idx[order]
    # rebuild the chunks: each place's relocated ids sorted, split into
    # consecutive runs; one update_dist reconciles the distribution
    with col._lock:
        for p in members:
            col.handle(p).chunks.clear()
        for i, p in enumerate(members):
            v = nvalid[i]
            g = ngids[i][v].to(torch.int64)
            if g.numel() == 0:
                continue
            order = torch.argsort(g, stable=True)
            g = g[order]
            if ship_rows:
                # decode the relocated byte rows directly — the rows
                # arrived with their ids
                blk = out["x"][i][v][order]
                _, r = col.decode_rows(
                    blk, ("chunk", LongRange(0, len(g)),
                          _dtype_token(orig_dtype), trail))
            else:
                r = all_rows[torch.searchsorted(all_idx, g)]
            g_np = g.cpu().numpy()
            cuts = np.nonzero(np.diff(g_np) != 1)[0] + 1
            starts = np.concatenate([[0], cuts])
            ends = np.concatenate([cuts, [len(g_np)]])
            for s0, s1 in zip(starts.tolist(), ends.tolist()):
                col.handle(p).add_chunk(
                    LongRange(int(g_np[s0]), int(g_np[s1 - 1]) + 1),
                    r[s0:s1])
    if col.track:
        col.update_dist()
    return {
        "rounds": out["rounds"],
        "attempted": out["attempted"],
        "served": out["served"],
        "stolen": out["stolen"],
        "hops": out["hops"],
        "bytes_moved": out["stolen"] * row_nbytes,
        "terminated": out["terminated"],
        "capacity": S,
    }
