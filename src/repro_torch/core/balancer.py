"""Dynamic load balancing (paper §4.5, §6.3).

The paper's loop: every ``lbPeriod`` iterations, places exchange their
accumulated compute time (``allGather1``), each place decides what to
give away (``performLoadBalance``), the relocation runs *concurrently
with the master's critical-path compute*, and ``updateDist`` reconciles
the distribution afterwards.

Strategies:

* :class:`LevelExtremes` — the paper's strategy: move entries from the
  single most-loaded place to the single least-loaded place, enough to
  level the two (conservative: half the gap).
* :class:`Proportional` — beyond-paper: estimate per-place throughput
  (entries/second) from the same measurements and redistribute *all*
  places toward time-optimal loads in one plan (multi-source,
  multi-destination).  Converges in ~1 step where level-extremes takes
  O(places) steps; used for straggler mitigation in the training loop.

Both emit *move plans* — lists of (src, dest, count) — which callers
turn into ``CollectiveMoveManager`` registrations (host collections) or
batch-range reassignments (training data shards / serving caches).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["LevelExtremes", "Proportional", "LoadBalancer", "BalanceDecision"]


@dataclass(frozen=True)
class BalanceDecision:
    moves: tuple[tuple[int, int, int], ...]  # (src place, dest place, n entries)

    @property
    def total_moved(self) -> int:
        return sum(m[2] for m in self.moves)


class LevelExtremes:
    """Paper §4.5 'level-extremes': pairwise leveling of the extremes.

    Move count: enough entries from the slowest place to equalize its
    *time* with the fastest, assuming local per-entry cost — i.e.
    ``n = load_max * (t_max - t_min) / (2 * t_max)`` (halved so the pair
    meets in the middle), clamped to at least 1 when any gap exists.
    """

    def __init__(self, min_gap: float = 0.05):
        self.min_gap = min_gap  # relative gap below which we do nothing

    def plan(self, times: np.ndarray, loads: np.ndarray) -> BalanceDecision:
        times = np.asarray(times, np.float64)
        loads = np.asarray(loads, np.int64)
        active = loads > 0
        if not np.any(active) or np.all(times <= 0):
            return BalanceDecision(())
        src = int(np.argmax(np.where(active, times, -np.inf)))
        dest = int(np.argmin(times))
        if src == dest:
            return BalanceDecision(())
        t_max, t_min = float(times[src]), float(times[dest])
        if t_max <= 0 or (t_max - t_min) / t_max < self.min_gap:
            return BalanceDecision(())
        n = int(round(loads[src] * (t_max - t_min) / (2.0 * t_max)))
        n = max(1, min(n, int(loads[src]) - 1))
        return BalanceDecision(((src, dest, n),))


class Proportional:
    """Beyond-paper: one-shot proportional redistribution.

    Per-place throughput ``r_i = load_i / time_i``; optimal loads are
    ``L * r_i / sum(r)``.  Overloaded places ship their surplus to
    underloaded ones greedily (largest surplus → largest deficit), which
    yields at most ``2*(P-1)`` moves.  ``damping`` < 1 moves only a
    fraction of the surplus per round (stability under noisy timings).
    """

    def __init__(self, damping: float = 1.0, min_gap: float = 0.05):
        self.damping = damping
        self.min_gap = min_gap

    def plan(self, times: np.ndarray, loads: np.ndarray) -> BalanceDecision:
        times = np.asarray(times, np.float64)
        loads = np.asarray(loads, np.float64)
        total = loads.sum()
        if total <= 0 or np.all(times <= 0):
            return BalanceDecision(())
        rel_gap = (times.max() - times.min()) / max(times.max(), 1e-12)
        if rel_gap < self.min_gap:
            return BalanceDecision(())
        # throughput; places with zero load get the mean rate as a prior
        with np.errstate(divide="ignore", invalid="ignore"):
            rate = np.where((times > 0) & (loads > 0), loads / times, np.nan)
        rate = np.where(np.isnan(rate), np.nanmean(rate), rate)
        target = total * rate / rate.sum()
        delta = (loads - target) * self.damping
        surplus = [(int(i), d) for i, d in enumerate(delta) if d >= 1]
        deficit = [(int(i), -d) for i, d in enumerate(delta) if d <= -1]
        surplus.sort(key=lambda t: -t[1])
        deficit.sort(key=lambda t: -t[1])
        moves = []
        si = di = 0
        while si < len(surplus) and di < len(deficit):
            s, savail = surplus[si]
            d, dneed = deficit[di]
            n = int(min(savail, dneed))
            if n >= 1:
                moves.append((s, d, n))
            savail -= n
            dneed -= n
            if savail < 1:
                si += 1
            else:
                surplus[si] = (s, savail)
            if dneed < 1:
                di += 1
            else:
                deficit[di] = (d, dneed)
        return BalanceDecision(tuple(moves))


class LoadBalancer:
    """Periodic balancer harness (paper Listing 7).

    Accumulates per-place compute times between triggers, exchanges them
    (allGather1), asks the strategy for a plan, and exposes the plan for
    the caller to execute concurrently with its critical-path work —
    then expects ``updateDist`` on tracked collections.
    """

    def __init__(self, n_places: int, strategy=None, period: int = 10,
                 ema: float = 0.0):
        self.n_places = n_places
        self.strategy = strategy or LevelExtremes()
        self.period = period
        self.ema = ema  # smooth timings across windows (0 = paper behavior)
        self._acc = np.zeros(n_places, np.float64)
        self._smoothed = None
        self.iter = 0
        self.history: list[BalanceDecision] = []

    def record(self, place: int, seconds: float) -> None:
        self._acc[place] += seconds

    def record_all(self, seconds) -> None:
        self._acc += np.asarray(seconds, np.float64)

    def step(self, loads) -> BalanceDecision | None:
        """Advance one iteration; every ``period`` iterations produce a
        plan (or None in between).  Resets the accumulated times after
        each trigger, as the paper does (Listing 7 line 17)."""
        self.iter += 1
        if self.iter % self.period != 0:
            return None
        times = self._acc.copy()
        if self.ema > 0:
            if self._smoothed is None:
                self._smoothed = times
            else:
                self._smoothed = self.ema * self._smoothed + (1 - self.ema) * times
            times = self._smoothed
        decision = self.strategy.plan(times, np.asarray(loads))
        self._acc[:] = 0.0
        self.history.append(decision)
        return decision
