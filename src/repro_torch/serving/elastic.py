"""Elastic serving runtime: traffic-driven KV-shard migration with
failure-aware placement.  The port of ``repro.serving.elastic``; the
replicas are places of one :class:`~repro_torch.core.PlaceGroup` on the
driver's device (``cuda`` unless the caller asks for the CPU).

:class:`ElasticServingDriver` composes the pieces the ROADMAP's two
serving items call for:

* a :class:`~repro_torch.serving.workload.TrafficWorkload` (sequence metadata
  + KV pages as co-partitioned ``DistIdMap`` collections) driven by a
  :class:`~repro_torch.core.glb.GlobalLoadBalancer` whose relocation windows
  run through ``CollectiveMoveManager.sync_async`` — KV-shard migration
  overlaps the decode steps;
* a :class:`~repro_torch.serving.router.Router` that admits/dispatches against
  the live tracked distribution and stays consistent across migrations;
* a :class:`~repro_torch.runtime.fault_tolerance.HeartbeatMonitor` +
  :class:`~repro_torch.runtime.fault_tolerance.ElasticWorld` failure path: a
  dead replica is evicted from the lifeline graph
  (``GlobalLoadBalancer.evict_place``), its in-flight sequences re-home
  through the relocation engine (``rehome_dead_place`` under
  ``ElasticWorld.evict``), and the ``PlaceGroup`` shrinks.

:class:`ServingSim` wraps the driver in a simulated replica cluster
(decode time grows with resident KV pages, divided by per-replica
speed) with an arrival process and a failure schedule — the §6.3
"disturbed cluster" methodology transplanted to serving, used by
``tests/test_serving.py`` and the ``serving_*`` benchmark rows.

The *real* data plane swaps the model for measurement: construct the
driver with ``engine=DecodeEngine()`` and call :meth:`decode_round` —
``decode_step`` runs every replica's resident batch over device-resident
``SeqKV`` tensors and the measured wall-clock times feed the same
EWMA/GLB path (see ``serving/decode.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core import DistIdMap, GLBConfig, GlobalLoadBalancer, PlaceGroup
from ..core import telemetry
from ..runtime.fault_tolerance import ElasticWorld, HeartbeatMonitor
from .cache import Sequence
from .router import Router
from .workload import TokenCostModel, TrafficWorkload

__all__ = ["ElasticServingDriver", "ServingSim", "window_p95"]


def window_p95(step_times, window: int) -> list[float]:
    """Per-window p95 of lockstep round times (windows = GLB periods) —
    shared by the simulated and real-decode harnesses."""
    w = max(int(window), 1)
    times = np.asarray(step_times)
    return [float(np.percentile(times[i:i + w], 95))
            for i in range(0, len(times) - w + 1, w)]


class ElasticServingDriver:
    """Continuous-batching serving pool with traffic-driven rebalancing
    and failure-aware placement."""

    def __init__(self, n_replicas: int, *, slots_per_replica: int = 32,
                 glb: GLBConfig | None = None, heartbeat_timeout: int = 2,
                 page_tokens: int = 16, traffic_ema: float = 0.5,
                 engine=None, admission: str = "traffic",
                 transport=None, sanitize: bool = False, device=None):
        if admission not in ("traffic", "count"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if sanitize:
            # turn the relocation sanitizer on for every KV-migration
            # window this driver launches (race detector guards the
            # admit/retire vs in-flight-window interleavings)
            from ..analysis import sanitizer as _san
            _san.enable()
        if device is None and engine is not None:
            device = engine.device
        self.group = PlaceGroup(n_replicas, device=device)
        self.slots = slots_per_replica
        self.engine = engine           # real data plane (serving.decode)
        self.admission = admission
        self.seqs = DistIdMap(self.group)
        self.kv = DistIdMap(self.group)
        for p in self.group.members:   # eager handles: empty != unknown
            self.seqs.handle(p)
            self.kv.handle(p)
        self.cost = TokenCostModel(page_tokens)
        # explicit driver transport beats the GLB config's default
        # (TrafficWorkload resolves the spec; a non-None workload
        # transport wins at balancer attach); "device" makes every KV
        # migration window ship its pages through the device exchange
        # (no host bounce)
        self.workload = TrafficWorkload(self.seqs, self.kv,
                                        cost_model=self.cost,
                                        ema=traffic_ema,
                                        transport=transport)
        self.router = Router(self.seqs)
        self.glb = GlobalLoadBalancer(
            self.group, self.workload,
            glb or GLBConfig(period=4, policy="proportional", ema=0.3),
            on_finish=self._window_finished)
        # resolved data plane (the GLB filled a None in from its config)
        self.transport = self.workload.transport
        self.monitor = HeartbeatMonitor(n_replicas,
                                        timeout_steps=heartbeat_timeout)
        self.world = ElasticWorld(self.group)
        self.next_id = 0
        self.admitted = 0
        self.completed: list[int] = []
        self.evicted: list[int] = []
        self.rehomed_seqs = 0
        self._kv_gc: set[int] = set()   # retired seqs whose KV is in flight
        self._refreshes = 0             # window-boundary refreshes fired
        self._admit_traffic = None      # per-round cache of workload.loads()

    def _window_finished(self, handle) -> None:
        """A migration window delivered and reconciled the tracked
        distributions: reap orphaned KV and rebuild the router's dispatch
        table — once per window, not per request (Router at scale)."""
        self._refreshes += 1
        with telemetry.span("serve.dispatch_refresh",
                            refresh=self._refreshes):
            self._collect_orphaned_kv()
            self.router.refresh()

    # -- admission (alive replicas only) ----------------------------------
    def admit(self, prompt_len: int, max_new: int = 64,
              place: int | None = None) -> int | None:
        """Admit one request onto the least-*traffic* replica of the
        current place group (EWMA-weighted load — the same units the GLB
        balances); None when every live replica is full.  Placing by raw
        sequence count would fight the balancer: a slow replica that
        just shed its sequences is exactly the one raw counts would
        refill.  ``place`` pins the placement (a sticky-session router,
        or a skewed-arrival harness); ``admission="count"`` at
        construction restores the raw-count policy."""
        members = list(self.group.members)
        counts = np.asarray([self.seqs.local_size(p) for p in members])
        if place is not None:
            if place not in self.group:
                raise KeyError(f"place {place} not in {self.group}")
            i = members.index(place)
            if counts[i] >= self.slots:
                return None
        else:
            if self.admission == "traffic":
                # loads() walks every resident sequence — compute once
                # per decode round (step() invalidates), not per request;
                # the count tiebreak still spreads a same-round burst
                if self._admit_traffic is None:
                    self._admit_traffic = self.workload.loads()
                traffic = self._admit_traffic
                tr = np.asarray([traffic[self.workload.members.index(p)]
                                 for p in members], np.float64)
            else:
                tr = counts.astype(np.float64)
            for i in np.lexsort((counts, tr)):  # least traffic, then count
                if counts[i] < self.slots:
                    break
            else:
                return None
        p = members[i]               # a members index, not a place id
        sid = self.next_id
        self.next_id += 1
        seq = Sequence(sid, prompt_len, max_new=max_new)
        self.seqs.put(p, sid, seq)
        if self.engine is not None:
            # real data plane: the KV payload is a batch-1 slice of the
            # model's decode state, bridged to the group's device —
            # migration windows ship device tensors from here on
            self.kv.put(p, sid, self.engine.new_seq(prompt_len))
            self.kv.to_device(p, keys=(sid,))
        else:
            # KV token budget allocated up front (prompt + generation room)
            budget = self.cost.pages(
                Sequence(sid, prompt_len, generated=max_new))
            self.kv.put(p, sid, np.zeros((budget, self.cost.page_tokens),
                                         np.float32))
        self.admitted += 1
        return sid

    # -- one decode round --------------------------------------------------
    def step(self, decode_times, failed=()) -> dict:
        """Advance one lockstep decode round.

        ``decode_times`` is aligned to the *initial* member order (use
        NaN for replicas that produced nothing); ``failed`` lists
        replicas that went silent this round — they miss their heartbeat
        and are evicted once the monitor times them out.
        """
        info: dict = {}
        self._settle_device_plane_extraction()
        self._admit_traffic = None     # residency changes this round
        failed = set(failed)
        for p in self.group.members:
            if p not in failed:
                self.monitor.beat(p)
        for dead in self.monitor.tick():
            self._evict(dead)
            info.setdefault("evicted", []).append(dead)
        # decode: advance resident sequences on live replicas, retire done
        for p in self.group.members:
            if p in failed:
                continue
            h = self.seqs.handle(p)
            kvh = self.kv.handle(p)
            for sid in list(h):
                # sequences chosen for migration extract on the async
                # window's background thread — skip ones already in flight
                s = h.get(sid)
                if s is None:
                    continue
                s.generated += 1
                if s.done:
                    # retire only if we win the pop: the background
                    # thread may have extracted the sequence into a
                    # migration payload after our get() — then it is
                    # in flight, not finished, and retires at the
                    # destination next round (kv stays untouched here
                    # so the pair migrates together)
                    if h.pop(sid, None) is not None:
                        if kvh.pop(sid, None) is None:
                            # the async window already extracted the KV
                            # pages — they will land at the destination
                            # with no owning sequence; collect them once
                            # the window delivers
                            self._kv_gc.add(sid)
                        self.completed.append(sid)
        # traffic-keyed rebalance (async: migration overlaps next round)
        t = np.asarray(decode_times, np.float64)
        self.workload.observe(t)
        self.glb.record_all(np.where(np.isfinite(t), t, 0.0))
        before = self._refreshes
        decision = self.glb.step()
        if decision is not None:
            info["rebalance"] = decision
            if not self.glb.has_pending() and self._refreshes == before:
                # window boundary with nothing in flight (zero moves, or
                # every move clamped away) and no delivery barrier fired
                # inside glb.step(): refresh here — otherwise a balanced
                # cluster would never pick up new admissions.  Orphaned
                # KV can only surface at a delivery, so the boundary
                # hooks cover collection too.
                self._window_finished(None)
        return info

    # -- one real decode round (the measured data plane) -------------------
    def decode_round(self, failed=(), work=None) -> dict:
        """Advance one lockstep round against the real
        :class:`~repro_torch.serving.decode.DecodeEngine`: every live
        replica decodes its resident batch through the model, and the
        *measured* per-replica wall-clock times feed the traffic EWMA and
        the GLB cost exchange (no simulated decode times anywhere).

        ``work[i]`` (aligned to the initial member order) repeats
        replica ``i``'s decode that many times — a slow chip whose extra
        compute really runs.  Returns the :meth:`step` info dict plus
        ``decode_s`` (measured seconds per member) and ``decoded``
        (sequences advanced).

        With ``GLBConfig(pipeline_depth=2)`` migration windows double
        buffer around the decode rounds: window N's KV delivery (and
        distribution reconciliation) runs on a background thread while
        this round decodes and window N+1 packs — the decode loop skips
        in-flight pairs exactly as it does for extraction, and the
        Router refresh still fires once per window at commit."""
        if self.engine is None:
            raise ValueError("decode_round needs an engine "
                             "(ElasticServingDriver(..., engine=...))")
        with telemetry.span("serve.decode_round") as sp:
            self._settle_device_plane_extraction()
            members = self.workload.members
            t = np.full(len(members), np.nan)
            decoded = 0
            failed = set(failed)
            for i, p in enumerate(members):
                if p not in self.group or p in failed:
                    continue
                seqh = self.seqs.handle(p)
                kvh = self.kv.handle(p)
                batch = []
                for sid in list(kvh):
                    # an in-flight migration window extracts entries on
                    # its background thread — decode only pairs still
                    # resident
                    kv = kvh.get(sid)
                    if kv is not None and seqh.get(sid) is not None:
                        batch.append(kv)
                w = 1 if work is None else int(work[i])
                with telemetry.context(place=p):
                    t[i] = self.engine.decode_batch(batch, work=w)
                decoded += len(batch)
            info = self.step(t, failed=failed)
            info["decode_s"] = t
            info["decoded"] = decoded
            if sp:
                sp.set(decoded=decoded)
            return info

    def _settle_device_plane_extraction(self) -> None:
        """Device-plane windows deliver point-in-time *reconstructions*
        (the codec encodes at delivery), so a round that mutates
        resident entries must not start until the in-flight window's
        extraction finished — otherwise an entry grabbed between the
        residency check and extraction could be mutated while the
        background encode reads it (stale or torn payload at the
        destination).  Host-plane windows deliver the objects
        themselves, where late mutations land by design, so they skip
        this wait.  Extraction overlaps the *previous* round's tail, so
        the wait is normally instant."""
        if getattr(self.workload.transport, "device_plane", False):
            self.glb.wait_extracted()

    def _collect_orphaned_kv(self) -> None:
        """Reap KV pages whose sequence retired while the pages were in
        a migration window (they get delivered ownerless)."""
        for sid in list(self._kv_gc):
            for p in self.group.members:
                if self.kv.handle(p).pop(sid, None) is not None:
                    self._kv_gc.discard(sid)
                    break

    def _evict(self, dead: int) -> None:
        """The fault-tolerant-GLB path: stop routing to the dead replica,
        settle the in-flight window, re-home its sequences + KV pages on
        the survivors, drop it from the lifeline graph, and shrink the
        place group.  ``mark_dead`` comes first: the window barrier fires
        a router refresh, which must not re-drive parked retries onto the
        replica being evicted."""
        self._admit_traffic = None
        self.router.mark_dead(dead)
        self.glb.finish()
        before = self.seqs.local_size(dead) if dead in self.group else 0
        self.group = self.world.evict(dead, (self.seqs, self.kv),
                                      transport=self.transport)
        self.glb.evict_place(self.workload.members.index(dead))
        self.rehomed_seqs += before
        self.evicted.append(dead)
        self.router.refresh()

    # -- barriers / accounting --------------------------------------------
    def sync(self) -> None:
        """Drain the in-flight migration window and re-snapshot the
        router (the reconciling barrier)."""
        self.glb.finish()
        self._collect_orphaned_kv()
        self.router.refresh()

    def live(self) -> int:
        return self.seqs.global_size()

    def lost(self) -> int:
        """Sequences unaccounted for (must stay 0): admitted but neither
        resident nor completed.  Call :meth:`sync` first so in-flight
        migrations are delivered."""
        return self.admitted - self.live() - len(self.completed)

    def loads(self) -> np.ndarray:
        return np.asarray([self.seqs.local_size(p)
                           for p in self.group.members], np.int64)


@dataclass
class ServingSim:
    """Simulated replica cluster around an :class:`ElasticServingDriver`.

    Replica ``p`` decodes a lockstep batch in
    ``(base_us + per_page_us * resident KV pages) / speeds[p]`` simulated
    microseconds; the slowest live replica sets the step time.  Requests
    arrive Poisson(``arrival_rate``) per step; ``fail_at`` maps step
    index → replica id to kill (it stops heartbeating and decoding).
    """

    n_replicas: int = 8
    slots: int = 32
    speeds: tuple = ()
    base_us: float = 200.0
    per_page_us: float = 8.0
    arrival_rate: float = 4.0
    prompt_range: tuple = (16, 96)
    max_new_range: tuple = (16, 48)
    fail_at: dict = field(default_factory=dict)
    glb_period: int = 4
    policy: str = "proportional"
    balance: bool = True
    heartbeat_timeout: int = 2
    page_tokens: int = 16
    admission: str = "traffic"
    pipeline_depth: int = 1      # 2 = double-buffered migration windows
    transport: object = None     # relocation data plane ("host"/"device")
    seed: int = 0
    device: object = None        # the replicas' device (None: the card)

    def __post_init__(self):
        period = self.glb_period if self.balance else 10 ** 9
        self.driver = ElasticServingDriver(
            self.n_replicas, slots_per_replica=self.slots,
            glb=GLBConfig(period=period, policy=self.policy, ema=0.3,
                          asynchronous=True,
                          pipeline_depth=self.pipeline_depth),
            heartbeat_timeout=self.heartbeat_timeout,
            page_tokens=self.page_tokens, admission=self.admission,
            transport=self.transport, device=self.device)
        if not self.speeds:
            self.speeds = (1.0,) * self.n_replicas
        self.rng = np.random.default_rng(self.seed)
        self.failed: set[int] = set()
        self.step_times: list[float] = []
        self.iter = 0

    def _decode_time(self, p: int) -> float:
        pages = self.driver.workload.pages_of(p)
        noise = 1.0 + 0.02 * self.rng.standard_normal()
        return (self.base_us + self.per_page_us * pages) \
            / self.speeds[p] * max(noise, 0.5)

    def run(self, steps: int) -> "ServingSim":
        d = self.driver
        for _ in range(steps):
            if self.iter in self.fail_at:
                self.failed.add(self.fail_at[self.iter])
            for _ in range(self.rng.poisson(self.arrival_rate)):
                d.admit(int(self.rng.integers(*self.prompt_range)),
                        int(self.rng.integers(*self.max_new_range)))
            t = np.full(self.n_replicas, np.nan)
            for p in d.group.members:
                if p not in self.failed:
                    t[p] = self._decode_time(p)
            # lockstep batch: the slowest live replica sets the pace
            self.step_times.append(float(np.nanmax(t)))
            d.step(t, failed=self.failed)
            self.iter += 1
        d.sync()
        return self

    # -- window statistics (windows = GLB periods) -------------------------
    def window_p95(self) -> list[float]:
        return window_p95(self.step_times, self.glb_period)
