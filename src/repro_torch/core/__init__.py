"""Relocatable distributed collections in PyTorch — the port of
``repro.core`` (Finnerty, Kamada, Kawanishi, Ohta: "Supercharging the
APGAS Programming Model with Relocatable Distributed Collections",
2022) to CUDA devices.

Exports the same names ``repro.core`` exports for the modules ported so
far: distribution, collections, relocation, transport, teamed
operations, the balancer, the GLB and its device steal loop, and
telemetry.
"""
from . import telemetry
from .balancer import BalanceDecision, LevelExtremes, LoadBalancer, Proportional
from .collections import (
    CachableArray,
    CachableChunkedList,
    DistArray,
    DistBag,
    DistIdMap,
    DistMap,
    DistMultiMap,
    PlaceGroup,
)
from .distribution import DistributionDelta, LongRange, RangeDistribution
from .glb import (
    ClusterSim,
    DistArrayWorkload,
    GLBConfig,
    GLBStats,
    GlobalLoadBalancer,
    ListWorkload,
    MultiCollectionWorkload,
    hypercube_lifelines,
    moves_to_matrix,
    ring_lifelines,
    spmd_rebalance,
)
from .relocation import (
    AsyncRelocation,
    CollectiveMoveManager,
    spmd_counts,
    spmd_relocate,
    spmd_relocate_back,
)
from .spmd_glb import (
    run_device_steal,
    spmd_steal_loop,
    spmd_steal_plan,
    spmd_steal_step,
    steal_candidates,
)
from .teamed import (
    Reducer,
    allgather1,
    local_reduce,
    spmd_allgather1,
    spmd_team_reduce,
    team_reduce,
)
from .telemetry import MetricsRegistry, Tracer
from .transport import (
    DeviceTransport,
    HostTransport,
    RelocationTransport,
    TransportStats,
    make_transport,
)

__all__ = [
    "BalanceDecision", "LevelExtremes", "LoadBalancer", "Proportional",
    "CachableArray", "CachableChunkedList", "DistArray", "DistBag",
    "DistIdMap", "DistMap", "DistMultiMap", "PlaceGroup",
    "DistributionDelta", "LongRange", "RangeDistribution",
    "ClusterSim", "DistArrayWorkload", "GLBConfig", "GLBStats",
    "GlobalLoadBalancer", "ListWorkload", "MultiCollectionWorkload",
    "hypercube_lifelines",
    "moves_to_matrix", "ring_lifelines", "spmd_rebalance",
    "AsyncRelocation", "CollectiveMoveManager", "spmd_counts",
    "spmd_relocate", "spmd_relocate_back",
    "run_device_steal", "spmd_steal_loop", "spmd_steal_plan",
    "spmd_steal_step", "steal_candidates",
    "Reducer", "allgather1", "local_reduce", "spmd_allgather1",
    "spmd_team_reduce", "team_reduce",
    "telemetry", "MetricsRegistry", "Tracer",
    "DeviceTransport", "HostTransport", "RelocationTransport",
    "TransportStats", "make_transport",
]
