"""Elastic serving runtime of the port (traffic-keyed GLB +
failure-aware placement + the real decode data plane).

* ``cache``    — :class:`SeqKV`, :class:`Sequence`, :class:`ServingPool`.
* ``workload`` — :class:`TrafficWorkload`: the GLB ``Workload`` adapter
  keyed by decode-time EWMA × resident KV token budget.
* ``router``   — :class:`Router`: dispatch against the live tracked
  distribution, consistent across migrations and deaths.
* ``elastic``  — :class:`ElasticServingDriver` / :class:`ServingSim`.
* ``decode``   — :class:`DecodeEngine` / :class:`RealDecodeSim`: measured
  decode steps over device-resident :class:`SeqKV` tensors.
"""
from .cache import SeqKV, Sequence, ServingPool
from .decode import DecodeEngine, RealDecodeSim, serving_config
from .elastic import ElasticServingDriver, ServingSim
from .router import Router
from .workload import TokenCostModel, TrafficWorkload

__all__ = [
    "SeqKV", "Sequence", "ServingPool",
    "DecodeEngine", "RealDecodeSim", "serving_config",
    "ElasticServingDriver", "ServingSim",
    "Router",
    "TokenCostModel", "TrafficWorkload",
]
