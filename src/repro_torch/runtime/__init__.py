"""Runtime of the port: the in-process fault-tolerance pieces the
elastic serving driver needs."""
from .fault_tolerance import ElasticWorld, HeartbeatMonitor, rehome_dead_place

__all__ = ["ElasticWorld", "HeartbeatMonitor", "rehome_dead_place"]
