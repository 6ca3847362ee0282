"""Runtime of the port: the in-process fault-tolerance pieces the
elastic serving driver needs, and the train loop's straggler
mitigation."""
from .fault_tolerance import (ElasticWorld, HeartbeatMonitor,
                              StragglerMitigator, rehome_dead_place)

__all__ = ["ElasticWorld", "HeartbeatMonitor", "StragglerMitigator",
           "rehome_dead_place"]
