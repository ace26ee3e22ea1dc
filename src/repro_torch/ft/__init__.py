"""repro_torch.ft — checkpointing, failure sampling, the dynamic interval,
the fault-tolerant training coordinator and straggler replication.

Mirrors ``repro.ft`` without the cross-pod exchange (``crosspod``), which
waits for the port's multi-pod slice."""
from .checkpoint import CheckpointStore
from .coordinator import CoordinatorReport, FaultInjector, TrainingCoordinator
from .interval import DynamicInterval
from .straggler import HostTelemetry, ReplicationPlanner

__all__ = ["CheckpointStore", "CoordinatorReport", "DynamicInterval",
           "FaultInjector", "HostTelemetry", "ReplicationPlanner",
           "TrainingCoordinator"]
