"""repro_torch.ft — checkpointing, failure sampling, the dynamic interval,
the fault-tolerant training coordinator, straggler replication and the
partition-tolerant cross-pod cluster (counterpart of ``repro.ft``)."""
from .checkpoint import CheckpointStore
from .coordinator import CoordinatorReport, FaultInjector, TrainingCoordinator
from .crosspod import (ClusterReport, ExchangeResult, PodGradientExchange,
                       PodTrainingCluster, tree_digest, tree_digests)
from .interval import DynamicInterval
from .straggler import HostTelemetry, ReplicationPlanner

__all__ = ["CheckpointStore", "ClusterReport", "CoordinatorReport",
           "DynamicInterval", "ExchangeResult", "FaultInjector",
           "HostTelemetry", "PodGradientExchange", "PodTrainingCluster",
           "ReplicationPlanner", "TrainingCoordinator", "tree_digest",
           "tree_digests"]
