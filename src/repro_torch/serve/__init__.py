"""repro_torch.serve — fault-tolerant continuous-batching inference service.

Counterpart of ``repro.serve`` on the port's PyTorch model (see that
package's docstring for the paper mapping):

``queue.py``     admission queue, request classes and features (copy);
``replicas.py``  ``crch_policy`` (features -> PCA -> triplet clustering on
                 the pairwise-distance kernel -> replication counts) and the
                 failing ``WorkerPool``;
``snapshot.py``  checksummed decode snapshots of one slot's cache row;
``engine.py``    the slot-based engine: prefill (bucket-padded for dense
                 prompts, exact-length for the recurrent families) on the
                 model's kernels, one batched decode per step,
                 resubmission from snapshots (Algorithm 3);
``reference.py`` the batch=1 greedy parity oracle;
``metrics.py``   usage / wastage / goodput counters (copy).
"""
from .engine import EngineConfig, ServeEngine, engine_supported
from .metrics import ServeMetrics, format_table
from .queue import (AdmissionQueue, Request, RequestClass, WorkItem,
                    prompt_bucket, request_class, request_features)
from .reference import greedy_decode, greedy_reference
from .replicas import (SERVE_ENVIRONMENTS, ReplicaPolicy, WorkerPool,
                       crch_policy, uniform_policy)
from .snapshot import DecodeSnapshot, SnapshotStore

__all__ = [
    "AdmissionQueue", "DecodeSnapshot", "EngineConfig", "Request",
    "RequestClass", "ReplicaPolicy", "SERVE_ENVIRONMENTS", "ServeEngine",
    "ServeMetrics", "SnapshotStore", "WorkItem", "WorkerPool", "crch_policy",
    "engine_supported", "format_table", "greedy_decode", "greedy_reference",
    "prompt_bucket", "request_class", "request_features", "uniform_policy",
]
