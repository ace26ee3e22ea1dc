"""Straggler mitigation via the paper's replication heuristics.

Counterpart of ``repro.ft.straggler`` over the port's ``core.pca`` and
``core.clustering``: PCA and the pairwise-distance kernel run on
``device`` (the card unless the caller asks for the CPU).

The CRCH clustering module (features -> PCA -> triplet agglomeration ->
size-ranked replication counts) is applied to *host telemetry* instead of
workflow tasks: healthy hosts form the big supercluster (1 copy of their
data shard); outlier hosts -- slow, flaky, or hot -- land in small clusters
and their shards get standby replicas on healthy hosts.  Because the data
pipeline is deterministic (``repro_torch.data``), a replica shard is
recomputable anywhere and "first finish wins" needs no result reconciliation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.clustering import replication_counts, triplet_agglomerate
from ..core.pca import fit_pca

__all__ = ["HostTelemetry", "ReplicationPlanner"]

TELEMETRY_FEATURES = (
    "mean_step_s", "p95_step_s", "failure_count", "restarts",
    "net_mbps", "mem_pressure", "ecc_errors", "thermal_throttle_s",
)


@dataclasses.dataclass
class HostTelemetry:
    host: int
    mean_step_s: float
    p95_step_s: float
    failure_count: float = 0.0
    restarts: float = 0.0
    net_mbps: float = 0.0
    mem_pressure: float = 0.0
    ecc_errors: float = 0.0
    thermal_throttle_s: float = 0.0

    def vector(self) -> np.ndarray:
        return np.array([getattr(self, f) for f in TELEMETRY_FEATURES])


@dataclasses.dataclass
class ReplicationPlan:
    counts: np.ndarray                  # copies per host's shard
    assignments: dict[int, list[int]]   # shard -> executing hosts
    healthy_hosts: list[int]


class ReplicationPlanner:
    """Unsupervised replication-count learning over host telemetry."""

    def __init__(self, *, cov_threshold: float = 0.35, max_rep: int = 3,
                 R: int = 3, lam: float = 0.5, device: str = "cuda"):
        self.cov_threshold = cov_threshold
        self.max_rep = max_rep
        self.R = R
        self.lam = lam
        self.device = device

    def plan(self, telemetry: list[HostTelemetry]) -> ReplicationPlan:
        feats = np.stack([t.vector() for t in telemetry])
        n = feats.shape[0]
        pca = fit_pca(feats, self.cov_threshold, device=self.device)
        clustering = triplet_agglomerate(
            pca.projected, n_clusters=min(self.max_rep, n),
            R=self.R, lam=self.lam, device=self.device)
        counts = replication_counts(clustering)
        # hosts in the dominant cluster are the healthy replica targets
        order = np.argsort(-np.asarray(clustering.cluster_sizes))
        healthy = [t.host for t, c in zip(telemetry, clustering.labels)
                   if c == order[0]]
        assignments: dict[int, list[int]] = {}
        rr = 0
        for i, t in enumerate(telemetry):
            hosts = [t.host]
            for _ in range(int(counts[i]) - 1):
                if not healthy:
                    break
                cand = healthy[rr % len(healthy)]
                rr += 1
                if cand not in hosts:
                    hosts.append(cand)
            assignments[i] = hosts
        return ReplicationPlan(counts=counts, assignments=assignments,
                               healthy_hosts=healthy)
