"""repro_torch.core — the CRCH pipeline pieces the serve path runs.

features -> PCA (:mod:`.pca`) -> triplet clustering on the pairwise-distance
kernel -> replication counts (:mod:`.clustering`).  The workflow planner
(HEFT, runtime simulation, baselines) waits for a later slice.
"""
from .clustering import (ClusteringResult, pairwise_distances,
                         replication_counts, triplet_agglomerate)
from .pca import PCAResult, fit_pca, project

__all__ = ["ClusteringResult", "PCAResult", "fit_pca", "pairwise_distances",
           "project", "replication_counts", "triplet_agglomerate"]
