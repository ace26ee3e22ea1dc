"""Triplet-loss agglomerative clustering -> replication counts.

Implements Algorithm 1 (steps 11-19) with the affinity of Eq. (5) (average
linkage over point pairs) and the triplet merge loss of Eq. (6):

    loss(C_i, C_j) = D_ij + lambda/(R-1) * sum_{k in eta(C_i, R), k != j} (D_ij - D_ik)

i.e. merge the pair that is mutually close *and* clearly closer than C_i's
other R-1 nearest superclusters -- preventing collapse into one giant or many
singleton clusters (paper Fig. 2/3).

The O(N^2) pairwise point-distance matrix is the compute hot spot; it is
computed by ``repro_torch.kernels.pairwise_affinity`` on the points'
device: the CUDA kernel on a GPU, its plain version on the CPU.  The merges
run on the host in float64, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.pairwise_affinity import ops as pa_ops

__all__ = [
    "pairwise_distances",
    "ClusteringResult",
    "triplet_agglomerate",
    "replication_counts",
]


def pairwise_distances(points) -> np.ndarray:
    """(N, N) Euclidean distance matrix between task embeddings.

    ``points`` is a tensor (the kernel runs on its device) or an array (the
    CPU); the fp32 result comes back as numpy."""
    pts = torch.as_tensor(points)
    return pa_ops.pairwise_distance(pts).cpu().numpy()


@dataclasses.dataclass
class ClusteringResult:
    labels: np.ndarray                 # (N,) cluster index per point
    cluster_sizes: list[int]
    merge_history: list[tuple[int, int, float]]  # (a, b, distance at merge)
    min_intercluster_distance: float


def _cluster_loss_matrix(D: np.ndarray, R: int, lam: float) -> np.ndarray:
    """Ordered-pair triplet losses L[i, j] per Eq. (6)."""
    C = D.shape[0]
    big = np.inf
    Dm = D.copy()
    np.fill_diagonal(Dm, big)
    R_eff = min(R, C - 1)
    # eta(C_i, R): distances to the R nearest neighbours of each cluster
    neigh = np.sort(Dm, axis=1)[:, :R_eff]            # (C, R_eff)
    neigh_sum = neigh.sum(axis=1, keepdims=True)      # (C, 1)
    if R_eff <= 1:
        return Dm
    # For j in eta(i): sum over k != j of (D_ij - D_ik)
    #   = (R_eff - 1) * D_ij - (neigh_sum_i - D_ij)   when j is a neighbour.
    # For j outside eta(i) the merge is never selected anyway (some neighbour
    # has strictly smaller D); using the same formula keeps it vectorized.
    sum_term = (R_eff - 1) * Dm - (neigh_sum - Dm)
    L = Dm + lam / (R_eff - 1) * sum_term
    np.fill_diagonal(L, big)
    return L


def triplet_agglomerate(points: np.ndarray, *, n_clusters: int = 4,
                        R: int = 3, lam: float = 0.5,
                        dendro_threshold: float | None = None,
                        device="cuda") -> ClusteringResult:
    """Agglomerate N points down to ``n_clusters`` superclusters; the
    distance matrix is computed on ``device``."""
    points = np.asarray(points, dtype=np.float64)
    N = points.shape[0]
    n_clusters = max(1, min(n_clusters, N))
    P = pairwise_distances(torch.as_tensor(points, dtype=torch.float32,
                                           device=device))

    members: list[list[int]] = [[i] for i in range(N)]
    # pair-sum matrix S[a, b] = sum of point distances between clusters a, b
    S = P.astype(np.float64).copy()
    sizes = np.ones(N)
    alive = np.ones(N, dtype=bool)
    history: list[tuple[int, int, float]] = []

    def dist_matrix() -> np.ndarray:
        idx = np.where(alive)[0]
        sub = S[np.ix_(idx, idx)] / np.outer(sizes[idx], sizes[idx])
        return idx, sub

    while int(alive.sum()) > n_clusters:
        idx, D = dist_matrix()
        Dm = D.copy()
        np.fill_diagonal(Dm, np.inf)
        dmin = float(Dm.min())
        if dendro_threshold is not None and dmin > dendro_threshold:
            break  # dendrogram cut: branches now further apart than threshold
        L = _cluster_loss_matrix(D, R, lam)
        i, j = np.unravel_index(np.argmin(L), L.shape)
        a, b = int(idx[i]), int(idx[j])
        history.append((a, b, float(D[i, j])))
        # merge b into a
        members[a].extend(members[b])
        S[a, :] += S[b, :]
        S[:, a] += S[:, b]
        S[a, a] = 0.0
        sizes[a] += sizes[b]
        alive[b] = False

    idx, D = dist_matrix()
    Dm = D.copy()
    np.fill_diagonal(Dm, np.inf)
    labels = np.empty(N, dtype=np.int64)
    final_members = [members[a] for a in idx]
    for c, mem in enumerate(final_members):
        labels[mem] = c
    return ClusteringResult(
        labels=labels,
        cluster_sizes=[len(m) for m in final_members],
        merge_history=history,
        min_intercluster_distance=float(Dm.min()) if Dm.size > 1 else 0.0,
    )


def replication_counts(result: ClusteringResult, *,
                       rule_guard: bool = False,
                       priorities: np.ndarray | None = None,
                       exec_times: np.ndarray | None = None) -> np.ndarray:
    """Algorithm 1 steps 17-19: sort superclusters by size (descending);
    tasks in the i-th largest cluster get ``repCount = i`` total copies.

    The largest cluster (common, "ordinary" tasks) gets 1 copy (no replicas);
    the smallest (outliers: critical / long-running / high-priority tasks)
    gets the max count.  ``rule_guard`` applies the paper's rule-ensemble
    remark: a low-priority, short task that lands in an outlier cluster is
    capped at 2 copies.
    """
    order = np.argsort(-np.asarray(result.cluster_sizes), kind="stable")
    rank_of_cluster = np.empty(len(order), dtype=np.int64)
    rank_of_cluster[order] = np.arange(1, len(order) + 1)
    counts = rank_of_cluster[result.labels]
    if rule_guard and priorities is not None and exec_times is not None:
        pr = np.asarray(priorities)
        ex = np.asarray(exec_times)
        lowly = (pr <= np.median(pr)) & (ex <= np.median(ex))
        counts = np.where(lowly, np.minimum(counts, 2), counts)
    return counts.astype(np.int64)
