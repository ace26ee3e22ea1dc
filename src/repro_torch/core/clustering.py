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

Two clusterings of the same points computed on two devices (or by two
implementations) see distances that differ within the kernel's tolerance,
and may break a near-tie the other way.  :func:`compare_merges` is the rule
that tells such a divergence from a fault.  It lives here, beside the loop
it replays, so that the card tests and ``chip_smoke.py`` (which import no
JAX) can apply it too.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..kernels.pairwise_affinity import ops as pa_ops

__all__ = [
    "pairwise_distances",
    "ClusteringResult",
    "triplet_agglomerate",
    "replication_counts",
    "MergeComparison",
    "compare_merges",
    "cancellation_bound",
    "distance_faults",
]


def pairwise_distances(points) -> np.ndarray:
    """(N, N) Euclidean distance matrix between task embeddings: the PCA
    projections of a workflow's tasks (the planner, ``crch.plan``) or of a
    request sample (the serve path, ``serve.replicas``).

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
    point_distances: np.ndarray        # (N, N) fp32 distances the merges read
    # host seconds of the distance matrix (its copy to numpy waits for the
    # device) and of the merge loop
    timing: dict[str, float] = dataclasses.field(default_factory=dict)


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


class _MergeState:
    """The merge loop's state: pair sums ``S[a, b]`` of point distances
    between clusters a and b, cluster sizes and members.  Merging b into a
    keeps index a; b goes dead."""

    def __init__(self, P: np.ndarray):
        N = P.shape[0]
        self.members: list[list[int]] = [[i] for i in range(N)]
        self.S = P.astype(np.float64).copy()
        self.sizes = np.ones(N)
        self.alive = np.ones(N, dtype=bool)

    def distances(self) -> tuple[np.ndarray, np.ndarray]:
        """Live cluster indices and their average-linkage distances."""
        idx = np.where(self.alive)[0]
        sub = self.S[np.ix_(idx, idx)] / np.outer(self.sizes[idx],
                                                  self.sizes[idx])
        return idx, sub

    def merge(self, a: int, b: int) -> None:
        self.members[a].extend(self.members[b])
        S = self.S
        S[a, :] += S[b, :]
        S[:, a] += S[:, b]
        S[a, a] = 0.0
        self.sizes[a] += self.sizes[b]
        self.alive[b] = False


def triplet_agglomerate(points: np.ndarray, *, n_clusters: int = 4,
                        R: int = 3, lam: float = 0.5,
                        dendro_threshold: float | None = None,
                        device="cuda") -> ClusteringResult:
    """Agglomerate N points down to ``n_clusters`` superclusters; the
    distance matrix is computed on ``device``.

    Each step merges the ordered pair (a, b) at the first minimum of the
    loss matrix (row-major), b into a.  The direction is part of the
    result: the surviving index a sets where the merged cluster sits in
    later steps' matrices, and so which pair a later exact tie picks.
    ``merge_history`` records it."""
    points = np.asarray(points, dtype=np.float64)
    N = points.shape[0]
    n_clusters = max(1, min(n_clusters, N))
    t0 = time.perf_counter()
    P = pairwise_distances(torch.as_tensor(points, dtype=torch.float32,
                                           device=device))
    t1 = time.perf_counter()
    state = _MergeState(P)
    history: list[tuple[int, int, float]] = []

    while int(state.alive.sum()) > n_clusters:
        idx, D = state.distances()
        Dm = D.copy()
        np.fill_diagonal(Dm, np.inf)
        dmin = float(Dm.min())
        if dendro_threshold is not None and dmin > dendro_threshold:
            break  # dendrogram cut: branches now further apart than threshold
        L = _cluster_loss_matrix(D, R, lam)
        i, j = np.unravel_index(np.argmin(L), L.shape)
        a, b = int(idx[i]), int(idx[j])
        history.append((a, b, float(D[i, j])))
        state.merge(a, b)

    idx, D = state.distances()
    Dm = D.copy()
    np.fill_diagonal(Dm, np.inf)
    labels = np.empty(N, dtype=np.int64)
    final_members = [state.members[a] for a in idx]
    for c, mem in enumerate(final_members):
        labels[mem] = c
    return ClusteringResult(
        labels=labels,
        cluster_sizes=[len(m) for m in final_members],
        merge_history=history,
        min_intercluster_distance=float(Dm.min()) if Dm.size > 1 else 0.0,
        point_distances=P,
        timing={"distances": t1 - t0, "merge": time.perf_counter() - t1},
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


# ---------------------------------------------------------------------------
# the near-tie rule
# ---------------------------------------------------------------------------

# the pairwise-distance kernel's limit against its plain version off the
# diagonal (tests/test_kernels.py, the card tests, chip_smoke.py)
PAIR_ATOL, PAIR_RTOL = 3e-3, 1e-3


def cancellation_bound(points_a: np.ndarray,
                       points_b: np.ndarray | None = None) -> np.ndarray:
    """(N, N) bound c_pq on the fp32 Gram expansion's error in a distance.

    With K features and unit roundoff u = eps/2, |x|^2, |y|^2 and <x, y>
    each carry at most K u of |x|^2 + |y|^2 and the two additions u each,
    so the computed d^2 is off by at most (K + 1) eps (|x|^2 + |y|^2), and
    since |sqrt(a + e) - sqrt(a)| <= sqrt(|e|) the distance by at most
    c_pq = sqrt(max(K + 1, 4) eps (|x_p|^2 + |x_q|^2)).  At p = q this is
    the diagonal rule sqrt(8 eps |x|^2) of the kernel checks, which holds
    for K <= 3 (the planner keeps K = 1 at its default threshold).  Given
    two sets of points, the larger norm of each point counts."""
    pts = np.abs(np.asarray(points_a, dtype=np.float64))
    if points_b is not None:
        pts = np.maximum(pts, np.abs(np.asarray(points_b, dtype=np.float64)))
    sq = (pts ** 2).sum(1)
    k = pts.shape[1]
    eps = float(np.finfo(np.float32).eps)
    return np.sqrt(max(k + 1, 4) * eps * (sq[:, None] + sq[None, :]))


def distance_faults(points: np.ndarray, got: np.ndarray,
                    want: np.ndarray, *, atol: float = PAIR_ATOL,
                    rtol: float = PAIR_RTOL) -> tuple[np.ndarray, int]:
    """Where two distance matrices of ``points`` (the kernel's and its
    plain version's) disagree beyond the kernel's limit; and how many pairs
    lie inside the cancellation bound.

    A pair whose fp64 distance is under c_pq (:func:`cancellation_bound`;
    the diagonal, and tasks that project to nearly the same point) is sqrt
    of cancellation noise on both sides: each side must be within c_pq of
    the fp64 distance.  Every other pair: |got - want| <= atol + rtol
    |want|."""
    x = np.asarray(points, dtype=np.float32).astype(np.float64)
    sq = (x * x).sum(1)
    exact = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * x @ x.T,
                               0.0))
    c = cancellation_bound(x)
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    close = exact < c
    far_bad = np.abs(got - want) > atol + rtol * np.abs(want)
    close_bad = (np.abs(got - exact) > c) | (np.abs(want - exact) > c)
    return np.where(close, close_bad, far_bad), int(close.sum())


@dataclasses.dataclass
class MergeComparison:
    """The near-tie rule's verdict on two merge histories.

    ``verdict``: "equal" (same merges), "reversed" (the first divergent
    merge joins the same pair the other way round), "near_tie" (each
    side's pick is within ``bound`` of the other side's minimum loss) or
    "diverged" (a fault).  ``excess`` is, on each side's own loss matrix at
    the first divergent step, the loss of the other side's pick less the
    minimum."""
    verdict: str
    step: int | None = None
    pairs: tuple = ()
    excess: tuple[float, float] = (0.0, 0.0)
    bound: float = 0.0

    @property
    def ok(self) -> bool:
        return self.verdict != "diverged"


def _loss_slack(D: np.ndarray, dD: np.ndarray, i: int, j: int, R: int,
                lam: float) -> float:
    """How far the loss L[i, j] of Eq. (6) (``_cluster_loss_matrix``) can
    move when every cluster distance D[i, k] may move by dD[i, k].

    L[i, j] = D_ij (1 + lam R'/(R'-1)) - lam/(R'-1) * n_i, n_i the sum of
    the R' smallest D[i, k]; n_i lies between the sums of the R' smallest
    D[i, k] - dD[i, k] and D[i, k] + dD[i, k].  With R' <= 1, L = D."""
    C = D.shape[0]
    R_eff = min(R, C - 1)
    if R_eff <= 1:
        return float(dD[i, j])
    row = np.delete(np.arange(C), i)
    d, e = D[i, row], dD[i, row]
    n = np.sort(d)[:R_eff].sum()
    n_lo = np.sort(d - e)[:R_eff].sum()
    n_hi = np.sort(d + e)[:R_eff].sum()
    w = 1.0 + lam * R_eff / (R_eff - 1)
    return float(w * dD[i, j] + lam / (R_eff - 1) * max(n_hi - n, n - n_lo))


def compare_merges(a: ClusteringResult, b: ClusteringResult,
                   points_a: np.ndarray, points_b: np.ndarray, *,
                   R: int = 3, lam: float = 0.5,
                   atol: float = PAIR_ATOL,
                   rtol: float = PAIR_RTOL) -> MergeComparison:
    """The near-tie rule: do two clusterings of the same tasks differ only
    where the distance kernel's tolerance lets them?

    ``a`` and ``b`` come from ``triplet_agglomerate`` with the same
    ``R``/``lam`` on ``points_a`` and ``points_b`` (the same tasks'
    projections, e.g. from two devices).  Equal histories are "equal".
    Otherwise, at the first divergent merge k (both sides made the same k
    merges before it), the rule passes when

    * the two picks are the same unordered pair ("reversed"), or
    * on each side's own loss matrix at step k, the loss of the other
      side's pick exceeds the minimum by no more than ``bound`` ("near_tie").

    ``bound`` follows from the limit the two point-distance matrices may
    differ by: per point pair delta_pq = max(atol + rtol d_pq, 2 c_pq)
    (the kernel's off-diagonal limit, ``d_pq`` the larger side's distance;
    or, for pairs inside the cancellation bound c_pq of
    :func:`cancellation_bound`, both sides within c_pq of the truth).  A
    cluster distance is a mean over member pairs, so it may move by the
    same mean of delta (pair sums merged as in the loop).  Through Eq. (6)
    the loss L[i, j] may then move by ``_loss_slack``; side A's pick is its
    minimum and side B's its own, so L_A(pick_B) - min L_A <= slack(pick_A)
    + slack(pick_B), and the same the other way round.  The histories'
    directions matter: a reversed merge passes here, but the clusterings
    that follow it are not compared."""
    ha = [tuple(m[:2]) for m in a.merge_history]
    hb = [tuple(m[:2]) for m in b.merge_history]
    if ha == hb:
        return MergeComparison("equal")
    k = next((t for t, (x, y) in enumerate(zip(ha, hb)) if x != y),
             min(len(ha), len(hb)))
    if k == min(len(ha), len(hb)):   # one history stops early
        return MergeComparison("diverged", k)
    pa, pb = ha[k], hb[k]
    if pa == pb[::-1]:
        return MergeComparison("reversed", k, (pa, pb))
    Pa = np.asarray(a.point_distances, dtype=np.float64)
    Pb = np.asarray(b.point_distances, dtype=np.float64)
    delta = np.maximum(atol + rtol * np.maximum(Pa, Pb),
                       2.0 * cancellation_bound(points_a, points_b))
    states = [_MergeState(Pa), _MergeState(Pb), _MergeState(delta)]
    for x, y in ha[:k]:
        for st in states:
            st.merge(x, y)
    idx, D_a = states[0].distances()
    _, D_b = states[1].distances()
    _, dD = states[2].distances()
    pos = {int(c): n for n, c in enumerate(idx)}
    ia, ja = pos[pa[0]], pos[pa[1]]
    ib, jb = pos[pb[0]], pos[pb[1]]
    excess = []
    for D, other in ((D_a, (ib, jb)), (D_b, (ia, ja))):
        L = _cluster_loss_matrix(D, R, lam)
        excess.append(float(L[other] - L.min()))
    # |L_A - L_B| <= slack at either pick (D_B lies within dD of D_A)
    bound = (_loss_slack(D_a, dD, ia, ja, R, lam)
             + _loss_slack(D_a, dD, ib, jb, R, lam))
    ok = max(excess) <= bound
    return MergeComparison("near_tie" if ok else "diverged", k, (pa, pb),
                           (excess[0], excess[1]), bound)
