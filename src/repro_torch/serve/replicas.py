"""Replica pool + CRCH-learned per-class hedging budgets (Algorithm 1 online).

``crch_policy`` runs the paper's unsupervised pipeline — request features ->
PCA with coverage-of-variance stop -> triplet agglomerative clustering ->
size-ranked replication counts — over a sample of requests (historical or
the admitted workload) and reduces the per-request counts to a per-
:class:`~repro.serve.queue.RequestClass` budget.  The largest cluster
("ordinary" short requests) gets one copy; outlier clusters (long-decode,
high-exposure requests that are the most likely to be struck by a failure
mid-generation) get hedged with additional replicas on distinct workers.

``WorkerPool`` models the accelerator replicas behind the engine: each
worker owns a contiguous span of decode slots and fails/repairs according to
a :class:`repro.ft.coordinator.FaultInjector` (Weibull MTBF / log-normal
MTTR, the paper's Section 4.1 distributions, in decode-step units).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.clustering import (replication_counts,
                                        triplet_agglomerate)
from repro_torch.core.pca import fit_pca
from repro_torch.ft.coordinator import FaultInjector

from .queue import Request, RequestClass, request_class, request_features

__all__ = [
    "ReplicaPolicy",
    "uniform_policy",
    "crch_policy",
    "SERVE_ENVIRONMENTS",
    "WorkerPool",
]


@dataclasses.dataclass
class ReplicaPolicy:
    """Maps a request to its replication count (total copies to run)."""

    name: str
    by_class: dict[RequestClass, int]
    default: int = 1
    max_rep: int = 4

    def rep_for(self, req: Request) -> int:
        r = self.by_class.get(request_class(req), self.default)
        return int(np.clip(r, 1, self.max_rep))


def uniform_policy(r: int, name: str | None = None) -> ReplicaPolicy:
    """``r=1``: no replication; ``r=k``: Replicate-All(k)."""
    name = name or ("none" if r == 1 else f"all-{r}")
    return ReplicaPolicy(name=name, by_class={}, default=r,
                         max_rep=max(r, 1))


def crch_policy(sample: list[Request], *, cov_threshold: float = 0.35,
                max_rep: int = 3, R: int = 3, lam: float = 0.5,
                device="cuda") -> ReplicaPolicy:
    """Learn per-class replication from a request sample, unsupervised.

    Identical machinery to ``repro.core.crch.plan`` steps 1-4, with request
    features in place of DAG-task features.  The per-request counts are
    reduced per class with ``max`` — the hedging budget must cover the
    class's worst member.  PCA and the pairwise-distance kernel run on
    ``device``; the merges run on the host in float64.
    """
    if not sample:
        return uniform_policy(1, name="crch")
    feats = request_features(sample)
    pca = fit_pca(feats, cov_threshold, device=device)
    clustering = triplet_agglomerate(
        pca.projected, n_clusters=max_rep, R=R, lam=lam, device=device)
    counts = replication_counts(
        clustering, priorities=feats[:, 3], exec_times=feats[:, 2])
    by_class: dict[RequestClass, int] = {}
    for req, c in zip(sample, counts):
        cls = request_class(req)
        by_class[cls] = max(by_class.get(cls, 1), int(c))
    return ReplicaPolicy(name="crch", by_class=by_class, default=1,
                         max_rep=max_rep)


# Failure environments in decode-step units, mirroring the shape of
# repro.core.failures.ENVIRONMENTS (stable/normal/unstable = rare /
# occasional / frequent failures, repairs slower as stability drops).
SERVE_ENVIRONMENTS: dict[str, dict] = {
    "stable": {"mtbf_steps": 800.0, "mttr_steps": 8, "shape": 12.5},
    "normal": {"mtbf_steps": 200.0, "mttr_steps": 16, "shape": 12.0},
    "unstable": {"mtbf_steps": 60.0, "mttr_steps": 24, "shape": 11.5},
}


@dataclasses.dataclass
class _Worker:
    wid: int
    down_until: int = 0         # engine step at which the worker is back up
    slow_until: int = 0         # straggling until this step (state intact)

    def is_up(self, step: int) -> bool:
        return step >= self.down_until

    def is_slow(self, step: int) -> bool:
        return step < self.slow_until


class WorkerPool:
    """``n_workers`` simulated accelerator replicas x ``slots_per_worker``
    decode slots each.  Failures take the whole worker down (all its slots
    die simultaneously) for ``mttr_steps``."""

    def __init__(self, n_workers: int, slots_per_worker: int, *,
                 environment: str | None = None, mtbf_steps: float = 0.0,
                 mttr_steps: int = 8, shape: float = 12.0, seed: int = 0,
                 horizon_steps: int = 100_000):
        if environment is not None:
            env = SERVE_ENVIRONMENTS[environment]
            mtbf_steps = env["mtbf_steps"]
            mttr_steps = env["mttr_steps"]
            shape = env["shape"]
        self.n_workers = n_workers
        self.slots_per_worker = slots_per_worker
        self.mttr_steps = int(mttr_steps)
        self.workers = [_Worker(w) for w in range(n_workers)]
        self.injectors: list[FaultInjector | None] = []
        for w in range(n_workers):
            if mtbf_steps and mtbf_steps > 0:
                self.injectors.append(FaultInjector(
                    mtbf_steps=mtbf_steps, shape=shape,
                    mttr_steps=mttr_steps, seed=seed * 1009 + w,
                    horizon_steps=horizon_steps))
            else:
                self.injectors.append(None)
        self.forced_failures: dict[int, list[int]] = {}
        # step -> [(wid, outage duration)] for chaos capacity-loss events
        self.forced_outages: dict[int, list[tuple[int, int]]] = {}

    @property
    def n_slots(self) -> int:
        return self.n_workers * self.slots_per_worker

    def worker_of(self, slot: int) -> int:
        return slot // self.slots_per_worker

    def slots_of(self, wid: int) -> range:
        return range(wid * self.slots_per_worker,
                     (wid + 1) * self.slots_per_worker)

    def is_up(self, wid: int, step: int) -> bool:
        return self.workers[wid].is_up(step)

    def is_slow(self, wid: int, step: int) -> bool:
        return self.workers[wid].is_slow(step)

    def n_up(self, step: int) -> int:
        return sum(w.is_up(step) for w in self.workers)

    def force_failure(self, step: int, wid: int) -> None:
        """Deterministically kill ``wid`` at ``step`` (tests/demos)."""
        self.forced_failures.setdefault(step, []).append(wid)

    def force_outage(self, step: int, wids, duration: int) -> None:
        """Capacity loss: take ``wids`` down at ``step`` for ``duration``
        steps (a chaos ``capacity_loss`` MTTR window)."""
        self.forced_outages.setdefault(step, []).extend(
            (int(w), int(duration)) for w in wids)

    def slow(self, wid: int, until_step: int) -> None:
        """Straggler: ``wid`` stalls (no decode progress, no state loss)
        until ``until_step``."""
        w = self.workers[wid]
        w.slow_until = max(w.slow_until, int(until_step))

    def step_failures(self, step: int) -> list[int]:
        """Workers that fail at ``step``; marks them down for MTTR steps.

        A sampled failure landing while its worker is already down (mid-MTTR)
        is *deferred* to the repair step via :meth:`FaultInjector.defer`
        rather than silently dropped — the fault strikes again the moment the
        worker comes back up.
        """
        failed = []
        outages = dict(self.forced_outages.get(step, ()))
        for w in self.workers:
            inj = self.injectors[w.wid]
            hit = w.wid in self.forced_failures.get(step, ())
            dur = self.mttr_steps
            if w.wid in outages:   # capacity loss carries its own window
                hit = True
                dur = max(dur, outages[w.wid])
            if inj is not None:
                if w.is_up(step):
                    hit = inj.consume(step) or hit
                else:
                    inj.defer(step, w.down_until)
            if hit and w.is_up(step):
                w.down_until = step + dur
                failed.append(w.wid)
        return failed
