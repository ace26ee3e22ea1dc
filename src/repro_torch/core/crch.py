"""CRCH: Checkpointing and Replication based on Clustering Heuristics.

The end-to-end pipeline of paper Fig. 1: features -> PCA -> triplet
clustering -> replication counts (Algorithm 1) -> over-provisioned HEFT
(Algorithm 2) -> CheckpointHEFT runtime (Algorithm 3).

Counterpart of ``repro.core.crch``.  PCA and the point-distance matrix run
on ``device`` (default ``cuda``: the SVD in fp32 and the pairwise-distance
kernel; on the CPU their plain versions); the merges, HEFT, the Lemma-3.1
interval and the simulation run on the host in float64 numpy, as in the
JAX package.  ``plan`` records each phase's host time in
``CRCHPlan.timing``; the device phases end in a copy to numpy, which waits
for the device.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import checkpoint_policy
from .clustering import ClusteringResult, replication_counts, triplet_agglomerate
from .failures import ENVIRONMENTS, FailureTrace
from .features import task_features
from .heft import Schedule, heft_schedule
from .pca import PCAResult, fit_pca
from .runtime import CkptLevel, SimConfig, SimResult, simulate
from .workflow import CloudEnvironment, Workflow

__all__ = ["CRCHConfig", "CRCHPlan", "plan", "run", "sim_config"]


@dataclasses.dataclass
class CRCHConfig:
    """The paper's parameters, as in ``repro.core.crch.CRCHConfig``.

    The JAX package's ``backend`` ("jnp" or "pallas" distance matrix) has no
    counterpart: the device that ``plan`` is given picks the kernel (a GPU)
    or its plain version (the CPU)."""
    cov_threshold: float = 0.35      # PCA coverage-of-variance stop (Fig. 5 optimum)
    max_rep_count: int = 4           # number of superclusters K (Fig. 6)
    triplet_R: int = 3               # neighbourhood size in Eq. (6)
    triplet_lambda: float = 0.5      # triplet weight in Eq. (6)
    rule_guard: bool = False         # paper's rule-ensemble cap (off = faithful)
    ckpt_lambda: float | None = None  # None -> dynamic lambda* (Lemma 3.1)
    ckpt_gamma: float = 2.0          # per-checkpoint overhead (seconds)
    busy_terminate: bool = True
    backlog_tol: float = 120.0


@dataclasses.dataclass
class CRCHPlan:
    schedule: Schedule
    rep_counts: np.ndarray
    pca: PCAResult
    clustering: ClusteringResult
    ckpt_lambda: float
    # host seconds per phase: features, pca, distances (B1), merge, heft
    # (with the replication counts), lambda
    timing: dict[str, float] = dataclasses.field(default_factory=dict)


def plan(wf: Workflow, env: CloudEnvironment, cfg: CRCHConfig | None = None,
         *, environment: str = "normal", device="cuda") -> CRCHPlan:
    cfg = cfg or CRCHConfig()
    t = [time.perf_counter()]

    def lap():
        t.append(time.perf_counter())
        return t[-1] - t[-2]

    timing = {}
    feats = task_features(wf, env)
    timing["features"] = lap()
    pca = fit_pca(feats, cfg.cov_threshold, device=device)
    timing["pca"] = lap()
    clustering = triplet_agglomerate(
        pca.projected, n_clusters=cfg.max_rep_count,
        R=cfg.triplet_R, lam=cfg.triplet_lambda, device=device)
    lap()
    timing.update(clustering.timing)
    counts = replication_counts(
        clustering, rule_guard=cfg.rule_guard,
        priorities=feats[:, 2], exec_times=feats[:, 0])
    schedule = heft_schedule(wf, env, counts)
    timing["heft"] = lap()
    if cfg.ckpt_lambda is not None:
        lam = float(cfg.ckpt_lambda)
    else:
        # lambda* from the no-replica failure term: checkpoints exist for the
        # resubmission path, i.e. the event that all replicas already failed
        lam = checkpoint_policy.optimal_lambda(
            schedule, ENVIRONMENTS[environment], gamma=cfg.ckpt_gamma,
            rep_counts=None)
    timing["lambda"] = lap()
    return CRCHPlan(schedule=schedule, rep_counts=counts, pca=pca,
                    clustering=clustering, ckpt_lambda=lam, timing=timing)


def sim_config(plan_: CRCHPlan, cfg: CRCHConfig | None = None) -> SimConfig:
    cfg = cfg or CRCHConfig()
    return SimConfig(
        ckpt_levels=(CkptLevel(plan_.ckpt_lambda, cfg.ckpt_gamma,
                               portable=False),),
        resubmit=True,
        skip_when_complete=True,
        busy_terminate=cfg.busy_terminate,
        backlog_tol=cfg.backlog_tol,
    )


def run(wf: Workflow, env: CloudEnvironment, trace: FailureTrace,
        cfg: CRCHConfig | None = None, *, environment: str = "normal",
        device="cuda") -> tuple[SimResult, CRCHPlan]:
    cfg = cfg or CRCHConfig()
    plan_ = plan(wf, env, cfg, environment=environment, device=device)
    result = simulate(plan_.schedule, trace, sim_config(plan_, cfg))
    return result, plan_
