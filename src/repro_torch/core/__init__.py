"""repro_torch.core — the CRCH pipeline, the paper's contribution.

Pipeline (paper Fig. 1), as in ``repro.core``:
  features -> PCA (:mod:`.pca`) -> triplet clustering on the
  pairwise-distance kernel -> replication counts (Algorithm 1,
  :mod:`.clustering`) -> over-provisioned HEFT (Algorithm 2, :mod:`.heft`)
  -> CheckpointHEFT runtime (Algorithm 3, :mod:`.runtime`) with the
  Lemma-3.1 dynamic checkpoint interval (:mod:`.checkpoint_policy`).

PCA and the distance matrix run on the device :func:`plan` is given (the
GPU by default); everything else is host numpy copied from the JAX package.
The serve path (``repro_torch.serve.replicas``) uses the first half.
"""
from .workflow import Task, Workflow, CloudEnvironment, generate_workflow, WORKFLOW_TYPES
from .failures import Environment, ENVIRONMENTS, FailureTrace, sample_failure_trace
from .features import task_features, FEATURE_NAMES, b_levels, t_levels
from .pca import PCAResult, fit_pca, project
from .clustering import (ClusteringResult, pairwise_distances,
                         replication_counts, triplet_agglomerate)
from .heft import Placement, Schedule, heft_schedule
from .runtime import CkptLevel, SimConfig, SimResult, simulate
from .crch import CRCHConfig, CRCHPlan, plan, run, sim_config
from .metrics import RunMetrics, metrics_from_result, aggregate
from .mlp_classifier import MLPConfig, ReplicationMLP
from .resubmission_impact import resubmission_impact_counts
from .dax import load_dax, parse_dax
from . import baselines, checkpoint_policy

__all__ = [
    "Task", "Workflow", "CloudEnvironment", "generate_workflow", "WORKFLOW_TYPES",
    "Environment", "ENVIRONMENTS", "FailureTrace", "sample_failure_trace",
    "task_features", "FEATURE_NAMES", "b_levels", "t_levels",
    "PCAResult", "fit_pca", "project",
    "ClusteringResult", "pairwise_distances", "triplet_agglomerate",
    "replication_counts",
    "Placement", "Schedule", "heft_schedule",
    "CkptLevel", "SimConfig", "SimResult", "simulate",
    "CRCHConfig", "CRCHPlan", "plan", "run", "sim_config",
    "RunMetrics", "metrics_from_result", "aggregate",
    "MLPConfig", "ReplicationMLP", "resubmission_impact_counts",
    "load_dax", "parse_dax",
    "baselines", "checkpoint_policy",
]
