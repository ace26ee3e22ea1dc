"""Baselines the paper compares against: plain HEFT, ReplicateAll(k), SCR.

* HEFT [13]: no replicas, no checkpointing, no resubmission -> any VM failure
  that hits a task kills the workflow.
* ReplicateAll(k) [11]: every task gets k extra replicas (paper uses k=3, so
  4 executions per task), no resubmission, no checkpointing, no dynamic
  skip-on-success -- replicas always execute (paper Section 4.2).
* SCR [17]: multi-level checkpoint/restart -- frequent cheap local
  checkpoints (non-portable) + infrequent expensive Parallel-File-System
  backups (portable).  Compared against CRCH's light-weight single-level
  pointer checkpoints in Fig. 7a (both with no replicas).

A copy of ``repro.core.baselines``, line for line (the port imports nothing of
the JAX package); the tests hold the two equal.
"""
from __future__ import annotations

import numpy as np

from .failures import FailureTrace
from .heft import Schedule, heft_schedule
from .runtime import CkptLevel, SimConfig, SimResult, simulate
from .workflow import CloudEnvironment, Workflow

__all__ = [
    "heft_plan", "heft_sim_config",
    "replicate_all_plan", "replicate_all_sim_config",
    "scr_sim_config", "crch_ckpt_only_sim_config",
]


def heft_plan(wf: Workflow, env: CloudEnvironment) -> Schedule:
    return heft_schedule(wf, env, 1)


def heft_sim_config() -> SimConfig:
    return SimConfig(ckpt_levels=(), resubmit=False, skip_when_complete=True,
                     busy_terminate=False)


def replicate_all_plan(wf: Workflow, env: CloudEnvironment,
                       k: int = 3) -> Schedule:
    return heft_schedule(wf, env, k + 1)


def replicate_all_sim_config() -> SimConfig:
    # the static schedule is executed as-is: every copy runs (no dynamic
    # skip, no resubmission, no checkpointing); wastage = replica seconds
    # executed after the first copy succeeded (paper Section 4.2)
    return SimConfig(ckpt_levels=(), resubmit=False, skip_when_complete=False,
                     busy_terminate=False)


def scr_sim_config(*, local_lambda: float = 30.0, local_gamma: float = 1.5,
                   pfs_lambda: float = 300.0, pfs_gamma: float = 20.0,
                   restore_cost: float = 15.0) -> SimConfig:
    """SCR-style two-level checkpointing, no replicas (Fig. 7a setting)."""
    return SimConfig(
        ckpt_levels=(CkptLevel(local_lambda, local_gamma, portable=False),
                     CkptLevel(pfs_lambda, pfs_gamma, portable=True)),
        resubmit=True, skip_when_complete=True, busy_terminate=False,
        restore_cost=restore_cost,
    )


def crch_ckpt_only_sim_config(*, lam: float = 30.0,
                              gamma: float = 1.5) -> SimConfig:
    """CRCH checkpointing with no replicas (Fig. 7 setting): light-weight
    local checkpoints whose *data* pointers live in global memory, so the
    restore itself is cheap, but program state is not portable."""
    return SimConfig(
        ckpt_levels=(CkptLevel(lam, gamma, portable=False),),
        resubmit=True, skip_when_complete=True, busy_terminate=False,
    )
