"""Resubmission Impact (RI) heuristic — Plankensteiner et al. [7].

The baseline the paper's clustering module replaces: for each task, build a
variant workflow in which that task's runtime is doubled (simulating one
resubmission), recompute the HEFT makespan, and normalize the makespan
deltas into scores; tasks with high impact (critical-path-ish) get high
replication counts.  This is the "combinatorial" approach the paper calls
slow: it costs one HEFT schedule per task (O(n) HEFTs ~ O(n^3 v)) versus
CRCH's single clustering pass -- reproduced as a baseline and timed in
tests/benchmarks.

A copy of ``repro.core.resubmission_impact``, line for line (the port imports nothing of
the JAX package); the tests hold the two equal.
"""
from __future__ import annotations

import numpy as np

from .heft import heft_schedule
from .workflow import CloudEnvironment, Workflow

__all__ = ["resubmission_impact_counts"]


def resubmission_impact_counts(wf: Workflow, env: CloudEnvironment, *,
                               max_rep: int = 4,
                               resub_factor: float = 2.0) -> np.ndarray:
    """Replication counts in [1, max_rep] from normalized RI scores."""
    base = heft_schedule(wf, env, 1).makespan
    impact = np.zeros(wf.n_tasks)
    saved = env.time_on_vm
    for t in range(wf.n_tasks):
        env.time_on_vm = saved.copy()
        env.time_on_vm[t] *= resub_factor
        impact[t] = heft_schedule(wf, env, 1).makespan - base
    env.time_on_vm = saved
    impact = np.maximum(impact, 0.0)
    hi = impact.max()
    if hi <= 1e-12:
        return np.ones(wf.n_tasks, dtype=np.int64)
    score = impact / hi                       # normalized RI in [0, 1]
    counts = 1 + np.floor(score * (max_rep - 1 + 1e-9)).astype(np.int64)
    return np.clip(counts, 1, max_rep)
