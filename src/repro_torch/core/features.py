"""Task feature embeddings (paper Section 3.1).

Each task becomes a point in a 10-dimensional space.  The paper lists five
example features (w_t, e(t), priority, #parents, #children) and states the
analysis uses ten dimensions; we add five structural/criticality features in
the same spirit (B-level, T-level, output volume, depth, #descendants).

A copy of ``repro.core.features``, line for line (the port imports nothing of
the JAX package); the tests hold the two equal.
"""
from __future__ import annotations

import numpy as np

from .workflow import CloudEnvironment, Workflow

__all__ = ["task_features", "FEATURE_NAMES", "b_levels", "t_levels"]

FEATURE_NAMES = (
    "avg_exec_time",        # Eq. (1)
    "max_parent_transfer",  # Eq. (2) maxed over parents
    "priority",
    "n_parents",
    "n_children",
    "b_level",
    "t_level",
    "output_data_mb",
    "depth",
    "n_descendants",
)


def b_levels(wf: Workflow, env: CloudEnvironment) -> np.ndarray:
    """Upward rank: w_t + max_child (e(t,child) + rank(child))."""
    w = np.array([env.avg_exec_time(t.tid) for t in wf.tasks])
    rank = np.zeros(wf.n_tasks)
    for u in reversed(wf.topo_order()):
        best = 0.0
        for v, d in wf.children[u]:
            best = max(best, env.avg_transfer_time(d) + rank[v])
        rank[u] = w[u] + best
    return rank


def t_levels(wf: Workflow, env: CloudEnvironment) -> np.ndarray:
    """Downward rank (length of longest path from an entry node to t)."""
    w = np.array([env.avg_exec_time(t.tid) for t in wf.tasks])
    lvl = np.zeros(wf.n_tasks)
    for u in wf.topo_order():
        best = 0.0
        for p, d in wf.parents[u]:
            best = max(best, lvl[p] + w[p] + env.avg_transfer_time(d))
        lvl[u] = best
    return lvl


def task_features(wf: Workflow, env: CloudEnvironment) -> np.ndarray:
    """(n_tasks, 10) float array, axis order = ``FEATURE_NAMES``."""
    n = wf.n_tasks
    feats = np.zeros((n, len(FEATURE_NAMES)))
    bl, tl = b_levels(wf, env), t_levels(wf, env)
    depth = wf.depth()
    desc = wf.descendant_counts()
    for t in wf.tasks:
        i = t.tid
        parents = wf.parents[i]
        children = wf.children[i]
        max_transfer = max((env.avg_transfer_time(d) for _, d in parents), default=0.0)
        out_mb = sum(d for _, d in children)
        feats[i] = (
            env.avg_exec_time(i),
            max_transfer,
            float(t.priority),
            float(len(parents)),
            float(len(children)),
            bl[i],
            tl[i],
            out_mb,
            float(depth[i]),
            float(desc[i]),
        )
    return feats
