"""Evaluation metrics (paper Section 4.2).

* TET — total execution time (makespan) of the workflow.
* Resource Usage — processor seconds spent executing task copies
  (reported as a fraction of TET, Fig. 8).
* Resource Wastage — beyond-last-checkpoint losses + late-replica
  executions; failed workflows waste everything they executed (Fig. 9).
* SLR — TET / B-level of the first task on the (replica-aware) critical
  path (Fig. 10).

A copy of ``repro.core.metrics``, line for line (the port imports nothing of
the JAX package); the tests hold the two equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .features import b_levels
from .heft import Schedule
from .runtime import SimResult

__all__ = ["RunMetrics", "metrics_from_result", "aggregate"]


@dataclasses.dataclass
class RunMetrics:
    completed: bool
    tet: float
    usage: float
    wastage: float
    usage_frac: float      # usage / TET (paper Fig. 8 normalization)
    wastage_frac: float
    slr: float
    ckpt_overhead: float
    n_resubmissions: int


def slr(schedule: Schedule, tet: float) -> float:
    """TET / B-level of the first task on the critical path."""
    cp = schedule.critical_path()
    bl = b_levels(schedule.workflow, schedule.env)
    denom = float(bl[cp[0]]) if cp else 1.0
    return float(tet / max(denom, 1e-9))


def metrics_from_result(schedule: Schedule, res: SimResult) -> RunMetrics:
    tet = res.tet if res.completed else max(res.tet, schedule.makespan)
    return RunMetrics(
        completed=res.completed,
        tet=tet,
        usage=res.usage,
        wastage=res.wastage,
        usage_frac=res.usage / max(tet, 1e-9),
        wastage_frac=res.wastage / max(tet, 1e-9),
        slr=slr(schedule, tet) if res.completed else float("nan"),
        ckpt_overhead=res.ckpt_overhead,
        n_resubmissions=res.n_resubmissions,
    )


def aggregate(runs: list[RunMetrics]) -> dict[str, float]:
    """Average metrics over repeated executions (paper: 10 runs per DAX)."""
    if not runs:
        # np.mean([]) raises a RuntimeWarning and yields nan; make the
        # empty aggregate explicit instead.
        keys = ("usage", "usage_frac", "wastage", "wastage_frac",
                "ckpt_overhead", "resubmissions", "tet", "slr")
        return {"n_runs": 0.0, "success_rate": 0.0,
                **{k: float("nan") for k in keys}}
    ok = [r for r in runs if r.completed]
    out = {
        "n_runs": float(len(runs)),
        "success_rate": len(ok) / max(len(runs), 1),
        "usage": float(np.mean([r.usage for r in runs])),
        "usage_frac": float(np.mean([r.usage_frac for r in runs])),
        "wastage": float(np.mean([r.wastage for r in runs])),
        "wastage_frac": float(np.mean([r.wastage_frac for r in runs])),
        "ckpt_overhead": float(np.mean([r.ckpt_overhead for r in runs])),
        "resubmissions": float(np.mean([r.n_resubmissions for r in runs])),
    }
    out["tet"] = float(np.mean([r.tet for r in ok])) if ok else float("nan")
    out["slr"] = float(np.mean([r.slr for r in ok])) if ok else float("nan")
    return out
