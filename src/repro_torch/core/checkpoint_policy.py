"""Dynamic checkpoint interval (paper Section 3.2, Lemma 3.1).

``TET_CRCH(lambda) = TET_{/CO}(lambda) * (1 + gamma/lambda)``  (Eq. 25)

with ``TET_{/CO}`` summed over the critical path (Eq. 24):

  TET_Ci = TET_Hi + WT_i + P_ti^{R_i} * [ P_same * (E_minEST_same + E[PF mod lam])
                                        + (1-P_same) * (E_minEST_diff + TET_Hi) ]

We estimate the model's sufficient statistics from the schedule and the
environment's distributions:

* ``P_ti`` — P(overlap) * |FVM|/|V| (Eqs. 15-17) with
  P(overlap) = 1 - exp(-duration / MTBF).
* ``E[PF mod lam] = lam / 2`` (uniform point-of-failure within an interval).
* ``P_same(lam)`` decreases in lam (paper's argument): moving is preferred
  exactly when the re-execution overhead ``alpha*lam ~ PF - PF mod lam`` stays
  below the remaining repair time; we use
  ``P_same = exp(-(E_minEST_diff + lam/2) / MTTR)``.
* ``Term2 = 1 + gamma/lam`` — checkpoint overhead (Eq. 10).

The optimum is found by golden-section search; an empirical grid tuner
(running the full simulator) backs Fig. 7b.

A copy of ``repro.core.checkpoint_policy``, line for line (the port imports nothing of
the JAX package); the tests hold the two equal.
"""
from __future__ import annotations

import math

import numpy as np

from .failures import Environment
from .heft import Schedule

__all__ = ["model_tet", "optimal_lambda", "empirical_lambda_grid"]


def _cp_stats(schedule: Schedule):
    cp = schedule.critical_path()
    durations = [schedule.original(t).duration for t in cp]
    return cp, durations


def model_tet(lam: float, schedule: Schedule, env_model: Environment, *,
              gamma: float, rep_counts=None,
              e_min_est_diff: float | None = None) -> float:
    """Eq. 24-25 estimate of E[TET] for a given checkpoint interval."""
    lam = max(float(lam), 1e-3)
    cp, durs = _cp_stats(schedule)
    n_vms = schedule.env.n_vms
    # |FVM|/|V|: expectation of the uniform draw in failures.sample (~0.55
    # of the non-reliable pool)
    p_vm = 0.55 * max(n_vms - 4, 0) / n_vms
    mtbf = env_model.mtbf_scale_s * math.gamma(1.0 + 1.0 / env_model.mtbf_shape)
    mttr = env_model.mttr_mean_s
    if e_min_est_diff is None:
        # expected queue delay on the min-EST reliable VM ~ half a mean task
        e_min_est_diff = 0.5 * float(np.mean(durs))
    e_min_est_same = 0.5 * mttr

    total = 0.0
    for t, dur in zip(cp, durs):
        r_i = int(rep_counts[t]) if rep_counts is not None else 1
        p_overlap = 1.0 - math.exp(-dur / max(mtbf, 1e-9))
        p_t = p_overlap * p_vm                      # Eq. 17
        p_all_fail = p_t ** max(r_i, 1)             # Eq. 18
        p_same = math.exp(-(e_min_est_diff + 0.5 * lam) / max(mttr, 1e-9))
        ro = p_all_fail * (
            p_same * (e_min_est_same + 0.5 * lam)            # Eq. 20
            + (1.0 - p_same) * (e_min_est_diff + dur)        # Eq. 21
        )
        wt = 0.05 * dur                              # WT_i ~ N_w mean (Assn. 1)
        total += dur + wt + ro                       # Eq. 8
    return total * (1.0 + gamma / lam)               # Eq. 25


def optimal_lambda(schedule: Schedule, env_model: Environment, *,
                   gamma: float, rep_counts=None,
                   lo: float = 5.0, hi: float = 600.0) -> float:
    """Golden-section search for argmin_lambda of the Lemma 3.1 model."""
    phi = (math.sqrt(5.0) - 1.0) / 2.0
    a, b = math.log(lo), math.log(hi)

    def f(x: float) -> float:
        return model_tet(math.exp(x), schedule, env_model, gamma=gamma,
                         rep_counts=rep_counts)

    c, d = b - phi * (b - a), a + phi * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(40):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - phi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + phi * (b - a)
            fd = f(d)
    return float(math.exp(0.5 * (a + b)))


def empirical_lambda_grid(schedule: Schedule, traces, lam_grid, *,
                          gamma: float):
    """Average simulated TET per lambda (used for Fig. 7b)."""
    from .runtime import CkptLevel, SimConfig, simulate

    rows = []
    for lam in lam_grid:
        cfg = SimConfig(ckpt_levels=(CkptLevel(float(lam), gamma),),
                        resubmit=True, skip_when_complete=True,
                        busy_terminate=False)
        tets = []
        for tr in traces:
            res = simulate(schedule, tr, cfg)
            if res.completed:
                tets.append(res.tet)
        rows.append((float(lam),
                     float(np.mean(tets)) if tets else float("nan")))
    return rows
