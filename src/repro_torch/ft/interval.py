"""Dynamic checkpoint interval from online failure statistics.

The paper's Lemma 3.1 shows lambda* is environment dependent: we estimate
the environment *online* -- Weibull MTBF via moment matching on observed
inter-failure gaps, log-normal MTTR from repair durations -- and re-derive
lambda* as failures accumulate.  The closed-form first-order optimum is the
Young/Daly interval sqrt(2 * gamma * MTBF); the full Lemma-3.1 model (which
adds the resubmission/waiting terms) is available through
``repro.core.checkpoint_policy`` when a schedule is in hand.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["DynamicInterval"]


class DynamicInterval:
    def __init__(self, *, gamma_s: float, lam_min: float = 10.0,
                 lam_max: float = 3600.0, prior_mtbf_s: float = 4 * 3600.0):
        self.gamma_s = float(gamma_s)
        self.lam_min, self.lam_max = lam_min, lam_max
        self.prior_mtbf_s = prior_mtbf_s
        self.failure_times: list[float] = []
        self.repair_durations: list[float] = []

    # -- observations ---------------------------------------------------------
    def record_failure(self, t: float) -> None:
        self.failure_times.append(float(t))

    def record_repair(self, duration_s: float) -> None:
        self.repair_durations.append(float(duration_s))

    # -- estimates --------------------------------------------------------------
    def mtbf(self) -> float:
        if len(self.failure_times) < 2:
            return self.prior_mtbf_s
        gaps = np.diff(sorted(self.failure_times))
        gaps = gaps[gaps > 0]
        if gaps.size == 0:
            return self.prior_mtbf_s
        # Weibull moment match: with the paper's shapes (11.5-12.5) the mean
        # ~= scale, so the empirical mean is the MTBF estimate; blend with
        # the prior while the sample is small.
        w = min(1.0, gaps.size / 8.0)
        return float(w * gaps.mean() + (1 - w) * self.prior_mtbf_s)

    def mttr(self) -> float:
        if not self.repair_durations:
            return 60.0
        logs = np.log(np.maximum(self.repair_durations, 1e-3))
        return float(np.exp(logs.mean() + 0.5 * logs.var()))

    def current_lambda(self) -> float:
        """Young/Daly first-order optimum, clamped."""
        lam = math.sqrt(2.0 * self.gamma_s * self.mtbf())
        return float(min(max(lam, self.lam_min), self.lam_max))
