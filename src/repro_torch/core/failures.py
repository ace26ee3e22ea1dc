"""Resource-failure models (paper Section 4.1).

Three environments — *stable*, *normal*, *unstable* — each defined by

  * MTBF  ~ Weibull, shape in [11.5, 12.5]   (paper cites [7])
  * failure size (#VMs affected) ~ Weibull, shape in [1.5, 2.4]
  * MTTR  ~ log-normal, mean minutes ~ 6 / 3 / 1 for unstable/normal/stable
  * failing-VM set ~ uniform draw; at least ``n_reliable`` VMs never fail.

``FailureTrace.downtime[v]`` is the paper's ``L_v``: sorted disjoint
``(X, Y)`` intervals during which VM ``v`` is unavailable.

A copy of ``repro.core.failures``, line for line (the port imports nothing of
the JAX package); the tests hold the two equal.  Every draw from
``np.random.default_rng`` stays in the same order: keep it so.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Environment", "ENVIRONMENTS", "FailureTrace", "sample_failure_trace"]


@dataclasses.dataclass(frozen=True)
class Environment:
    name: str
    mtbf_shape: float          # Weibull shape k for time-between-failures
    mtbf_scale_s: float        # Weibull scale (seconds)
    size_shape: float          # Weibull shape for failure size (#VMs)
    size_scale: float          # Weibull scale for failure size
    mttr_mean_s: float         # log-normal mean repair time (seconds)
    mttr_sigma: float          # log-normal sigma (of the underlying normal)

    def mttr_mu(self) -> float:
        # mean = exp(mu + sigma^2/2)  =>  mu = ln(mean) - sigma^2/2
        return float(np.log(self.mttr_mean_s) - 0.5 * self.mttr_sigma**2)


# MTBF scales chosen so that, against makespans of tens of minutes on 20 VMs,
# failures are rare/occasional/frequent (paper: MTBF decreases from stable to
# unstable; MTTR ~ 6/3/1 minutes for unstable/normal/stable).
ENVIRONMENTS: dict[str, Environment] = {
    "stable": Environment("stable", mtbf_shape=12.5, mtbf_scale_s=28800.0,
                          size_shape=1.5, size_scale=1.0,
                          mttr_mean_s=60.0, mttr_sigma=0.35),
    "normal": Environment("normal", mtbf_shape=12.0, mtbf_scale_s=3600.0,
                          size_shape=2.0, size_scale=1.6,
                          mttr_mean_s=180.0, mttr_sigma=0.45),
    "unstable": Environment("unstable", mtbf_shape=11.5, mtbf_scale_s=1200.0,
                            size_shape=2.4, size_scale=2.4,
                            mttr_mean_s=360.0, mttr_sigma=0.55),
}


@dataclasses.dataclass
class FailureTrace:
    """Sampled failure realization for one simulation run."""

    env: Environment
    n_vms: int
    failing_vms: list[int]                      # the paper's FVM
    downtime: dict[int, list[tuple[float, float]]]  # the paper's L_v

    def reliable_vms(self) -> list[int]:
        fv = set(self.failing_vms)
        return [v for v in range(self.n_vms) if v not in fv]

    def is_down(self, vm: int, t: float) -> bool:
        return any(x <= t < y for (x, y) in self.downtime.get(vm, ()))

    def next_down_after(self, vm: int, t: float):
        """Earliest interval (X, Y) with X >= t (argmin of Alg. 3 step 11)."""
        for (x, y) in self.downtime.get(vm, ()):
            if x >= t:
                return (x, y)
        return None

    def interval_covering(self, vm: int, t: float):
        """Interval (X, Y) with X <= t < Y, if the VM is down at ``t``."""
        for (x, y) in self.downtime.get(vm, ()):
            if x <= t < y:
                return (x, y)
        return None

    def up_at_or_after(self, vm: int, t: float) -> float:
        """Earliest time >= t at which ``vm`` is up."""
        cur = t
        for (x, y) in self.downtime.get(vm, ()):
            if y <= cur:
                continue
            if x <= cur < y:
                cur = y
            elif x > cur:
                break
        return cur


def sample_failure_trace(env: Environment | str, n_vms: int, horizon_s: float, *,
                         n_reliable: int = 4, seed: int = 0) -> FailureTrace:
    """Draw FVM, MTBF/MTTR realizations per the paper's distributions.

    Failure *events* strike a random subset of the failing VMs; the event size
    is Weibull-distributed (paper 4.1), the affected VMs uniform over FVM.
    """
    if isinstance(env, str):
        env = ENVIRONMENTS[env]
    rng = np.random.default_rng(seed)

    # --- failing-VM set (uniform draw, keep >= n_reliable reliable) --------
    max_failing = max(0, n_vms - n_reliable)
    n_failing = min(max_failing, max(1, int(round(rng.uniform(0.3, 0.8) * max_failing))))
    failing = sorted(rng.choice(n_vms, size=n_failing, replace=False).tolist())

    downtime: dict[int, list[tuple[float, float]]] = {v: [] for v in failing}
    if failing:
        # stationary renewal process: randomize the phase of the first event
        # so short workflows still observe the long-run failure *rate*
        first_gap = env.mtbf_scale_s * rng.weibull(env.mtbf_shape)
        t = -rng.uniform(0.0, first_gap)
        first = True
        while t < horizon_s:
            gap = first_gap if first else env.mtbf_scale_s * rng.weibull(env.mtbf_shape)
            first = False
            t += max(gap, 1.0)
            if t >= horizon_s or t < 0.0:
                continue
            size = int(np.ceil(env.size_scale * rng.weibull(env.size_shape)))
            size = int(np.clip(size, 1, len(failing)))
            struck = rng.choice(failing, size=size, replace=False)
            mttr = rng.lognormal(env.mttr_mu(), env.mttr_sigma, size=size)
            for v, r in zip(struck, mttr):
                downtime[int(v)].append((t, t + float(max(r, 1.0))))

    # merge overlapping intervals per VM
    for v, ivs in downtime.items():
        ivs.sort()
        merged: list[tuple[float, float]] = []
        for x, y in ivs:
            if merged and x <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], y))
            else:
                merged.append((x, y))
        downtime[v] = merged

    return FailureTrace(env=env, n_vms=n_vms, failing_vms=failing, downtime=downtime)
