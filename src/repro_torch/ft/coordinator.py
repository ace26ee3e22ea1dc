"""Failure sampling for the serve worker pool.

Only :class:`FaultInjector` is ported so far; the fault-tolerant training
coordinator waits for the training slice.
"""
from __future__ import annotations

import collections

import numpy as np

__all__ = ["FaultInjector"]


class FaultInjector:
    """Samples failure steps from Weibull MTBF (in units of steps).

    The schedule is a step -> count **multiset** (`collections.Counter`):
    two faults scheduled — or deferred — onto the same step remain two
    distinct faults and strike on consecutive visits, instead of silently
    collapsing into one as a plain set would.
    """

    def __init__(self, *, mtbf_steps: float, shape: float = 12.0,
                 mttr_steps: float = 2.0, seed: int = 0,
                 horizon_steps: int = 100_000):
        rng = np.random.default_rng(seed)
        self._schedule: collections.Counter = collections.Counter()
        self.mttr_steps = mttr_steps
        t = rng.uniform(0, mtbf_steps)
        while t < horizon_steps:
            self._schedule[int(t)] += 1
            t += max(1.0, mtbf_steps * rng.weibull(shape))

    @property
    def fail_steps(self) -> collections.Counter:
        """step -> scheduled-fault count (supports ``in`` / iteration)."""
        return self._schedule

    @fail_steps.setter
    def fail_steps(self, steps) -> None:
        # accepts a set/iterable (each step once) or a mapping step -> count
        self._schedule = collections.Counter(steps)

    def fails_at(self, step: int) -> bool:
        return self._schedule[step] > 0

    def consume(self, step: int) -> bool:
        """Pop one failure scheduled at ``step`` (True if one fired)."""
        if self._schedule[step] > 0:
            self._schedule[step] -= 1
            if not self._schedule[step]:
                del self._schedule[step]
            return True
        return False

    def defer(self, step: int, to_step: int) -> None:
        """Move one failure scheduled at ``step`` to ``to_step``.

        Used when the target is already down at ``step``: the fault is not
        silently absorbed by the outage — it strikes again the moment the
        target is back up (``to_step`` = repair completion).  Deferring onto
        a step that already holds a fault stacks them (multiset), so two
        deferred faults fire on two separate visits.
        """
        if to_step > step and self._schedule[step] > 0:
            self._schedule[step] -= 1
            if not self._schedule[step]:
                del self._schedule[step]
            self._schedule[int(to_step)] += 1
