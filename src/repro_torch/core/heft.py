"""HEFT with replication over-provisioning (paper Algorithm 2).

* Originals are ranked by B-level (upward rank) and placed with the classic
  insertion-based earliest-finish-time rule of Topcuoglu et al. [13].
* Replicas of a task t' are placed once *all children of t'* have been
  scheduled (Algorithm 2 lines 7-9, following Zhang et al. [8]: "replicas for
  a task are scheduled after its children"), each on the distinct VM giving
  the minimum EST insertion slot.

A copy of ``repro.core.heft``, line for line (the port imports nothing of
the JAX package); the tests hold the two equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .features import b_levels
from .workflow import CloudEnvironment, Workflow

__all__ = ["Placement", "Schedule", "heft_schedule"]


@dataclasses.dataclass
class Placement:
    task: int
    copy: int          # 0 = original, >=1 replicas
    vm: int
    est: float
    eft: float

    @property
    def is_replica(self) -> bool:
        return self.copy > 0

    @property
    def duration(self) -> float:
        return self.eft - self.est


@dataclasses.dataclass
class Schedule:
    workflow: Workflow
    env: CloudEnvironment
    placements: list[Placement]
    ranks: np.ndarray

    def __post_init__(self):
        self.by_task: dict[int, list[Placement]] = {}
        self.by_vm: dict[int, list[Placement]] = {v: [] for v in range(self.env.n_vms)}
        for p in self.placements:
            self.by_task.setdefault(p.task, []).append(p)
            self.by_vm[p.vm].append(p)
        for v in self.by_vm:
            self.by_vm[v].sort(key=lambda p: p.est)
        for t in self.by_task:
            self.by_task[t].sort(key=lambda p: p.copy)

    @property
    def makespan(self) -> float:
        """TET_perfect, Eq. (7)."""
        return max((p.eft for p in self.placements if p.copy == 0), default=0.0)

    def original(self, task: int) -> Placement:
        return self.by_task[task][0]

    def critical_path(self) -> list[int]:
        """Backtrack from argmax EFT through zero-slack predecessors (3.2)."""
        orig = {t: self.original(t) for t in self.by_task}
        t_cur = max(orig, key=lambda t: orig[t].eft)
        path = [t_cur]
        while self.workflow.parents[t_cur]:
            best_p, best_fin = None, -np.inf
            p_cur = orig[t_cur]
            for par, d in self.workflow.parents[t_cur]:
                pp = orig[par]
                fin = pp.eft + self.env.transfer_time(d, pp.vm, p_cur.vm)
                if fin > best_fin:
                    best_fin, best_p = fin, par
            path.append(best_p)
            t_cur = best_p
        path.reverse()
        return path


class _VMTimeline:
    """Busy intervals per VM with insertion-based free-slot search."""

    def __init__(self, n_vms: int):
        self.busy: list[list[tuple[float, float]]] = [[] for _ in range(n_vms)]

    def earliest_slot(self, vm: int, ready: float, duration: float) -> float:
        t = ready
        for (s, e) in self.busy[vm]:
            if t + duration <= s:
                break
            t = max(t, e)
        return t

    def append_slot(self, vm: int, ready: float) -> float:
        """EST with no insertion: after everything already scheduled."""
        last_end = self.busy[vm][-1][1] if self.busy[vm] else 0.0
        return max(ready, last_end)

    def insert(self, vm: int, start: float, end: float) -> None:
        iv = self.busy[vm]
        lo = 0
        while lo < len(iv) and iv[lo][0] < start:
            lo += 1
        iv.insert(lo, (start, end))


def heft_schedule(wf: Workflow, env: CloudEnvironment,
                  rep_counts: np.ndarray | int = 1) -> Schedule:
    """Build the over-provisioned HEFT schedule.

    ``rep_counts[t]`` = total copies of task t (1 = original only); an int
    applies uniformly (``ReplicateAll(k)`` uses ``k + 1``).
    """
    n = wf.n_tasks
    if np.isscalar(rep_counts):
        rep_counts = np.full(n, int(rep_counts))
    rep_counts = np.maximum(np.asarray(rep_counts, dtype=np.int64), 1)

    ranks = b_levels(wf, env)
    order = sorted(range(n), key=lambda t: -ranks[t])

    timeline = _VMTimeline(env.n_vms)
    placements: list[Placement] = []
    original: dict[int, Placement] = {}
    scheduled: set[int] = set()
    replicas_done: set[int] = set()

    def ready_time(task: int, vm: int) -> float:
        r = 0.0
        for par, d in wf.parents[task]:
            pp = original[par]
            r = max(r, pp.eft + env.transfer_time(d, pp.vm, vm))
        return r

    def place_replicas(task: int) -> None:
        """Replicas on distinct VMs with minimum *append* ESTs.

        Following [8] (replicas are scheduled after the children), replica
        slots go after everything already on the VM timeline: they are
        standby copies that at runtime execute only if still needed
        (CheckpointHEFT skips copies of completed tasks).
        """
        if task in replicas_done:
            return
        replicas_done.add(task)
        used_vms = {original[task].vm}
        # standby provisioning: a replica slot opens no earlier than the
        # original's estimated finish plus a speculative-grace margin
        # ("if one copy fails, one of its replicas is scheduled and
        # executed", Section 1) -- so replicas fire only for copies that
        # failed or are badly overdue, not in a race with healthy originals
        orig = original[task]
        floor = orig.eft + 0.5 * orig.duration
        for copy in range(1, int(rep_counts[task])):
            best = None  # (est, vm, dur)
            for vm in range(env.n_vms):
                if vm in used_vms and len(used_vms) < env.n_vms:
                    continue
                dur = float(env.time_on_vm[task, vm])
                est = timeline.append_slot(vm, max(ready_time(task, vm), floor))
                if best is None or est < best[0]:
                    best = (est, vm, dur)
            est, vm, dur = best
            used_vms.add(vm)
            timeline.insert(vm, est, est + dur)
            placements.append(Placement(task, copy, vm, est, est + dur))

    # -- pass 1: originals via min-EFT insertion (HEFT proper), identical to
    #    the plain-HEFT baseline so replication cannot degrade the primary
    #    assignment ---------------------------------------------------------
    for t in order:
        best = None  # (eft, est, vm)
        for vm in range(env.n_vms):
            dur = float(env.time_on_vm[t, vm])
            est = timeline.earliest_slot(vm, ready_time(t, vm), dur)
            eft = est + dur
            if best is None or eft < best[0]:
                best = (eft, est, vm)
        eft, est, vm = best
        timeline.insert(vm, est, eft)
        p = Placement(t, 0, vm, est, eft)
        placements.append(p)
        original[t] = p
        scheduled.add(t)

    # -- pass 2 (Algorithm 2 lines 7-9): replicas of t' are placed once all
    #    children of t' are scheduled -- trivially true after pass 1, so we
    #    emit them in rank order; each goes after the existing timeline. ----
    for t in order:
        place_replicas(t)

    return Schedule(wf, env, placements, ranks)
