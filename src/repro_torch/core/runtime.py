"""CheckpointHEFT discrete-event runtime (paper Algorithm 3).

Executes an over-provisioned HEFT :class:`~repro_torch.core.heft.Schedule` against a
sampled :class:`~repro_torch.core.failures.FailureTrace`:

* copies run FIFO per VM in scheduled-EST order ("backlog in HEFT order");
* a copy that cannot start because its VM has a backlog is terminated and
  counted as a failure unless it is the last hope for its task (steps 3-8);
* a VM failure mid-execution fails the copy (Case 1, steps 9-23); a VM that
  is down when the copy should start fails it (Case 2, steps 24-33);
* only when *all* ``repCount_t`` copies have failed is the task resubmitted
  (steps 14-15 / 25-26), either on the min-EST reliable VM (paying the
  re-execution of non-portable checkpointed work, steps 16-21) or on the same
  VM after recovery, resuming from the last checkpoint (steps 22-23);
* synchronized checkpoints every ``lam`` execution seconds cost ``gamma``
  each (Eq. 10); multi-level (SCR-style) configurations mark levels
  ``portable`` when restorable on a *different* VM (PFS backups).

The same engine powers the plain-HEFT and ReplicateAll(k) baselines through
:class:`SimConfig` switches (no resubmission / no skip-on-success).

A copy of ``repro.core.runtime``, line for line (the port imports nothing of
the JAX package); the tests hold the two equal.
"""
from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from .failures import FailureTrace
from .heft import Schedule

__all__ = ["CkptLevel", "SimConfig", "SimResult", "simulate"]


@dataclasses.dataclass(frozen=True)
class CkptLevel:
    lam: float              # checkpoint interval (execution seconds)
    gamma: float            # overhead per checkpoint (seconds)
    portable: bool = False  # restorable on a different VM (SCR PFS level)

    def __post_init__(self) -> None:
        if not self.lam > 0.0:
            raise ValueError(
                f"checkpoint interval lam must be > 0, got {self.lam!r}")
        if self.gamma < 0.0:
            raise ValueError(
                f"checkpoint overhead gamma must be >= 0, got {self.gamma!r}")


@dataclasses.dataclass
class SimConfig:
    ckpt_levels: tuple[CkptLevel, ...] = ()
    resubmit: bool = True            # Algorithm 3 resubmission on last failure
    skip_when_complete: bool = True  # don't start copies of finished tasks
    busy_terminate: bool = True      # steps 3-8 backlog termination
    backlog_tol: float = 120.0       # seconds of backlog tolerated (step 3)
    restore_cost: float = 0.0        # extra work to restore a portable ckpt
    max_resub_per_task: int = 8
    max_events: int = 2_000_000

    def overhead_rate(self) -> float:
        return sum(l.gamma / l.lam for l in self.ckpt_levels)

    def effective_duration(self, work: float) -> float:
        """work + checkpoint overheads, Eq. (10) amortized continuously."""
        return work * (1.0 + self.overhead_rate())

    def work_from_elapsed(self, elapsed: float) -> float:
        return elapsed / (1.0 + self.overhead_rate())

    def salvage(self, work_done: float, *, same_vm: bool) -> float:
        """alpha_t * lam: completed-checkpoint work reusable at restart."""
        best = 0.0
        for l in self.ckpt_levels:
            if same_vm or l.portable:
                best = max(best, math.floor(work_done / l.lam) * l.lam)
        return best


@dataclasses.dataclass
class _Copy:
    cid: int
    task: int
    vm: int
    sched_est: float
    work: float                 # remaining work (execution seconds)
    copy_idx: int = 0           # 0 = original, >=1 standby replica
    is_resubmission: bool = False
    status: str = "pending"
    ready: float = math.inf
    ast: float = math.nan
    aft: float = math.nan
    executed: float = 0.0


@dataclasses.dataclass
class SimResult:
    completed: bool
    tet: float
    usage: float            # processor seconds executed (incl. ckpt overhead)
    wastage: float          # beyond-last-checkpoint + late-replica seconds
    ckpt_overhead: float
    n_resubmissions: int
    n_failures: int
    n_terminated: int
    n_skipped: int
    task_complete: dict[int, float]
    events: int


def simulate(schedule: Schedule, trace: FailureTrace, cfg: SimConfig) -> SimResult:
    wf, env = schedule.workflow, schedule.env
    n_vms = env.n_vms
    failing = set(trace.failing_vms)
    reliable = [v for v in range(n_vms) if v not in failing]

    copies: list[_Copy] = []
    by_task: dict[int, list[int]] = {t: [] for t in range(wf.n_tasks)}
    for p in schedule.placements:
        c = _Copy(cid=len(copies), task=p.task, vm=p.vm, sched_est=p.est,
                  work=float(env.time_on_vm[p.task, p.vm]), copy_idx=p.copy)
        copies.append(c)
        by_task[p.task].append(c.cid)

    rep_count = {t: len(cids) for t, cids in by_task.items()}
    failures = {t: 0 for t in range(wf.n_tasks)}
    resub_count = {t: 0 for t in range(wf.n_tasks)}
    task_complete: dict[int, float] = {}
    complete_vm: dict[int, int] = {}

    vm_queue: dict[int, list[int]] = {v: [] for v in range(n_vms)}
    vm_busy_until = np.zeros(n_vms)
    running_on: dict[int, int | None] = {v: None for v in range(n_vms)}

    stats = {"usage": 0.0, "waste": 0.0, "ckpt": 0.0,
             "resub": 0, "fail": 0, "term": 0, "skip": 0}

    heap: list[tuple[float, int, str, int]] = []
    seq = [0]

    def push(time: float, kind: str, payload: int) -> None:
        heapq.heappush(heap, (time, seq[0], kind, payload))
        seq[0] += 1

    # ---- helpers ----------------------------------------------------------
    def parents_done(task: int) -> bool:
        return all(p in task_complete for p, _ in wf.parents[task])

    def ready_time(copy: _Copy) -> float:
        r = 0.0
        for par, d in wf.parents[copy.task]:
            r = max(r, task_complete[par] +
                    env.transfer_time(d, complete_vm[par], copy.vm))
        return r

    def alive_siblings(copy: _Copy) -> int:
        return sum(1 for cid in by_task[copy.task]
                   if cid != copy.cid and
                   copies[cid].status in ("pending", "queued", "running"))

    def min_est_reliable(now: float) -> tuple[float, int]:
        pool = reliable if reliable else list(range(n_vms))
        best_t, best_v = math.inf, pool[0]
        for v in pool:
            est = max(now, float(vm_busy_until[v]))
            if est < best_t:
                best_t, best_v = est, v
        return best_t, best_v

    def account(copy: _Copy, start_t: float, end_t: float) -> None:
        elapsed = max(0.0, end_t - start_t)
        copy.executed += elapsed
        stats["usage"] += elapsed
        rate = cfg.overhead_rate()
        stats["ckpt"] += elapsed * rate / (1.0 + rate)

    def enqueue(copy: _Copy, ready: float, *, front: bool = False) -> None:
        copy.status = "queued"
        if copy.copy_idx > 0 and not copy.is_resubmission:
            # standby replica: its HEFT slot (scheduled after the children,
            # [8]) is an earliest-start floor, so it runs only if the task
            # is still incomplete by then
            ready = max(ready, copy.sched_est)
        copy.ready = ready
        q = vm_queue[copy.vm]
        if front:
            q.insert(0, copy.cid)
        else:
            q.append(copy.cid)
            q.sort(key=lambda c: copies[c].sched_est)
        push(ready, "vm_try", copy.vm)
        if cfg.busy_terminate:
            push(ready + cfg.backlog_tol, "vm_try", copy.vm)

    def spawn_resubmission(task: int, vm: int, work: float,
                           ready: float) -> None:
        stats["resub"] += 1
        resub_count[task] += 1
        new = _Copy(cid=len(copies), task=task, vm=vm, sched_est=ready,
                    work=max(work, 1e-3), is_resubmission=True)
        copies.append(new)
        by_task[task].append(new.cid)
        enqueue(new, ready, front=True)

    # ---- resubmission, Case 1 (steps 16-23) --------------------------------
    def resubmit_case1(copy: _Copy, now: float, down_until: float,
                       work_done: float) -> None:
        salv_same = cfg.salvage(work_done, same_vm=True)
        salv_move = cfg.salvage(work_done, same_vm=False)
        min_est, v_new = min_est_reliable(now)
        overhead = max(0.0, salv_same - salv_move)       # step 19
        full_work = float(env.time_on_vm[copy.task, copy.vm])
        forced = resub_count[copy.task] >= cfg.max_resub_per_task
        if forced or (min_est + overhead < down_until):  # steps 20-21
            stats["waste"] += max(0.0, copy.executed - salv_move)
            frac = salv_move / max(full_work, 1e-9)
            w = float(env.time_on_vm[copy.task, v_new]) * (1.0 - frac)
            spawn_resubmission(copy.task, v_new, w + cfg.restore_cost, min_est)
        else:                                            # steps 22-23
            stats["waste"] += max(0.0, copy.executed - salv_same)
            spawn_resubmission(copy.task, copy.vm,
                               max(copy.work - salv_same, 1e-3), down_until)

    # ---- start execution (Case-1 outcome precomputed from the trace) -------
    def start(copy: _Copy, now: float) -> None:
        copy.status = "running"
        copy.ast = now
        end = now + cfg.effective_duration(copy.work)
        running_on[copy.vm] = copy.cid
        if copy.vm in failing:
            nxt = trace.next_down_after(copy.vm, now)
            if nxt is not None and nxt[0] < end:         # fails at X
                vm_busy_until[copy.vm] = nxt[0]
                push(nxt[0], "end_fail", copy.cid)
                return
        vm_busy_until[copy.vm] = end
        push(end, "end_ok", copy.cid)

    # ---- the per-VM scheduling attempt -------------------------------------
    def vm_try(v: int, now: float) -> None:
        q = vm_queue[v]
        if running_on[v] is not None or now < vm_busy_until[v]:
            # ---- backlog termination sweep (steps 3-8) ---------------------
            # lateness is measured against the *scheduled* start: waiting
            # for a planned queue slot is not backlog, missing it is
            if cfg.busy_terminate:
                for cid in list(q):
                    copy = copies[cid]
                    if (copy.status == "queued" and not copy.is_resubmission
                            and now - max(copy.ready, copy.sched_est)
                            > cfg.backlog_tol
                            and alive_siblings(copy) > 0):
                        copy.status = "terminated"       # step 7
                        failures[copy.task] += 1         # step 8
                        stats["term"] += 1
                        q.remove(cid)
            return
        down = trace.interval_covering(v, now)
        i = 0
        min_ready = math.inf
        while i < len(q):
            copy = copies[q[i]]
            if copy.status != "queued":
                q.pop(i)
                continue
            if cfg.skip_when_complete and copy.task in task_complete:
                copy.status = "skipped"
                stats["skip"] += 1
                q.pop(i)
                continue
            if copy.ready > now:
                # standby replicas with later floors must not block the
                # queue: keep scanning for a ready copy (work-conserving)
                min_ready = min(min_ready, copy.ready)
                i += 1
                continue
            if copy.copy_idx > 0 and not copy.is_resubmission:
                # standby activation: while a sibling copy is actually
                # running, defer to its expected completion -- the replica
                # fires only for failed / backlogged / overdue copies
                # ("if one copy fails, one of its replicas is scheduled
                # and executed", Section 1)
                defer = 0.0
                for cid2 in by_task[copy.task]:
                    o = copies[cid2]
                    if o.cid != copy.cid and o.status == "running":
                        defer = max(defer,
                                    o.ast + cfg.effective_duration(o.work))
                if defer > now:
                    copy.ready = defer + 1e-6
                    min_ready = min(min_ready, copy.ready)
                    i += 1
                    continue
            if down is not None:
                # ---- Case 2: VM currently down (steps 24-33) ---------------
                x, y = down
                q.pop(i)
                copy.status = "failed"                   # step 25
                failures[copy.task] += 1
                stats["fail"] += 1
                if (failures[copy.task] >= rep_count[copy.task]
                        and copy.task not in task_complete and cfg.resubmit):
                    min_est, v_new = min_est_reliable(now)
                    if min_est < y:                      # steps 30-31
                        spawn_resubmission(
                            copy.task, v_new,
                            float(env.time_on_vm[copy.task, v_new]), min_est)
                    else:                                # steps 32-33
                        spawn_resubmission(
                            copy.task, v,
                            float(env.time_on_vm[copy.task, v]), y)
                continue
            q.pop(i)
            start(copy, now)
            return
        if min_ready < math.inf:
            push(min_ready, "vm_try", v)

    # ---- task completion ----------------------------------------------------
    def complete(copy: _Copy, now: float) -> None:
        t = copy.task
        if t in task_complete:
            # a sibling already finished: late-replica waste (type 2)
            stats["waste"] += min(copy.executed,
                                  max(0.0, now - task_complete[t]))
            return
        task_complete[t] = now
        complete_vm[t] = copy.vm
        for child, _ in wf.children[t]:
            if parents_done(child):
                for cid in by_task[child]:
                    ch = copies[cid]
                    if ch.status == "pending":
                        enqueue(ch, ready_time(ch))

    # ---- seed entry tasks ----------------------------------------------------
    for t in wf.entry_tasks():
        for cid in by_task[t]:
            enqueue(copies[cid], 0.0)

    events = 0
    while heap and events < cfg.max_events:
        now, _, kind, payload = heapq.heappop(heap)
        events += 1
        if kind == "vm_try":
            vm_try(payload, now)
        elif kind == "end_ok":
            copy = copies[payload]
            account(copy, copy.ast, now)
            copy.status = "done"
            copy.aft = now
            running_on[copy.vm] = None
            complete(copy, now)
            push(now, "vm_try", copy.vm)
        elif kind == "end_fail":
            copy = copies[payload]
            account(copy, copy.ast, now)
            running_on[copy.vm] = None
            down = trace.interval_covering(copy.vm, now) or (now, now + 1.0)
            copy.status = "failed"                       # step 14
            failures[copy.task] += 1
            stats["fail"] += 1
            work_done = cfg.work_from_elapsed(copy.executed)
            if (failures[copy.task] >= rep_count[copy.task]
                    and copy.task not in task_complete):
                if cfg.resubmit:
                    resubmit_case1(copy, now, down[1], work_done)
                else:
                    stats["waste"] += copy.executed
            else:
                stats["waste"] += max(
                    0.0, copy.executed - cfg.salvage(work_done, same_vm=True))
            push(down[1], "vm_try", copy.vm)

    completed = len(task_complete) == wf.n_tasks
    tet = max(task_complete.values()) if task_complete else 0.0
    waste = stats["waste"]
    if not completed:
        # failed run: every executed second was futile (paper Section 4.2)
        waste = stats["usage"]
    return SimResult(
        completed=completed,
        tet=tet,
        usage=stats["usage"],
        wastage=waste,
        ckpt_overhead=stats["ckpt"],
        n_resubmissions=stats["resub"],
        n_failures=stats["fail"],
        n_terminated=stats["term"],
        n_skipped=stats["skip"],
        task_complete=task_complete,
        events=events,
    )
