"""Fault-tolerant training coordinator (checkpoint / restart / elastic).

Counterpart of ``repro.ft.coordinator``, with the same loop, counters and
report.  The train step it drives must be out of place (as the port's
``make_train_step`` is): the NaN guard rejects a step by keeping the
pre-step params and optimizer state, which an in-place update would already
have overwritten.

Runs the train step under simulated host failures:

* a :class:`FaultInjector` (Weibull MTBF / log-normal MTTR, the paper's
  Section 4.1 distributions) decides which steps are interrupted;
* on failure the coordinator restores params/opt/data-iterator from the
  :class:`~repro_torch.ft.checkpoint.CheckpointStore` pointer index and
  replays from the last checkpoint -- work since then is the "beyond last
  checkpoint" waste the paper measures;
* the checkpoint cadence follows
  :class:`~repro_torch.ft.interval.DynamicInterval`
  (Lemma 3.1: unstable environments checkpoint more often);
* ``on_rescale`` supports *elastic* restarts: the pointer index is
  host-count-agnostic, so a restore onto fewer hosts re-shards transparently
  (demonstrated in tests with a re-built data pipeline / step function).

Chaos hardening (the ``repro.chaos`` training-side recovery paths):

* **NaN/Inf guard** — a non-finite loss (organic or injected via the
  ``nan_poison`` fault) *rejects* the already-computed update, rolls the
  in-memory params/opt back to their pre-step values, and quarantines the
  poisoned batch index so checkpoint replay skips it too;
* **escalating backoff** — when the same step fails repeatedly (the
  multiset :class:`FaultInjector` schedule can hold several faults on one
  step), the simulated repair wait doubles per repeat and a synchronous
  checkpoint is forced immediately before the retry, bounding replay waste;
* a ``ckpt_corrupt`` fault flips bytes in the newest committed checkpoint
  shard; the subsequent restore transparently falls back to the newest
  checkpoint that verifies (``CheckpointStore`` quarantine path);
* a ``slowdown`` fault costs virtual time (a straggler) but loses no state;
* a ``net_partition`` fault on the single-actor coordinator is the
  degenerate one-pod cluster case: no quorum exists, so the whole cluster
  *parks* for the partition window (virtual time lost, no state) — the real
  quorum/minority split lives in ``repro.ft.crosspod.PodTrainingCluster``
  (not ported yet);
* a ``disk_full`` fault arms the store's next save with a mid-write ENOSPC
  and forces a checkpoint through it: the store prunes its oldest commit
  and retries, and the committed index stays consistent
  (``CheckpointStore.verify_committed``).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable

import numpy as np

from ..chaos.faults import (CAPACITY_LOSS, CKPT_CORRUPT, DISK_FULL,
                            HOST_CRASH, NAN_POISON, NET_PARTITION, SLOWDOWN,
                            corrupt_checkpoint_shard)
from ..obs.metrics import MetricsRegistry
from ..obs.trace import NULL_TRACER

from .checkpoint import CheckpointStore
from .interval import DynamicInterval

__all__ = ["FaultInjector", "TrainingCoordinator", "CoordinatorReport"]


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


@dataclasses.dataclass
class CoordinatorReport:
    steps_completed: int
    failures: int
    restores: int
    wasted_steps: int
    checkpoints: int
    final_loss: float
    losses: list
    nan_rollbacks: int = 0       # NaN/Inf updates rejected by the guard
    skipped_batches: int = 0     # poisoned batch indices quarantined
    backoff_steps: float = 0.0   # extra repair wait from escalation
    ckpt_fallbacks: int = 0      # restores that skipped a corrupt checkpoint
    ckpt_corruptions: int = 0    # injected ckpt_corrupt events applied
    slowdowns: int = 0           # straggler events absorbed
    partitions: int = 0          # net_partition windows parked through
    parked_steps: float = 0.0    # virtual steps lost to partition parking
    disk_full_events: int = 0    # injected ENOSPC saves
    enospc_retries: int = 0      # saves that pruned-and-retried past ENOSPC
    index_violations: int = 0    # committed-index audit failures (must be 0)


class TrainingCoordinator:
    def __init__(self, *, train_step: Callable, params, opt_state,
                 pipeline, store: CheckpointStore,
                 interval: DynamicInterval | None = None,
                 step_time_s: float = 1.0,
                 injector: FaultInjector | None = None,
                 chaos=None, tracer=None,
                 registry: MetricsRegistry | None = None):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.store = store
        self.interval = interval or DynamicInterval(gamma_s=1.0)
        self.step_time_s = step_time_s
        self.injector = injector
        self.chaos = chaos   # repro_torch.chaos.ChaosEngine | None
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.registry = registry if registry is not None else MetricsRegistry()
        # the coordinator's former inline counters, as labeled series; the
        # report reads these back, so a shared registry sees the same numbers
        self._ev = self.registry.counter(
            "train_events_total",
            "training-side fault/recovery events by kind", ("kind",))
        self._ckpt_count = self.registry.counter(
            "train_checkpoints_total", "checkpoints committed by mode",
            ("mode",))
        self._wasted = self.registry.counter(
            "train_wasted_steps_total",
            "steps replayed because they were past the last checkpoint")
        self._lost = self.registry.counter(
            "train_lost_steps_total",
            "virtual steps lost without state loss, by cause", ("cause",))
        self.step = 0
        self._last_ckpt_step = -1
        self._nan_skip: set[int] = set()         # quarantined batch indices
        self._fail_counts: collections.Counter = collections.Counter()
        self._ckpt_before: set[int] = set()      # pre-retry barrier steps

    # -- checkpoint cadence in steps -----------------------------------------
    def _ckpt_every(self) -> int:
        lam = self.interval.current_lambda()
        return max(1, int(round(lam / self.step_time_s)))

    def _save(self, *, sync: bool) -> None:
        tree = {"params": self.params, "opt": self.opt_state}
        self.store.save(self.step, tree, extra=self.pipeline.state(),
                        sync=sync)
        self._last_ckpt_step = self.step
        self._ckpt_count.inc(mode="sync" if sync else "async")

    def _restore(self) -> None:
        tree, step, extra = self.store.restore(
            {"params": self.params, "opt": self.opt_state})
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.pipeline = type(self.pipeline).from_state(
            self.pipeline.cfg, self.pipeline.model_cfg, extra)
        self.step = step
        # the restored checkpoint IS the last good checkpoint (a fallback
        # restore may land earlier than the newest save)
        self._last_ckpt_step = step

    # -- main loop --------------------------------------------------------------
    def run(self, n_steps: int) -> CoordinatorReport:
        ev, lost = self._ev, self._lost
        losses: list[float] = []
        self._save(sync=True)
        virtual_t = 0.0
        while self.step < n_steps:
            step = self.step
            if step in self._ckpt_before and self._last_ckpt_step < step:
                # a previous visit to this step failed repeatedly: checkpoint
                # right before the retry so a re-strike replays nothing
                self._save(sync=True)
            # -- faults scheduled for this step ------------------------------
            crash = False
            poison = False
            repair = float(self.injector.mttr_steps
                           if self.injector is not None else 2.0)
            if self.chaos is not None:
                for ev_ in self.chaos.events_at(step):
                    if ev_.kind in (HOST_CRASH, CAPACITY_LOSS):
                        crash = True
                        repair = max(repair, float(ev_.duration))
                    elif ev_.kind == SLOWDOWN:
                        ev.inc(kind="slowdown")
                        lost.inc(ev_.duration, cause="slowdown")
                        virtual_t += ev_.duration * self.step_time_s
                    elif ev_.kind == CKPT_CORRUPT:
                        if corrupt_checkpoint_shard(self.store, ev_.seed):
                            ev.inc(kind="ckpt_corrupt")
                    elif ev_.kind == NAN_POISON:
                        poison = True
                    elif ev_.kind == NET_PARTITION:
                        # degenerate single-pod cluster: no quorum on the
                        # other side of the cut -> whole-cluster park for
                        # the window (wall clock lost, no state lost)
                        ev.inc(kind="net_partition")
                        lost.inc(ev_.duration, cause="partition_park")
                        virtual_t += ev_.duration * self.step_time_s
                        self.tracer.recovery("net_partition", step=step,
                                             parked=ev_.duration)
                    elif ev_.kind == DISK_FULL:
                        # arm the next save with a mid-write ENOSPC and
                        # push a checkpoint through it immediately: the
                        # store must prune-and-retry, never corrupt the
                        # committed index
                        self.store.inject_disk_full()
                        ev.inc(kind="disk_full")
                        retries_before = self.store.enospc_retries
                        self._save(sync=False)
                        self.store.wait()
                        self.tracer.recovery(
                            "disk_full", step=step,
                            retries=self.store.enospc_retries
                            - retries_before)
            if self.injector is not None and self.injector.consume(step):
                crash = True
            if crash:
                # host failure mid-step: lose work since last checkpoint
                ev.inc(kind="failure")
                self._wasted.inc(step - self._last_ckpt_step)
                self._fail_counts[step] += 1
                streak = self._fail_counts[step]
                backoff = repair * (2 ** (streak - 1))   # escalate on repeat
                if backoff > repair:
                    lost.inc(backoff - repair, cause="backoff")
                    self.tracer.event("coord.backoff", step=step,
                                      streak=streak, wait=backoff)
                if streak >= 2:
                    self._ckpt_before.add(step)
                self.interval.record_failure(virtual_t)
                self.interval.record_repair(backoff * self.step_time_s)
                virtual_t += backoff * self.step_time_s
                self._restore()
                ev.inc(self.store.last_restore_fallbacks,
                       kind="ckpt_fallback")
                ev.inc(kind="restore")
                self.tracer.recovery(
                    "host_crash", step=step, restored_step=self.step,
                    wasted=step - self._last_ckpt_step)
                continue
            # -- one train step (skipping quarantined batches) ---------------
            while self.pipeline.next_index in self._nan_skip:
                self.pipeline.next_index += 1
            bidx = self.pipeline.next_index
            batch = self.pipeline.batch_at(bidx)
            self.pipeline.next_index += 1
            params, opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            if poison:
                loss = float("nan")   # injected: poisoned train-step output
            if not math.isfinite(loss):
                # NaN/Inf guard: reject the update (params/opt keep their
                # pre-step values) and quarantine the batch so checkpoint
                # replay skips it too
                ev.inc(kind="nan_rollback")
                ev.inc(kind="batch_quarantined")
                self._nan_skip.add(bidx)
                self.tracer.recovery("nan_poison", step=step, batch=bidx)
                continue
            self.params, self.opt_state = params, opt_state
            losses.append(loss)
            self.step += 1
            virtual_t += self.step_time_s
            if self.step - self._last_ckpt_step >= self._ckpt_every():
                self._save(sync=False)   # async: only the pointer flip syncs
        self.store.wait()
        return CoordinatorReport(
            steps_completed=self.step,
            failures=int(ev.value(kind="failure")),
            restores=int(ev.value(kind="restore")),
            wasted_steps=int(self._wasted.total()),
            checkpoints=int(self._ckpt_count.total()),
            final_loss=losses[-1] if losses else float("nan"), losses=losses,
            nan_rollbacks=int(ev.value(kind="nan_rollback")),
            skipped_batches=int(ev.value(kind="batch_quarantined")),
            backoff_steps=float(lost.value(cause="backoff")),
            ckpt_fallbacks=int(ev.value(kind="ckpt_fallback")),
            ckpt_corruptions=int(ev.value(kind="ckpt_corrupt")),
            slowdowns=int(ev.value(kind="slowdown")),
            partitions=int(ev.value(kind="net_partition")),
            parked_steps=float(lost.value(cause="partition_park")),
            disk_full_events=int(ev.value(kind="disk_full")),
            enospc_retries=self.store.enospc_retries,
            index_violations=len(self.store.verify_committed()))
