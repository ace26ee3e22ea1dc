"""Partition-tolerant compressed cross-pod gradient exchange (counterpart of
``repro.ft.crosspod``).

Inside a pod, gradients reduce over the fast links (the train step).
*Across* pods the link is ~20x slower, so the pod-level reduction sends
int8 gradients with per-tensor scales and error feedback
(:mod:`repro_torch.optim.grad_compression`): 4x fewer bytes than fp32 with a
bias that vanishes over steps.  The exchange maps 1:1 onto an allgather of
the int8 payloads.

The cross-pod link is also the part of the fabric that actually *fails*:
this module models that with a link-reachability matrix over pods.  A
``net_partition`` fault (:mod:`repro_torch.chaos`) severs the minority
pods' links, splitting the cluster into components:

* the component holding a strict **majority** of pods (the quorum) keeps
  training on its own averaged gradients — pods run replicated
  data-parallel (every pod computes the full global batch, the paper's
  replication heuristic applied at pod granularity), so the quorum average
  *is* the full-cluster average and a 2-of-3 quorum stays exactly on the
  3-pod trajectory;
* minority pods **park**: no compute, no update, error-feedback residuals
  frozen;
* with no majority component (a tie, or everything cut) the whole cluster
  parks — two components may never both advance, which is exactly the
  split-brain failure mode;
* on **heal** the quorum commits a synchronous checkpoint (params +
  optimizer + its error-feedback residual) and every stale pod catches up
  by restoring it through :class:`~repro_torch.ft.checkpoint.
  CheckpointStore`'s fallback-capable ``restore``; the stale pod's own
  residual is *reset* (discarded) and replaced by the quorum's
  checkpointed one, so compression bias accumulated before the partition
  cannot leak across it.

Split-brain is not assumed away — it is *detected*: every advancing pod
fingerprints its post-update parameters each round and
:meth:`PodGradientExchange.check_round_fingerprints` counts any round where
two advancing pods disagree.  ``--chaos-assert`` runs require that counter
to be zero.

Port notes: the pods' gradients come from ``lm.forward_train`` under
autograd (:func:`~repro_torch.distributed.steps.make_grad_fn`) and the
update is the out-of-place ``adamw_update``, so the pods may share their
initial tensors: nothing writes into a tensor a pod holds.  Payloads are
compared on their device (``torch.equal``); :func:`tree_digest` is the one
place that copies every leaf to the host (the pods' fingerprints of a
round are taken a thread a pod, :func:`tree_digests`).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib

import numpy as np
import torch

from ..chaos.faults import DISK_FULL, NET_PARTITION
from ..distributed.sharding import is_dtensor
from ..distributed.steps import make_grad_fn
from ..obs.metrics import MetricsRegistry
from ..obs.trace import NULL_TRACER
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..optim.grad_compression import (compress_tree_with_feedback,
                                      decompress_tree)
from ..tree import flatten, tree_map

from .checkpoint import CheckpointStore

__all__ = ["PodGradientExchange", "ExchangeResult", "PodTrainingCluster",
           "ClusterReport", "tree_digest", "tree_digests"]


def _host_array(leaf) -> np.ndarray:
    """A leaf in host memory, holding the bytes numpy holds for it (bf16
    as its 2-byte pattern); a DTensor read whole (``full_tensor``), so a
    sharded tree hashes as the unsharded one does."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    t = torch.as_tensor(leaf).detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().cpu().numpy()


def tree_digest(tree) -> str:
    """Order-stable sha1 over a tree's leaf bytes (the per-round state
    fingerprint used for split-brain detection); the JAX package's hex on
    the same tree.  Each leaf is hashed from its host copy's buffer."""
    h = hashlib.sha1()
    for _, leaf in flatten(tree):
        h.update(str(tuple(leaf.shape)).encode())
        h.update(_host_array(leaf))
    return h.hexdigest()


def tree_digests(trees: list) -> list[str]:
    """:func:`tree_digest` of each tree, a thread a tree: the pods' host
    copies and sha1s (both release the interpreter lock) overlap."""
    if len(trees) < 2:
        return [tree_digest(t) for t in trees]
    with concurrent.futures.ThreadPoolExecutor(len(trees)) as pool:
        return list(pool.map(tree_digest, trees))


@dataclasses.dataclass(frozen=True)
class ExchangeResult:
    """Outcome of one exchange round.

    ``avg`` is the averaged (decompressed) gradient tree the quorum applies,
    or ``None`` when no component holds a majority and the whole cluster
    parks.  ``fingerprint`` digests ``avg`` (the agreed update)."""

    avg: object | None
    quorum: tuple[int, ...]
    parked: tuple[int, ...]
    fingerprint: str | None


class PodGradientExchange:
    """Quorum-gated gradient exchange over an explicit link matrix."""

    def __init__(self, n_pods: int):
        self.n_pods = n_pods
        self.residuals = [None] * n_pods   # error-feedback state per pod
        self.bytes_sent_fp32 = 0
        self.bytes_sent_int8 = 0
        # link-reachability matrix: links[i, j] == the path i <-> j is up
        self.links = np.ones((n_pods, n_pods), bool)
        self._cut: set[int] = set()
        self.round_no = 0
        self.parked_pod_rounds = 0
        self.split_brain_divergences = 0
        self.fingerprint_log: list[tuple[int, str]] = []

    # -- link topology --------------------------------------------------------
    def partition(self, minority) -> tuple[int, ...]:
        """Sever every link of each ``minority`` pod (conservative model:
        a cut pod is fully isolated, including from other cut pods)."""
        cut = tuple(sorted({int(p) % self.n_pods for p in minority}))
        for p in cut:
            self._cut.add(p)
            self.links[p, :] = False
            self.links[:, p] = False
            self.links[p, p] = True
        return cut

    def restore_pods(self, pods) -> None:
        """Heal: re-attach ``pods`` to every pod that is not itself cut."""
        for p in pods:
            self._cut.discard(int(p))
        for p in (int(q) for q in pods):
            for q in range(self.n_pods):
                up = q not in self._cut
                self.links[p, q] = self.links[q, p] = up
            self.links[p, p] = True

    def components(self) -> list[tuple[int, ...]]:
        """Connected components of the link matrix (BFS)."""
        seen: set[int] = set()
        out = []
        for start in range(self.n_pods):
            if start in seen:
                continue
            comp = {start}
            stack = [start]
            while stack:
                i = stack.pop()
                for j in range(self.n_pods):
                    if j not in comp and self.links[i, j]:
                        comp.add(j)
                        stack.append(j)
            seen |= comp
            out.append(tuple(sorted(comp)))
        return out

    def current_quorum(self) -> tuple[int, ...] | None:
        """The unique component holding a strict majority of pods, if any."""
        for comp in self.components():
            if 2 * len(comp) > self.n_pods:
                return comp
        return None

    # -- error-feedback residuals ---------------------------------------------
    def _init_residuals(self, pod: int, grads) -> None:
        if self.residuals[pod] is None:
            self.residuals[pod] = tree_map(
                lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)

    def reset_residual(self, pod: int) -> None:
        """Discard a pod's error-feedback state (membership change: a
        rejoining or replacement pod must not carry stale compression
        bias)."""
        if self.residuals[pod] is not None:
            self.residuals[pod] = tree_map(torch.zeros_like,
                                           self.residuals[pod])

    def set_residual(self, pod: int, residual) -> None:
        """Adopt a residual (the quorum's checkpointed one, at catch-up)."""
        self.residuals[pod] = residual

    # -- the exchange ---------------------------------------------------------
    @staticmethod
    def _payloads_equal(a, b) -> bool:
        """Two (quantized, scales) payloads hold the same bits."""
        la = [t for tree in a for _, t in flatten(tree)]
        lb = [t for tree in b for _, t in flatten(tree)]
        return len(la) == len(lb) and all(
            torch.equal(x, y) for x, y in zip(la, lb))

    def round(self, pod_grads: list, *,
              with_fingerprint: bool = True) -> ExchangeResult:
        """One exchange round.  ``pod_grads[p]`` is pod ``p``'s gradient
        tree (entries for parked pods may be ``None`` — they are never
        read).  Quorum pods compress-with-feedback, allgather, and average;
        everyone else parks.

        ``with_fingerprint=False`` skips the sha1 digest of the averaged
        update — :func:`tree_digest` copies every leaf to the host, so
        sampled rounds (``PodTrainingCluster.fingerprint_every``) leave the
        result's ``fingerprint`` as ``None``."""
        assert len(pod_grads) == self.n_pods
        quorum = self.current_quorum()
        self.round_no += 1
        parked = tuple(p for p in range(self.n_pods)
                       if quorum is None or p not in quorum)
        self.parked_pod_rounds += len(parked)
        if quorum is None:
            return ExchangeResult(avg=None, quorum=(), parked=parked,
                                  fingerprint=None)
        payloads = []
        for p in quorum:
            g = pod_grads[p]
            self._init_residuals(p, g)
            q, s, r = compress_tree_with_feedback(g, self.residuals[p])
            self.residuals[p] = r
            payloads.append((q, s))
            for _, leaf in flatten(q):
                self.bytes_sent_int8 += leaf.numel()     # int8: 1 B each
                self.bytes_sent_fp32 += leaf.numel() * 4
        # Replicated-agreement fast path: when every member ships the same
        # bytes (replicated data-parallel with synchronized residuals), the
        # average IS that common value — independent of quorum size, which
        # is what keeps a 2-pod quorum bit-exact on the 3-pod trajectory.
        if all(self._payloads_equal(payloads[0], pl) for pl in payloads[1:]):
            avg = decompress_tree(*payloads[0])
        else:
            trees = [decompress_tree(q, s) for q, s in payloads]
            avg = tree_map(lambda *xs: sum(xs) / len(xs), *trees)
        return ExchangeResult(
            avg=avg, quorum=quorum, parked=parked,
            fingerprint=tree_digest(avg) if with_fingerprint else None)

    def exchange(self, pod_grads: list):
        """Fully-connected compatibility wrapper: returns the averaged
        (decompressed) gradient tree every pod ends up with."""
        res = self.round(list(pod_grads))
        if res.avg is None:
            raise RuntimeError(
                "no quorum: the cluster is partitioned with no majority "
                "component; all pods are parked")
        return res.avg

    # -- split-brain detection ------------------------------------------------
    def check_round_fingerprints(self, rnd: int, pod_fps: dict[int, str]
                                 ) -> bool:
        """Record the advancing pods' post-update state fingerprints for one
        round.  Any disagreement is a split-brain divergence — a hard
        invariant violation under ``--chaos-assert``."""
        distinct = sorted(set(pod_fps.values()))
        if distinct:
            self.fingerprint_log.append((rnd, distinct[0]))
        if len(distinct) > 1:
            self.split_brain_divergences += 1
            return False
        return True

    @property
    def compression_ratio(self) -> float:
        return self.bytes_sent_fp32 / max(self.bytes_sent_int8, 1)


@dataclasses.dataclass
class ClusterReport:
    steps_completed: int
    rounds: int
    partitions: int
    parked_pod_rounds: int
    heals: int
    catchups: int
    checkpoints: int
    split_brain_divergences: int
    disk_full_events: int
    enospc_retries: int
    index_violations: int
    final_loss: float
    losses: list
    fingerprints_taken: int = 0
    fingerprints_skipped: int = 0


class PodTrainingCluster:
    """``n_pods`` replicated data-parallel pods training through the
    partition-tolerant exchange.

    Every pod holds its own params/optimizer copy; each round every
    reachable pod computes the *global* batch's gradients (pod-level
    replication: the batches are bit-identical anywhere, see
    :mod:`repro_torch.data`), the quorum averages them through the
    compressed exchange and applies AdamW, minority pods park.
    ``net_partition`` chaos events sever links for their ``duration``; at
    heal the quorum commits a synchronous checkpoint that stale pods
    restore (params, optimizer, *and* the quorum's error-feedback residual
    — the stale residual is reset so compression bias cannot leak across
    the partition).  ``disk_full`` events arm the shared
    :class:`~repro_torch.ft.checkpoint.CheckpointStore` with a mid-save
    ENOSPC.

    Two time axes: *rounds* are wall clock (chaos events fire on them);
    *applied steps* count committed updates and index the data pipeline, so
    a whole-cluster park consumes wall clock but never skips a batch — a
    partitioned-then-healed run lands on the exact batch sequence of a
    fault-free run at equal step count.
    """

    def __init__(self, *, cfg, params, pipeline, store: CheckpointStore,
                 n_pods: int = 3, opt_cfg: AdamWConfig | None = None,
                 q_chunk: int = 16, xent_chunk: int = 16,
                 ckpt_every: int = 4, chaos=None,
                 fingerprint_every: int = 1, tracer=None,
                 registry: MetricsRegistry | None = None):
        self.cfg = cfg
        self.n_pods = n_pods
        self.pipeline = pipeline
        self.store = store
        self.chaos = chaos   # repro_torch.chaos.ChaosEngine | None
        self.ckpt_every = max(1, int(ckpt_every))
        # split-brain fingerprints sample every N applied steps; 1 = every
        # step (the --chaos-assert setting).  tree_digest copies every param
        # leaf to the host, so sampling is the steady-state default.
        self.fingerprint_every = max(1, int(fingerprint_every))
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.registry = registry if registry is not None else MetricsRegistry()
        self._fp = self.registry.counter(
            "crosspod_fingerprints_total",
            "split-brain fingerprint rounds by status (taken vs sampled "
            "away)", ("status",))
        self.opt_cfg = opt_cfg or AdamWConfig(lr=1e-3)
        self._grad = make_grad_fn(cfg, q_chunk=q_chunk, xent_chunk=xent_chunk)
        self.device = flatten(params)[0][1].device
        # the pods share the initial tensors: every update is out of place
        self.params = [params for _ in range(n_pods)]
        self.opt = [adamw_init(params) for _ in range(n_pods)]
        self.exchange = PodGradientExchange(n_pods)
        resid0 = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        for p in range(n_pods):
            self.exchange.residuals[p] = resid0
        self.pod_step = [0] * n_pods      # applied steps each pod has seen
        self.applied = 0                  # quorum-committed update count
        self.round_no = 0                 # wall-clock rounds
        self._heal_at: dict[int, set[int]] = {}
        self._counters = dict(partitions=0, heals=0, catchups=0,
                              checkpoints=0, disk_full_events=0)

    # -- checkpoint / catch-up ------------------------------------------------
    def _commit(self) -> bool:
        """The quorum lead commits params + opt + its residual (the whole
        synchronized state a rejoining pod needs).  The lead is the member
        with the most applied steps — a pod that just rejoined stale must
        never author the commit its peers catch up from."""
        quorum = self.exchange.current_quorum()
        if quorum is None:
            return False
        lead = max(quorum, key=lambda p: (self.pod_step[p], -p))
        step = self.pod_step[lead]
        with self.tracer.span("crosspod.commit", step=step, lead=lead):
            self.store.save(step, {
                "params": self.params[lead], "opt": self.opt[lead],
                "residual": self.exchange.residuals[lead],
            }, extra={"applied": step}, sync=True)
        self._counters["checkpoints"] += 1
        return True

    def _heal(self, stale: list[int]) -> None:
        with self.tracer.span("crosspod.heal", pods=stale,
                              round=self.round_no) as sp:
            self.exchange.restore_pods(stale)
            self._counters["heals"] += 1
            behind = [p for p in stale if self.pod_step[p] < self.applied]
            sp.set(behind=behind)
            if not behind or self.exchange.current_quorum() is None:
                return
            # quorum syncs a checkpoint of its *current* state, then each
            # stale pod restores it via the fallback-capable CheckpointStore
            # path
            self._commit()
            for p in behind:
                like = {"params": self.params[p], "opt": self.opt[p],
                        "residual": self.exchange.residuals[p]}
                tree, _, extra = self.store.restore(like)
                self.params[p], self.opt[p] = tree["params"], tree["opt"]
                # stale residual reset + quorum residual adopted: no
                # compression-bias carryover across the partition
                self.exchange.reset_residual(p)
                self.exchange.set_residual(p, tree["residual"])
                self.pod_step[p] = int(extra["applied"])
                self._counters["catchups"] += 1
                self.tracer.event("crosspod.catchup", pod=p,
                                  to_step=self.pod_step[p])
            self.tracer.recovery("net_partition", pods=stale,
                                 caught_up=len(behind))

    # -- chaos ----------------------------------------------------------------
    def _apply_chaos(self, rnd: int) -> None:
        for ev in self.chaos.events_at(rnd):
            if ev.kind == NET_PARTITION:
                minority = self.exchange.partition(ev.targets or (0,))
                self._counters["partitions"] += 1
                heal = rnd + max(1, ev.duration)
                self._heal_at.setdefault(heal, set()).update(minority)
                self.tracer.event("crosspod.partition", round=rnd,
                                  minority=list(minority), heal_round=heal)
            elif ev.kind == DISK_FULL:
                self.store.inject_disk_full()
                self._counters["disk_full_events"] += 1
                # strike now: force a commit through the armed store (the
                # ENOSPC prune-and-retry path runs under the quorum's feet)
                retries_before = self.store.enospc_retries
                self._commit()
                self.tracer.recovery(
                    "disk_full", round=rnd,
                    retries=self.store.enospc_retries - retries_before)
            # every other kind is owned by the coordinator / serve layers

    # -- main loop ------------------------------------------------------------
    def run(self, n_steps: int, *, max_rounds: int | None = None
            ) -> ClusterReport:
        max_rounds = max_rounds or 4 * n_steps + 64
        losses: list[float] = []
        self._commit()   # round-0 partitions must have a commit to land on
        while self.applied < n_steps and self.round_no < max_rounds:
            rnd = self.round_no
            if rnd in self._heal_at:
                self._heal(sorted(self._heal_at.pop(rnd)))
            if self.chaos is not None:
                self._apply_chaos(rnd)
            quorum = self.exchange.current_quorum()
            grads: list = [None] * self.n_pods
            loss = None
            if quorum is not None:
                batch = {k: torch.as_tensor(v).to(self.device) for k, v in
                         self.pipeline.batch_at(self.applied).items()}
                for p in quorum:
                    loss_p, grads[p] = self._grad(self.params[p], batch)
                    if loss is None:
                        loss = float(loss_p)
            # sampled split-brain detection: tree_digest copies every leaf
            # to the host a pod, so steady-state runs take it every N
            # applied steps (N=1 under --chaos-assert = the exact check)
            take_fp = self.applied % self.fingerprint_every == 0
            res = self.exchange.round(grads, with_fingerprint=take_fp)
            self.round_no += 1
            if res.avg is None:
                self.tracer.event("crosspod.park", round=rnd)
                continue   # whole-cluster park: wall clock lost, no batch
            for p in res.quorum:
                self.params[p], self.opt[p], _ = adamw_update(
                    self.opt_cfg, self.params[p], res.avg, self.opt[p])
                self.pod_step[p] = self.applied + 1
            losses.append(loss)
            if take_fp:
                self._fp.inc(status="taken")
                fps = tree_digests([self.params[p] for p in res.quorum])
                self.exchange.check_round_fingerprints(
                    self.applied, dict(zip(res.quorum, fps)))
            else:
                self._fp.inc(status="skipped")
            self.applied += 1
            if self.applied % self.ckpt_every == 0:
                self._commit()
        # drain pending heals: the run returns a fully-connected cluster
        # (a partition still open at the target step heals now and its
        # stale pods catch up before the final report)
        while self._heal_at:
            rnd = min(self._heal_at)
            self._heal(sorted(self._heal_at.pop(rnd)))
        return ClusterReport(
            steps_completed=self.applied, rounds=self.round_no,
            partitions=self._counters["partitions"],
            parked_pod_rounds=self.exchange.parked_pod_rounds,
            heals=self._counters["heals"],
            catchups=self._counters["catchups"],
            checkpoints=self._counters["checkpoints"],
            split_brain_divergences=self.exchange.split_brain_divergences,
            disk_full_events=self._counters["disk_full_events"],
            enospc_retries=self.store.enospc_retries,
            index_violations=len(self.store.verify_committed()),
            final_loss=losses[-1] if losses else float("nan"),
            losses=losses,
            fingerprints_taken=int(self._fp.value(status="taken")),
            fingerprints_skipped=int(self._fp.value(status="skipped")))
