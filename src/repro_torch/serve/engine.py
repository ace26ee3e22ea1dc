"""Slot-based continuous-batching decode engine with fault tolerance.

Counterpart of ``repro.serve.engine`` on the port's PyTorch model.  The
engine holds one batched cache on its device and updates it in place; the
weights are cast to the compute dtype once at construction.  Dense, MoE,
encoder-decoder and image-prefix prompts prefill into their power-of-two
bucket; the recurrent families (RWKV-6, RG-LRU hybrid) prefill at the exact
prompt length, since their state would take every padded position as an
update.  A request of the encoder-decoder carries its frame embeddings and
one of the image family its image embeddings: prefill consumes them (the
image rows take the first positions), and the slot's cache row then holds
what they gave (the cross-attention K/V; the image rows' K/V), so
snapshots and resumes carry it.

The serving counterpart of the CheckpointHEFT runtime (paper Algorithm 3):

* a fixed pool of decode *slots* (n_workers x slots_per_worker) advances one
  token per engine step via a single ``make_serve_step`` call with a
  per-slot position vector — new requests prefill into freed slots while
  live requests keep decoding (no static-batch barrier);
* each admitted request runs ``repCount`` copies on distinct workers
  (:class:`~repro_torch.serve.replicas.ReplicaPolicy`, Algorithm 1); the first
  copy to emit its full budget wins, siblings are cancelled (their tokens
  are the paper's late-replica wastage);
* a worker failure kills all its slots (Algorithm 3 Case 1); only when the
  *last* copy of a request dies is it resubmitted (steps 14-15/25-26) —
  resuming from its latest decode snapshot when one exists (steps 22-23),
  else re-prefilling from scratch (steps 16-21);
* snapshots are taken every ``lambda`` generated tokens per slot, with
  ``lambda`` re-derived online by :class:`repro_torch.ft.interval.DynamicInterval`
  from observed failures (Lemma 3.1).

Chaos hardening (``repro_torch.chaos`` serving-side recovery paths): a
:class:`~repro_torch.chaos.ChaosEngine` passed as ``chaos=`` injects the wider
fault taxonomy each tick — ``host_crash`` / ``capacity_loss`` take workers
down (the latter for its own MTTR window), ``slowdown`` stalls a worker's
slots without losing state (they are masked out of the batched decode until
the straggler recovers, then resume bit-identically), and
``snapshot_corrupt`` flips bytes in a stored decode snapshot.  Recovery:
snapshots are checksum-verified before a resume — a corrupt one is
quarantined and the request re-prefills from scratch; under capacity loss
the admission queue runs **deadline-aware load shedding** (degraded-mode
serving): queued hedge copies collapse to one, and a queued request that
provably cannot meet its deadline even if admitted this very tick is shed,
lowest request class (priority, then slack) first.  A request with a live
copy past its first token is *never* shed — the ``past_first_token_drops``
metric is the tripwire proving it.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from ..chaos import faults
from ..distributed.params import init_cache_sharded
from ..distributed.sharding import host_view, use_rules
from ..distributed.steps import make_prefill_step, make_serve_step
from ..ft.interval import DynamicInterval
from ..models import lm
from ..models.config import ModelConfig
from ..obs.trace import NULL_TRACER

from .metrics import ServeMetrics
from .queue import AdmissionQueue, Request, WorkItem, prompt_bucket
from .replicas import ReplicaPolicy, WorkerPool, uniform_policy
from .snapshot import (DecodeSnapshot, SnapshotStore, cache_batch_axes,
                       slot_get, slot_set)

__all__ = ["EngineConfig", "ServeEngine", "engine_supported",
           "prefill_inputs"]


def prefill_inputs(cfg: ModelConfig, req: Request, tokens: np.ndarray,
                   device) -> dict:
    """A one-request prefill batch on ``device``: ``tokens`` (1, S) int32,
    with the request's frames (encoder-decoder) or image embeddings (image
    family) as (1, T, D) fp32."""
    batch = {"tokens": torch.from_numpy(tokens).to(device)}
    if cfg.is_encdec:
        batch["frames"] = torch.as_tensor(
            np.asarray(req.frames, np.float32))[None].to(device)
    if cfg.n_image_tokens:
        batch["image_embeds"] = torch.as_tensor(
            np.asarray(req.image_embeds, np.float32))[None].to(device)
    return batch


def engine_supported(cfg: ModelConfig) -> tuple[bool, str]:
    """Whether the port's engine can drive ``cfg``: the families the
    port's model runs (``lm.check_family``), with the reason if not."""
    try:
        lm.check_family(cfg)
    except ValueError as e:
        return False, str(e)
    return True, ""


@dataclasses.dataclass
class EngineConfig:
    cache_len: int = 128
    snapshots_enabled: bool = True
    snapshot_lambda: float | None = None   # None -> DynamicInterval (Lemma 3.1)
    snapshot_gamma: float = 1.0            # per-snapshot cost, token-steps
    prior_mtbf_steps: float = 200.0
    lam_min: float = 2.0
    lam_max: float = 256.0
    # completed requests retained for ``output()`` before FIFO eviction of
    # their request / completed / snapshot entries (bounds engine host state
    # for a long-running service)
    retain_completed: int = 4096
    # degraded mode: deadline-aware admission-queue load shedding under
    # capacity loss (hedge copies collapse first, then provably-late
    # requests are shed lowest-class-first)
    shed_enabled: bool = True
    # queue-length-priced admission: fresh arrivals are rejected with a
    # retry_after hint once queue depth crosses this bound, so the queue
    # stays bounded under sustained capacity loss (None = unbounded)
    max_queue_depth: int | None = None


@dataclasses.dataclass
class _Slot:
    sid: int
    busy: bool = False
    rid: int = -1
    copy_id: int = 0
    pos: int = 0                 # absolute position of the next decode write
    last_token: int = 0
    max_new: int = 0
    since_snapshot: int = 0
    req: Request | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig | None = None, *,
                 pool: WorkerPool, policy: ReplicaPolicy | None = None,
                 params=None, metrics: ServeMetrics | None = None,
                 chaos=None, seed: int = 0, tracer=None, device="cuda",
                 mesh=None):
        ok, why = engine_supported(cfg)
        if not ok:
            raise ValueError(f"{cfg.name}: {why}")
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        if cfg.rglru and self.ecfg.cache_len < cfg.window:
            raise ValueError(
                f"{cfg.name}: cache_len {self.ecfg.cache_len} < local-"
                f"attention window {cfg.window}; the rolling KV ring and the "
                f"decode slot index (pos % window) would disagree")
        if cfg.is_encdec and self.ecfg.cache_len > cfg.max_decode_len:
            raise ValueError(
                f"{cfg.name}: cache_len {self.ecfg.cache_len} exceeds the "
                f"learned decoder position table ({cfg.max_decode_len})")
        self.device = torch.device(device)
        self.pool = pool
        self.chaos = chaos   # repro_torch.chaos.ChaosEngine | None
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.shed: set[int] = set()   # rids dropped in degraded mode
        self.policy = policy or uniform_policy(1)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = lm.init_params(cfg, gen, cast=True)
        # one compute-dtype copy, cast once (JAX casts at every use); params
        # already in that form (``init_params(..., cast=True)``) are not
        # copied
        self.params = lm.cast_params(params, cfg)
        self.metrics = metrics or ServeMetrics()
        self.queue = AdmissionQueue(max_depth=self.ecfg.max_queue_depth,
                                    drain_rate=max(pool.n_slots, 1))
        self.rejected: dict[int, int] = {}   # rid -> retry_after hint
        self.store = SnapshotStore()
        self.slots = [_Slot(sid) for sid in range(pool.n_slots)]
        self.active: dict[int, set[int]] = {}      # rid -> live slot ids
        self.completed: dict[int, list[int]] = {}  # rid -> delivered tokens
        self.requests: dict[int, Request] = {}
        self._completed_order: collections.deque[int] = collections.deque()
        self.step_no = 0
        self.interval = DynamicInterval(
            gamma_s=self.ecfg.snapshot_gamma, lam_min=self.ecfg.lam_min,
            lam_max=self.ecfg.lam_max,
            prior_mtbf_s=self.ecfg.prior_mtbf_steps)

        cache_len = self.ecfg.cache_len
        self.mesh = mesh
        # bf16 cache whatever the compute dtype, as in JAX; on a mesh laid
        # out by cache_specs
        self.cache = (lm.init_cache(cfg, pool.n_slots, cache_len,
                                    device=self.device) if mesh is None else
                      init_cache_sharded(cfg, pool.n_slots, cache_len, mesh))
        self.axes = cache_batch_axes(cfg, cache_len)
        self._serve = make_serve_step(cfg, cache_axes=self.axes)
        self._prefill_step = make_prefill_step(cfg, cache_len)
        # host wall seconds and calls of prefill / batched decode; both end
        # in a device-to-host read, so the host clock covers the device work
        self.timing = {"prefill_s": 0.0, "prefill_calls": 0,
                       "decode_s": 0.0, "decode_calls": 0}

    # -- submission ----------------------------------------------------------
    def submit(self, req: Request) -> int:
        """Enqueue a request; returns its replication count (0 = rejected on
        arrival by the queue-depth bound, with the retry-after hint recorded
        in ``self.rejected[rid]`` and the ``rejected_on_arrival`` metric)."""
        bucket = prompt_bucket(req.prompt_len)
        offset = self.cfg.n_image_tokens
        if offset + bucket + req.max_new_tokens > self.ecfg.cache_len:
            raise ValueError(
                f"request {req.rid}: image tokens {offset} + bucket {bucket} "
                f"+ max_new {req.max_new_tokens} exceeds cache_len "
                f"{self.ecfg.cache_len}")
        if self.cfg.is_encdec and req.frames is None:
            raise ValueError(
                f"request {req.rid}: {self.cfg.name} needs per-request "
                f"encoder frames")
        if offset and req.image_embeds is None:
            raise ValueError(
                f"request {req.rid}: {self.cfg.name} needs per-request "
                f"image embeds")
        self.metrics.register(req)
        rep = self.policy.rep_for(req)
        retry_after = self.queue.admit(
            [WorkItem(req, copy_id=k) for k in range(rep)])
        if retry_after is not None:
            self.rejected[req.rid] = retry_after
            self.metrics.mark_rejected(req.rid, self.step_no, retry_after)
            self.tracer.event("serve.reject", rid=req.rid,
                              retry_after=retry_after)
            return 0
        self.requests[req.rid] = req
        self.tracer.event("serve.admit", rid=req.rid, rep=rep)
        return rep

    # -- chaos injection (repro_torch.chaos taxonomy) ------------------------------
    def _apply_chaos(self, t: int) -> None:
        for ev in self.chaos.events_at(t):
            if ev.kind == faults.HOST_CRASH:
                for wid in (ev.targets or (0,)):
                    self.pool.force_failure(t, wid % self.pool.n_workers)
            elif ev.kind == faults.CAPACITY_LOSS:
                wids = sorted({w % self.pool.n_workers
                               for w in (ev.targets or (0,))})
                self.pool.force_outage(t, wids, ev.duration)
                self.metrics.capacity_events += 1
            elif ev.kind == faults.SLOWDOWN:
                for wid in (ev.targets or (0,)):
                    self.pool.slow(wid % self.pool.n_workers,
                                   t + ev.duration)
                self.metrics.slowdown_events += 1
            elif ev.kind == faults.SNAPSHOT_CORRUPT:
                self.metrics.snapshots_corrupted += \
                    self.store.corrupt(ev.seed)
            # ckpt_corrupt / nan_poison are training-side faults: no-op here

    # -- failures (Algorithm 3 Case 1) ---------------------------------------
    def _on_worker_failures(self, t: int) -> None:
        for wid in self.pool.step_failures(t):
            self.metrics.failures += 1
            self.tracer.event("serve.worker_failure", worker=wid, step=t)
            self.interval.record_failure(float(t))
            self.interval.record_repair(float(self.pool.mttr_steps))
            for sid in self.pool.slots_of(wid):
                slot = self.slots[sid]
                if slot.busy:
                    self._kill_copy(slot, resubmit_if_last=True)

    def _release(self, slot: _Slot) -> None:
        """Free a slot and scrub its decode registers: a freed slot's stale
        ``rid``/``pos``/``last_token`` must never reach the serve step (its
        cache row is additionally masked out of the batched write)."""
        slot.busy = False
        slot.rid = -1
        slot.copy_id = 0
        slot.pos = 0
        slot.last_token = 0
        slot.max_new = 0
        slot.since_snapshot = 0
        slot.req = None
        slot.tokens = []

    def _kill_copy(self, slot: _Slot, *, resubmit_if_last: bool) -> None:
        rid = slot.rid
        had_tokens = bool(slot.tokens)
        live = self.active.get(rid, set())
        live.discard(slot.sid)
        if not live:
            self.active.pop(rid, None)   # prune: empty sets must not linger
        self._release(slot)
        if rid in self.shed:
            # tripwire: shedding must never have dropped a request that was
            # already past its first token (the guard in _shed forbids it)
            if had_tokens:
                self.metrics.past_first_token_drops += 1
            return
        if not resubmit_if_last or rid in self.completed:
            return
        # resubmit only when every copy has failed AND none is still queued
        if not live and rid not in self.queue.pending_rids():
            snap = (self.store.get(rid)
                    if self.ecfg.snapshots_enabled else None)
            self.queue.submit(WorkItem(self.requests[rid], copy_id=0,
                                       snapshot=snap, is_resubmission=True))
            self.metrics.resubmissions += 1
            self.tracer.recovery("host_crash", rid=rid,
                                 from_snapshot=snap is not None)

    # -- degraded mode: deadline-aware load shedding -------------------------
    def _min_finish_step(self, item: WorkItem, t: int) -> int:
        """Earliest step this item could complete if admitted at ``t``.

        A fresh prefill emits its first token at the admit tick AND the slot
        joins the same tick's batched decode (two tokens by end of step
        ``t``); a snapshot resume re-enters with ``e`` tokens banked and
        decodes at ``t``.  The bound must never overshoot — shedding a
        request that could still have met its deadline is forbidden."""
        emitted = len(item.snapshot.tokens) if item.snapshot is not None else 0
        need = item.req.max_new_tokens
        if emitted >= need:
            return t
        return t + need - max(emitted, 1) - 1

    @staticmethod
    def _shed_rank(req: Request):
        """Shedding order: lowest request class first — priority ascending,
        then tightest deadline slack (the least likely to finish)."""
        slack = (req.deadline - req.arrival - req.total_work
                 if req.deadline is not None else float("inf"))
        return (req.priority, slack)

    def _shed(self, t: int) -> None:
        if not self.ecfg.shed_enabled or not len(self.queue):
            return
        # capacity loss -> stop paying for hedges: collapse queued copies
        up_slots = sum(self.pool.slots_per_worker
                       for w in range(self.pool.n_workers)
                       if self.pool.is_up(w, t))
        busy = sum(s.busy for s in self.slots)
        if (up_slots < self.pool.n_slots
                and len(self.queue) > max(up_slots - busy, 0)):
            self.metrics.hedge_drops += self.queue.drop_hedges()
        # shed requests that provably cannot meet their deadline even if
        # admitted this very tick, lowest request class first
        doomed: dict[int, Request] = {}
        for item in self.queue.items():
            dl = item.req.deadline
            if dl is None or self._min_finish_step(item, t) <= dl:
                continue
            doomed.setdefault(item.req.rid, item.req)
        for rid, req in sorted(doomed.items(),
                               key=lambda kv: self._shed_rank(kv[1])):
            if self.active.get(rid):
                # never shed a request with a live copy — once past its
                # first token it either completes or is resubmitted
                continue
            self.queue.cancel(rid)
            self.shed.add(rid)
            self.metrics.mark_shed(rid, t)
            self.tracer.recovery("capacity_loss", rid=rid, action="shed",
                                 step=t)

    # -- admission into freed slots ------------------------------------------
    def _admit(self, t: int) -> None:
        for slot in self.slots:
            wid = self.pool.worker_of(slot.sid)
            if (slot.busy or not self.pool.is_up(wid, t)
                    or self.pool.is_slow(wid, t)):
                continue

            def admissible(item: WorkItem, _wid=wid) -> bool:
                rid = item.req.rid
                if (rid in self.completed or rid in self.shed
                        or item.req.arrival > t):
                    return False
                others = self.active.get(rid, set())
                return all(self.pool.worker_of(s) != _wid for s in others)

            item = self.queue.pop(admissible)
            if item is not None:
                self._start(slot, item, t)

    def _prefill_batch(self, req: Request, seq: int) -> dict:
        padded = np.zeros((1, seq), np.int32)
        padded[0, :req.prompt_len] = np.asarray(req.prompt, np.int32)
        return prefill_inputs(self.cfg, req, padded, self.device)

    def _start(self, slot: _Slot, item: WorkItem, t: int) -> None:
        req = item.req
        slot.busy = True
        slot.rid = req.rid
        slot.copy_id = item.copy_id
        slot.max_new = req.max_new_tokens
        slot.req = req
        slot.since_snapshot = 0
        self.active.setdefault(req.rid, set()).add(slot.sid)
        snap: DecodeSnapshot | None = item.snapshot
        if snap is not None and not self.store.verify(snap):
            # checksum mismatch: quarantine the snapshot and fall back to a
            # full re-prefill — never resume from garbage decode state
            self.metrics.snapshot_restore_failures += 1
            self.store.drop(snap.rid)
            self.tracer.recovery("snapshot_corrupt", rid=req.rid,
                                 action="reprefill")
            snap = None
        if snap is not None:
            slot_set(self.cache, self.axes, slot.sid, snap.cache_row)
            slot.pos = snap.pos
            slot.tokens = list(snap.tokens)
            slot.last_token = snap.last_token
            self.metrics.restores += 1
            self.tracer.event("serve.resume", rid=req.rid, pos=snap.pos,
                              banked=len(snap.tokens))
        else:
            p = req.prompt_len
            offset = self.cfg.n_image_tokens
            # recurrent state treats every position as a state update, so
            # pad positions are not maskable after the fact: prefill at the
            # exact prompt length instead of the padded bucket
            exact = self.cfg.rwkv or self.cfg.rglru
            seq = p if exact else prompt_bucket(p)
            t0 = time.perf_counter()
            with self.tracer.span("serve.prefill", rid=req.rid, seq=seq,
                                  step=t):
                logits, row1 = self._prefill_step(
                    self.params, self._prefill_batch(req, seq),
                    torch.tensor([offset + p - 1], device=self.device))
            slot_set(self.cache, self.axes, slot.sid,
                     {k: v.select(self.axes[k], 0) for k, v in row1.items()})
            # host argmax on the fp32 logits (first maximum, as np.argmax)
            tok = int(torch.argmax(host_view(logits)[0].cpu()))
            self.timing["prefill_s"] += time.perf_counter() - t0
            self.timing["prefill_calls"] += 1
            slot.pos = offset + p
            slot.tokens = [tok]
            slot.last_token = tok
            self.metrics.prefill_tokens += seq + offset
        if len(slot.tokens) >= slot.max_new:
            self._finish(slot, t)

    # -- one batched decode step ---------------------------------------------
    def _decode(self, t: int) -> None:
        # straggler slots stall: masked out of the batched write, no token
        # progress, state intact — they resume bit-identically on recovery
        stalled = {s.sid for s in self.slots if s.busy and
                   self.pool.is_slow(self.pool.worker_of(s.sid), t)}
        busy = [s for s in self.slots
                if s.busy and s.sid not in stalled]
        if not busy:
            return
        toks = np.zeros((len(self.slots), 1), np.int32)
        poss = np.zeros((len(self.slots),), np.int32)
        live = np.zeros((len(self.slots),), bool)
        for s in self.slots:
            toks[s.sid, 0] = s.last_token
            poss[s.sid] = s.pos
            live[s.sid] = s.busy and s.sid not in stalled
        t0 = time.perf_counter()
        with self.tracer.span("serve.decode", track="serve", step=t,
                              live=len(busy), stalled=len(stalled)):
            nxt, _, self.cache = self._serve(
                self.params, self.cache,
                torch.from_numpy(toks).to(self.device),
                torch.from_numpy(poss).to(self.device),
                torch.from_numpy(live).to(self.device))
        nxt = host_view(nxt).cpu().numpy()
        self.timing["decode_s"] += time.perf_counter() - t0
        self.timing["decode_calls"] += 1
        for s in busy:
            tok = int(nxt[s.sid, 0])
            s.tokens.append(tok)
            s.last_token = tok
            s.pos += 1
            s.since_snapshot += 1
            self.metrics.decode_tokens += 1
        for s in busy:
            if s.busy and len(s.tokens) >= s.max_new:
                self._finish(s, t)

    def _finish(self, slot: _Slot, t: int) -> None:
        rid = slot.rid
        self.completed[rid] = list(slot.tokens[:slot.max_new])
        self.metrics.complete(rid, t)
        self.tracer.event("serve.finish", rid=rid, step=t,
                          tokens=slot.max_new)
        self.queue.cancel(rid)
        self.store.drop(rid)
        for sid in sorted(self.active.get(rid, set())):
            # late replicas: their tokens become wastage
            self._release(self.slots[sid])
        self.active.pop(rid, None)
        self._completed_order.append(rid)
        while len(self._completed_order) > self.ecfg.retain_completed:
            old = self._completed_order.popleft()
            self.completed.pop(old, None)
            self.requests.pop(old, None)
            self.store.drop(old)

    # -- snapshot cadence (Lemma 3.1 online) ---------------------------------
    def _snapshot_every(self) -> int:
        if self.ecfg.snapshot_lambda is not None:
            return max(1, int(round(self.ecfg.snapshot_lambda)))
        return max(1, int(round(self.interval.current_lambda())))

    def _take_snapshots(self, t: int) -> None:
        if not self.ecfg.snapshots_enabled:
            return
        cadence = self._snapshot_every()
        for s in self.slots:
            if s.busy and s.since_snapshot >= cadence:
                row = slot_get(self.cache, self.axes, s.sid)
                self.store.save(DecodeSnapshot(
                    rid=s.rid, pos=s.pos, tokens=list(s.tokens),
                    last_token=s.last_token, cache_row=row, step=t))
                self.metrics.snapshots += 1
                self.metrics.snapshot_overhead_tokens += \
                    self.ecfg.snapshot_gamma
                self.tracer.event("serve.snapshot", rid=s.rid, pos=s.pos,
                                  step=t)
                s.since_snapshot = 0

    # -- main loop -----------------------------------------------------------
    def step(self) -> None:
        """One engine tick (inside the mesh's rules when the engine has
        one)."""
        if self.mesh is None:
            return self._step()
        with use_rules(self.mesh):
            return self._step()

    def _step(self) -> None:
        t = self.step_no
        if self.chaos is not None:
            self._apply_chaos(t)
        self._on_worker_failures(t)
        self._shed(t)
        self._admit(t)
        self._decode(t)
        self._take_snapshots(t)
        self.step_no = t + 1

    def pending(self) -> bool:
        return bool(self.queue) or any(s.busy for s in self.slots)

    def run(self, max_steps: int = 10_000) -> ServeMetrics:
        while self.pending() and self.step_no < max_steps:
            self.step()
        return self.metrics

    def output(self, rid: int) -> list[int] | None:
        return self.completed.get(rid)
