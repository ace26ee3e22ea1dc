"""Fault taxonomy, deterministic sampling, and record/replay traces.

The taxonomy — one constant per fault class, ``FAULT_KINDS`` is the full
list.  Each class maps to exactly one recovery path owned by one layer:

=================== ========================================= ==============
class               recovery path                             owning layer
=================== ========================================= ==============
``host_crash``      checkpoint/snapshot restore +             serve + train
                    resubmission (the paper's original
                    fault model)
``slowdown``        stalled decode slots resume where they    serve + train
                    left off / virtual-time straggler
                    penalty; no state lost
``capacity_loss``   deadline-aware load shedding plus         serve
                    queue-length-priced admission
                    (reject-on-arrival with ``retry_after``)
                    keep the queue bounded; training treats
                    it as an outage window
``ckpt_corrupt``    ``CheckpointStore.restore`` quarantines   train
                    the bad shard and falls back to the
                    newest checkpoint whose shards verify
``snapshot_corrupt`` checksum mismatch detected at resume;    serve
                    the request re-prefills from scratch
``nan_poison``      the coordinator's NaN guard rejects the   train
                    update and quarantines the poisoned
                    batch index
``net_partition``   the majority pod component (quorum)       train (crosspod)
                    keeps training on its own averaged
                    gradients, minority pods park; on heal
                    stale pods restore the quorum's latest
                    committed checkpoint with error-feedback
                    residuals reset (no compression-bias
                    leak across the partition)
``disk_full``       the async checkpoint ``_write`` hits      train (ckpt
                    ENOSPC mid-save; the store prunes the     store)
                    oldest committed indices and retries —
                    the atomic pointer flip means the
                    committed index is never corrupted
=================== ========================================= ==============

``net_partition`` events carry the *minority* pod set as ``targets`` and the
partition window as ``duration``; ``disk_full`` events arm the next
checkpoint save with an injected ENOSPC.

Trace format (``FaultTrace.to_json``)::

    {"version": 1,
     "meta": {"profile": "unstable", "seed": 0, "horizon": 400,
              "n_targets": 4},
     "events": [{"step": 17, "kind": "host_crash", "targets": [2],
                 "duration": 12, "seed": 1234567}, ...]}

Every event is fully explicit — step, kind, targets, duration, and a
per-event RNG seed that pins which bytes a corruption flips — so replaying a
trace through :class:`ChaosEngine` reproduces a chaos run *bit-identically*.
To reproduce a recorded run::

    trace = FaultTrace.load("chaos_trace.json")
    engine = ServeEngine(cfg, ecfg, pool=pool, chaos=ChaosEngine(trace), ...)

or from the CLI: ``python -m repro_torch.launch.serve --chaos-trace chaos.json``.
``sample_trace`` draws inter-arrival gaps per fault class from the paper's
Section 4.1 Weibull MTBF and log-normal MTTR distributions (in step units,
scaled per :data:`CHAOS_PROFILES` environment), entirely from one seed.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os

import numpy as np

from repro_torch.obs.trace import NULL_TRACER

__all__ = [
    "HOST_CRASH",
    "SLOWDOWN",
    "CAPACITY_LOSS",
    "CKPT_CORRUPT",
    "SNAPSHOT_CORRUPT",
    "NAN_POISON",
    "NET_PARTITION",
    "DISK_FULL",
    "FAULT_KINDS",
    "SERVE_KINDS",
    "TRAIN_KINDS",
    "TRACE_VERSION",
    "CHAOS_PROFILES",
    "FaultEvent",
    "FaultTrace",
    "ChaosEngine",
    "sample_trace",
    "flip_bytes",
    "corrupt_checkpoint_shard",
]

HOST_CRASH = "host_crash"
SLOWDOWN = "slowdown"
CAPACITY_LOSS = "capacity_loss"
CKPT_CORRUPT = "ckpt_corrupt"
SNAPSHOT_CORRUPT = "snapshot_corrupt"
NAN_POISON = "nan_poison"
NET_PARTITION = "net_partition"
DISK_FULL = "disk_full"

FAULT_KINDS = (HOST_CRASH, SLOWDOWN, CAPACITY_LOSS, CKPT_CORRUPT,
               SNAPSHOT_CORRUPT, NAN_POISON, NET_PARTITION, DISK_FULL)
#: kinds each layer consumes (the other layer's kinds are no-ops there)
SERVE_KINDS = (HOST_CRASH, SLOWDOWN, CAPACITY_LOSS, SNAPSHOT_CORRUPT)
TRAIN_KINDS = (HOST_CRASH, SLOWDOWN, CAPACITY_LOSS, CKPT_CORRUPT, NAN_POISON,
               NET_PARTITION, DISK_FULL)

TRACE_VERSION = 1

# Per-class MTBF in steps, mirroring repro.serve.replicas.SERVE_ENVIRONMENTS:
# stability drops -> every fault class strikes more often and repairs slower.
CHAOS_PROFILES: dict[str, dict] = {
    "stable": {
        "shape": 12.5, "mttr_steps": 8,
        "mtbf": {HOST_CRASH: 800.0, SLOWDOWN: 600.0, CAPACITY_LOSS: 4000.0,
                 SNAPSHOT_CORRUPT: 3000.0, CKPT_CORRUPT: 3000.0,
                 NAN_POISON: 2500.0, NET_PARTITION: 5000.0,
                 DISK_FULL: 6000.0},
    },
    "normal": {
        "shape": 12.0, "mttr_steps": 16,
        "mtbf": {HOST_CRASH: 200.0, SLOWDOWN: 150.0, CAPACITY_LOSS: 1000.0,
                 SNAPSHOT_CORRUPT: 800.0, CKPT_CORRUPT: 800.0,
                 NAN_POISON: 600.0, NET_PARTITION: 1500.0, DISK_FULL: 2000.0},
    },
    "unstable": {
        "shape": 11.5, "mttr_steps": 24,
        "mtbf": {HOST_CRASH: 30.0, SLOWDOWN: 45.0, CAPACITY_LOSS: 150.0,
                 SNAPSHOT_CORRUPT: 120.0, CKPT_CORRUPT: 120.0,
                 NAN_POISON: 90.0, NET_PARTITION: 200.0, DISK_FULL: 250.0},
    },
}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  Fully explicit so replay needs no RNG."""

    step: int
    kind: str
    targets: tuple[int, ...] = ()
    duration: int = 0
    seed: int = 0

    def to_json(self) -> dict:
        return {"step": self.step, "kind": self.kind,
                "targets": list(self.targets), "duration": self.duration,
                "seed": self.seed}

    @classmethod
    def from_json(cls, d: dict) -> "FaultEvent":
        kind = str(d["kind"])
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in trace event {d!r}; "
                f"known kinds: {', '.join(FAULT_KINDS)}")
        return cls(step=int(d["step"]), kind=kind,
                   targets=tuple(int(t) for t in d.get("targets", ())),
                   duration=int(d.get("duration", 0)),
                   seed=int(d.get("seed", 0)))


@dataclasses.dataclass
class FaultTrace:
    """An ordered, serializable fault schedule (the record/replay unit)."""

    events: list[FaultEvent]
    meta: dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.events)

    def kinds(self) -> set[str]:
        return {ev.kind for ev in self.events}

    def to_json(self) -> dict:
        return {"version": TRACE_VERSION, "meta": self.meta,
                "events": [ev.to_json() for ev in self.events]}

    @classmethod
    def from_json(cls, d: dict) -> "FaultTrace":
        version = d.get("version", TRACE_VERSION)
        if version != TRACE_VERSION:
            raise ValueError(
                f"unsupported trace 'version' field: {version!r} (this "
                f"build replays version {TRACE_VERSION} traces only)")
        return cls(events=[FaultEvent.from_json(e) for e in d["events"]],
                   meta=dict(d.get("meta", {})))

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "FaultTrace":
        with open(path) as f:
            return cls.from_json(json.load(f))


def sample_trace(profile: str | dict, *, horizon: int, n_targets: int = 1,
                 seed: int = 0, kinds: tuple[str, ...] | None = None
                 ) -> FaultTrace:
    """Deterministically sample a :class:`FaultTrace` from one seed.

    Per fault class, inter-arrival gaps are Weibull with the profile's
    per-class MTBF scale (paper Section 4.1); outage/slowdown durations are
    log-normal around the profile's MTTR.  ``kinds`` restricts sampling to a
    subset of the taxonomy (e.g. one cell of the chaos matrix).
    """
    spec = CHAOS_PROFILES[profile] if isinstance(profile, str) else profile
    rng = np.random.default_rng(seed)
    events: list[FaultEvent] = []
    for kind in (kinds or FAULT_KINDS):
        mtbf = float(spec["mtbf"].get(kind, 0.0))
        if mtbf <= 0:
            continue
        t = rng.uniform(0, mtbf)
        while t < horizon:
            dur = max(1, int(round(rng.lognormal(
                np.log(max(spec["mttr_steps"], 1.0)), 0.25))))
            k = 1
            if kind == CAPACITY_LOSS and n_targets > 1:
                k = int(rng.integers(1, n_targets))
            elif kind == NET_PARTITION:
                # targets = the minority pod set: strictly less than half the
                # pods, so the complement always holds quorum
                max_k = max(1, (n_targets - 1) // 2)
                k = 1 if max_k == 1 else int(rng.integers(1, max_k + 1))
            targets = tuple(sorted(
                rng.choice(max(n_targets, 1), size=min(k, max(n_targets, 1)),
                           replace=False).tolist()))
            events.append(FaultEvent(
                step=int(t), kind=kind, targets=targets, duration=dur,
                seed=int(rng.integers(0, 2**31 - 1))))
            t += max(1.0, mtbf * rng.weibull(spec["shape"]))
    events.sort(key=lambda e: (e.step, e.kind, e.targets))
    meta = {"profile": profile if isinstance(profile, str) else "custom",
            "seed": seed, "horizon": horizon, "n_targets": n_targets,
            "kinds": list(kinds or FAULT_KINDS)}
    return FaultTrace(events=events, meta=meta)


class ChaosEngine:
    """Replays a :class:`FaultTrace` against a training or serving run.

    The consumer (``TrainingCoordinator`` / ``ServeEngine``) calls
    :meth:`events_at` once per step; each event fires exactly once, in trace
    order, so two runs over the same trace see identical fault sequences.

    A ``tracer`` (``repro.obs``) annotates every injected fault as a
    ``fault.<kind>`` span event and arms the flight recorder's
    dump-on-fault trigger; the default NULL tracer makes this one branch.
    """

    def __init__(self, trace: FaultTrace, *, tracer=None):
        self.trace = trace
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._by_step: dict[int, list[FaultEvent]] = {}
        for ev in trace.events:
            self._by_step.setdefault(ev.step, []).append(ev)
        self.applied: list[FaultEvent] = []
        self.applied_by_kind: collections.Counter = collections.Counter()

    def events_at(self, step: int) -> list[FaultEvent]:
        evs = self._by_step.pop(step, [])
        self.applied.extend(evs)
        for ev in evs:
            self.applied_by_kind[ev.kind] += 1
            self.tracer.fault(ev.kind, step=step,
                              targets=list(ev.targets),
                              duration=ev.duration)
        return evs

    def pending(self) -> int:
        return sum(len(v) for v in self._by_step.values())


# -- corruption helpers (byte-level, seed-deterministic) ---------------------
def flip_bytes(path: str, seed: int, n: int = 1) -> bool:
    """XOR-flip ``n`` payload bytes of ``path`` (skipping any format header
    region by flipping in the back half).  Returns False on an empty file."""
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        if not data:
            return False
        rng = np.random.default_rng(seed)
        lo = len(data) // 2
        for _ in range(n):
            data[int(rng.integers(lo, len(data)))] ^= 0xFF
        f.seek(0)
        f.write(data)
        f.truncate()
    return True


def corrupt_checkpoint_shard(store, seed: int) -> str | None:
    """Flip bytes in one shard of the *newest* committed checkpoint of a
    ``repro.ft.checkpoint.CheckpointStore``.  Victim selection is a pure
    function of ``seed``.  Returns the corrupted path (None if no commit)."""
    steps = store.committed_steps()
    if not steps:
        return None
    index = store.read_index(steps[-1])
    names = sorted(index["leaves"])
    if not names:
        return None
    meta = index["leaves"][names[seed % len(names)]]
    if not os.path.exists(meta["file"]):
        return None
    flip_bytes(meta["file"], seed)
    return meta["file"]
