"""Flight recorder: a bounded ring buffer of trace records with
fault-triggered dumps (a copy of ``repro.obs.recorder``: the dumps of the
two packages have one format).

The recorder is the black box of a chaos run: every span/event the tracer
emits lands in a ``deque(maxlen=capacity)``, so steady-state memory is
bounded no matter how long the run.  When a fault fires
(:meth:`on_fault`) or a recovery path is taken (:meth:`on_recovery`) —
and ``dump_on_fault`` is set — the last ``window_s`` seconds of events are
dumped twice:

* ``NNNN_<label>.jsonl`` — one JSON object per line, the loadable form
  (:func:`load_jsonl`);
* ``NNNN_<label>.trace.json`` — Chrome ``trace_event`` format
  (``chrome://tracing`` / Perfetto): spans as ``"X"`` complete events,
  point events as ``"i"`` instants.

Dumps are capped at ``max_dumps`` per run so an unstable-profile chaos
storm cannot fill the disk the checkpoints live on; a final explicit
:meth:`dump` (the launchers' ``run_end`` dump) does not count against the
cap.  The clock is injectable for deterministic tests.
"""
from __future__ import annotations

import collections
import json
import os
import time

__all__ = ["FlightRecorder", "load_jsonl", "to_chrome"]


def to_chrome(events: list[dict]) -> dict:
    """Convert recorder dicts to Chrome ``trace_event`` JSON (µs units)."""
    out = []
    for rec in events:
        args = {k: v for k, v in (rec.get("attrs") or {}).items()
                if v is not None}
        common = {"name": rec["name"], "pid": 0, "tid": rec.get("track",
                                                               "main"),
                  "args": args}
        if rec["type"] == "span":
            out.append({**common, "ph": "X",
                        "ts": rec["t0"] * 1e6,
                        "dur": max(rec["t1"] - rec["t0"], 0.0) * 1e6})
        else:
            out.append({**common, "ph": "i", "ts": rec["t"] * 1e6,
                        "s": "t"})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def load_jsonl(path: str) -> list[dict]:
    """Load a dumped ``.jsonl`` flight-recorder file back into dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class FlightRecorder:
    """Bounded ring of trace records + fault/recovery-triggered dumps."""

    def __init__(self, capacity: int = 8192, *, out_dir: str | None = None,
                 window_s: float | None = None, dump_on_fault: bool = False,
                 max_dumps: int = 64, clock=time.monotonic):
        self.capacity = max(1, int(capacity))
        self.out_dir = out_dir
        self.window_s = window_s
        self.dump_on_fault = dump_on_fault
        self.max_dumps = max_dumps
        self.clock = clock
        self._ring: collections.deque[dict] = collections.deque(
            maxlen=self.capacity)
        self._seq = 0
        self.dumps: list[str] = []        # jsonl paths written, in order
        self.faults_seen: collections.Counter = collections.Counter()
        self.recoveries_seen: collections.Counter = collections.Counter()

    # -- ingest ---------------------------------------------------------------
    def record(self, rec: dict) -> None:
        self._ring.append(rec)

    def __len__(self) -> int:
        return len(self._ring)

    def snapshot(self) -> list[dict]:
        """Current ring contents, oldest first, filtered to ``window_s``."""
        events = list(self._ring)
        if self.window_s is None:
            return events
        cutoff = self.clock() - self.window_s
        return [e for e in events
                if e.get("t1", e.get("t", 0.0)) >= cutoff]

    # -- dump triggers --------------------------------------------------------
    def on_fault(self, kind: str, *, step: int | None = None) -> str | None:
        self.faults_seen[kind] += 1
        if self.dump_on_fault:
            return self._auto_dump(f"fault_{kind}")
        return None

    def on_recovery(self, kind: str) -> str | None:
        self.recoveries_seen[kind] += 1
        if self.dump_on_fault:
            return self._auto_dump(f"recovery_{kind}")
        return None

    def _auto_dump(self, label: str) -> str | None:
        if len(self.dumps) >= self.max_dumps:
            return None
        return self.dump(label)

    # -- dump -----------------------------------------------------------------
    def dump(self, label: str = "manual") -> str | None:
        """Write the windowed ring as JSONL + Chrome trace.  Returns the
        JSONL path (None when no ``out_dir`` is configured)."""
        if self.out_dir is None:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        events = self.snapshot()
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in label)
        base = os.path.join(self.out_dir, f"{self._seq:04d}_{safe}")
        self._seq += 1
        jsonl = base + ".jsonl"
        with open(jsonl, "w") as f:
            for rec in events:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        with open(base + ".trace.json", "w") as f:
            json.dump(to_chrome(events), f, sort_keys=True)
        self.dumps.append(jsonl)
        return jsonl
