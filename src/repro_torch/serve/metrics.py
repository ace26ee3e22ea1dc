"""Serving metrics: goodput, latency percentiles, usage/wastage counters.

Online counterparts of the simulator metrics in ``repro.core.metrics``
(paper Section 4.2):

* **usage** — total tokens *processed* across all request copies: prefill
  tokens (at padded bucket length), decoded tokens, and snapshot overhead
  (the Eq. 10 ``gamma`` term), mirroring "processor seconds spent executing
  task copies";
* **wastage** — processed tokens that did not contribute to a delivered
  response, computed as ``usage - useful`` where useful is one clean copy
  (true prompt + decode budget) per completed request: late-replica tokens,
  beyond-last-snapshot tokens lost to failures, re-prefills, and bucket
  padding all land here, mirroring Fig. 9 (failed requests waste everything
  they executed);
* **goodput** — requests completed within their deadline per 1k decode
  steps (the serving analogue of workflow success rate x 1/TET).

Since the ``repro.obs`` unification the counters live in a
:class:`~repro.obs.metrics.MetricsRegistry` as three labeled families —
``serve_tokens_total{kind=...}``, ``serve_events_total{kind=...}`` and
``serve_drops_total{reason=...}`` — and :class:`ServeMetrics` is a thin
compatibility shim: the legacy attribute names (``metrics.failures += 1``,
``metrics.rejected_on_arrival``) read and write the corresponding labeled
series via ``__getattr__``/``__setattr__``, so the engine and every
existing test keep working unchanged while exporters see one registry.
Pass a shared registry to pool serving series with the rest of a run.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["RequestRecord", "ServeMetrics", "format_table"]


@dataclasses.dataclass
class RequestRecord:
    rid: int
    arrival: int
    deadline: int | None
    prompt_len: int
    max_new: int
    completed_step: int | None = None
    shed_step: int | None = None    # load-shed (degraded mode), never ran
    rejected_step: int | None = None   # rejected on arrival (queue bound)
    retry_after: int | None = None     # hint returned with the rejection

    @property
    def completed(self) -> bool:
        return self.completed_step is not None

    @property
    def in_deadline(self) -> bool:
        return (self.completed and
                (self.deadline is None or self.completed_step <= self.deadline))

    @property
    def latency(self) -> float:
        return (float(self.completed_step - self.arrival)
                if self.completed else float("nan"))


class ServeMetrics:
    # legacy attribute -> (registry metric, labels).  Reads and writes on
    # these names go through the registry series; everything else is a
    # normal instance attribute.
    _SERIES = {
        "prefill_tokens": ("serve_tokens_total", {"kind": "prefill"}),
        "decode_tokens": ("serve_tokens_total", {"kind": "decode"}),
        "snapshot_overhead_tokens": ("serve_tokens_total",
                                     {"kind": "snapshot_overhead"}),
        "failures": ("serve_events_total", {"kind": "worker_failure"}),
        "resubmissions": ("serve_events_total", {"kind": "resubmission"}),
        "restores": ("serve_events_total", {"kind": "snapshot_restore"}),
        "snapshots": ("serve_events_total", {"kind": "snapshot"}),
        "capacity_events": ("serve_events_total",
                            {"kind": "capacity_loss"}),
        "slowdown_events": ("serve_events_total", {"kind": "slowdown"}),
        "snapshots_corrupted": ("serve_events_total",
                                {"kind": "snapshot_corrupt"}),
        "snapshot_restore_failures": ("serve_events_total",
                                      {"kind": "snapshot_verify_fail"}),
        "shed": ("serve_drops_total", {"reason": "shed"}),
        "rejected_on_arrival": ("serve_drops_total",
                                {"reason": "rejected_on_arrival"}),
        "hedge_drops": ("serve_drops_total", {"reason": "hedge"}),
        # tripwire: a request past its first token must never be dropped
        "past_first_token_drops": ("serve_drops_total",
                                   {"reason": "past_first_token"}),
    }

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self.records: dict[int, RequestRecord] = {}
        self._counters = {
            "serve_tokens_total": self.registry.counter(
                "serve_tokens_total",
                "tokens processed across all request copies, by kind",
                ("kind",)),
            "serve_events_total": self.registry.counter(
                "serve_events_total",
                "serving-side fault/recovery events by kind", ("kind",)),
            "serve_drops_total": self.registry.counter(
                "serve_drops_total",
                "request/copy drops by reason", ("reason",)),
        }

    def __getattr__(self, name):
        # only reached when normal lookup fails, i.e. for _SERIES names
        series = ServeMetrics._SERIES.get(name)
        if series is None:
            raise AttributeError(name)
        metric, labels = series
        return self.__dict__["_counters"][metric].value(**labels)

    def __setattr__(self, name, value) -> None:
        series = ServeMetrics._SERIES.get(name)
        if series is None:
            object.__setattr__(self, name, value)
            return
        metric, labels = series
        self.__dict__["_counters"][metric].set(value, **labels)

    # -- lifecycle hooks (called by the engine) ------------------------------
    def register(self, req) -> None:
        self.records[req.rid] = RequestRecord(
            rid=req.rid, arrival=req.arrival, deadline=req.deadline,
            prompt_len=req.prompt_len, max_new=req.max_new_tokens)

    def complete(self, rid: int, step: int) -> None:
        self.records[rid].completed_step = step

    def mark_shed(self, rid: int, step: int) -> None:
        rec = self.records.get(rid)
        if rec is not None:
            rec.shed_step = step
        self.shed += 1

    def mark_rejected(self, rid: int, step: int, retry_after: int) -> None:
        rec = self.records.get(rid)
        if rec is not None:
            rec.rejected_step = step
            rec.retry_after = retry_after
        self.rejected_on_arrival += 1

    # -- summaries -----------------------------------------------------------
    @property
    def usage_tokens(self) -> float:
        return (self.prefill_tokens + self.decode_tokens +
                self.snapshot_overhead_tokens)

    @property
    def useful_tokens(self) -> float:
        """One clean copy (true prompt + decode budget) per completion."""
        return float(sum(r.prompt_len + r.max_new
                         for r in self.records.values() if r.completed))

    @property
    def wasted_tokens(self) -> float:
        return max(float(self.usage_tokens) - self.useful_tokens, 0.0)

    def summary(self, horizon_steps: int) -> dict[str, float]:
        recs = list(self.records.values())
        lats = np.asarray([r.latency for r in recs if r.completed], float)
        done = sum(r.completed for r in recs)
        good = sum(r.in_deadline for r in recs)
        useful_new = sum(r.max_new for r in recs if r.completed)
        out = {
            "n_requests": float(len(recs)),
            "completed": float(done),
            "in_deadline": float(good),
            "goodput": 1000.0 * good / max(horizon_steps, 1),
            "useful_tok_per_step": useful_new / max(horizon_steps, 1),
            "p50_latency": float(np.percentile(lats, 50)) if lats.size else float("nan"),
            "p99_latency": float(np.percentile(lats, 99)) if lats.size else float("nan"),
            "usage_tokens": float(self.usage_tokens),
            "wasted_tokens": self.wasted_tokens,
            "wastage_frac": self.wasted_tokens / max(self.usage_tokens, 1e-9),
            "failures": float(self.failures),
            "resubmissions": float(self.resubmissions),
            "restores": float(self.restores),
            "snapshots": float(self.snapshots),
            "shed": float(self.shed),
            "rejected_on_arrival": float(self.rejected_on_arrival),
            "hedge_drops": float(self.hedge_drops),
            "snapshot_restore_failures": float(
                self.snapshot_restore_failures),
            "past_first_drops": float(self.past_first_token_drops),
        }
        return out


def format_table(rows: list[dict], columns: list[tuple[str, str]]) -> str:
    """Plain-text table: ``columns`` = [(key, header), ...]."""
    def fmt(v):
        if isinstance(v, float):
            return f"{v:.2f}" if abs(v) < 1e4 else f"{v:.3g}"
        return str(v)

    cells = [[fmt(r.get(k, "")) for k, _ in columns] for r in rows]
    headers = [h for _, h in columns]
    widths = [max(len(h), *(len(c[i]) for c in cells)) if cells else len(h)
              for i, h in enumerate(headers)]
    line = "  ".join(h.rjust(w) for h, w in zip(headers, widths))
    sep = "  ".join("-" * w for w in widths)
    body = ["  ".join(c.rjust(w) for c, w in zip(row, widths))
            for row in cells]
    return "\n".join([line, sep] + body)
