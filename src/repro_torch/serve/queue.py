"""Admission queue: requests, request classes, deadlines, features.

Serving analogue of the simulator's task model (``repro.core.workflow`` /
``repro.core.features``): an inference *request* plays the role of a DAG
task.  Requests are bucketed into :class:`RequestClass` cells by
(prompt-length bucket, new-token bucket) — the buckets double as the jit
compilation keys for prefill — and embedded into a 10-dimensional feature
space mirroring paper Section 3.1 so the CRCH pipeline (PCA -> triplet
clustering -> replication counts) can learn per-class hedging budgets
unsupervised (see ``repro.serve.replicas``).
"""
from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np

__all__ = [
    "Request",
    "RequestClass",
    "WorkItem",
    "AdmissionQueue",
    "prompt_bucket",
    "request_class",
    "request_features",
    "REQUEST_FEATURE_NAMES",
]


@dataclasses.dataclass
class Request:
    """One inference request: prompt tokens + a decode budget + an SLO.

    ``frames`` / ``image_embeds`` are per-request side inputs for the
    encoder-decoder and multimodal families: the audio-frontend frame
    embeddings (n_frames, d_model) and the vision-frontend patch embeddings
    (n_image_tokens, d_model).  They are consumed at prefill — the derived
    per-slot state (cross-attention K/V, image-token KV rows) lives inside
    the slot's cache row afterwards, so snapshots and freed-slot reuse carry
    it automatically; a from-scratch resubmission re-prefills from the arrays
    kept here.
    """

    rid: int
    prompt: np.ndarray              # (P,) int32 token ids
    max_new_tokens: int
    arrival: int = 0                # engine step at which the request arrived
    deadline: int | None = None     # absolute step for SLO-attainment (goodput)
    priority: float = 1.0
    frames: np.ndarray | None = None        # (n_frames, d_model) enc-dec
    image_embeds: np.ndarray | None = None  # (n_image_tokens, d_model) VLM

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[0])

    @property
    def total_work(self) -> int:
        return self.prompt_len + self.max_new_tokens


def prompt_bucket(n: int, *, min_bucket: int = 8) -> int:
    """Next power-of-two >= n (>= min_bucket): the prefill padding length."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """Admission-queue class = (prompt bucket, new-token bucket)."""

    prompt_bucket: int
    new_bucket: int

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return f"p{self.prompt_bucket}/n{self.new_bucket}"


def request_class(req: Request) -> RequestClass:
    return RequestClass(prompt_bucket(req.prompt_len),
                        new_bucket=prompt_bucket(req.max_new_tokens))


REQUEST_FEATURE_NAMES = (
    "prefill_work",     # prompt tokens (analogue of w_t, Eq. 1)
    "decode_work",      # decode budget: time-at-risk during generation
    "total_work",
    "priority",
    "deadline_slack",   # deadline - arrival - total_work (inf-free)
    "decode_frac",      # decode_work / total_work
    "log2_prompt_bucket",
    "log2_new_bucket",
    "urgency",          # total_work / (slack + total_work)
    "restart_cost",     # re-prefill cost on failure without a snapshot
)


def request_features(requests: list[Request],
                     *, slack_cap: float = 4096.0) -> np.ndarray:
    """(N, 10) float feature matrix, axis order ``REQUEST_FEATURE_NAMES``.

    Serving counterpart of ``repro.core.features.task_features``: the
    features deliberately correlate (work sizes appear in several guises)
    exactly as the paper's ten task features do — the PCA stage is what
    de-correlates them.
    """
    feats = np.zeros((len(requests), len(REQUEST_FEATURE_NAMES)))
    for i, r in enumerate(requests):
        p, m = float(r.prompt_len), float(r.max_new_tokens)
        total = p + m
        slack = (float(r.deadline - r.arrival) - total
                 if r.deadline is not None else slack_cap)
        slack = min(slack, slack_cap)
        feats[i] = (
            p,
            m,
            total,
            float(r.priority),
            slack,
            m / max(total, 1.0),
            math.log2(prompt_bucket(r.prompt_len)),
            math.log2(prompt_bucket(r.max_new_tokens)),
            total / max(slack + total, 1.0),
            p,
        )
    return feats


@dataclasses.dataclass
class WorkItem:
    """One schedulable copy of a request.

    A request with replication count ``r`` fans out into ``r`` work items
    (``copy_id`` 0..r-1) that must land on distinct workers — the paper's
    Algorithm 1 ``repCount`` over-provisioning.  A resubmission (all copies
    failed, Algorithm 3 steps 14-15/25-26) re-enters the queue as a new item
    carrying the request's last decode snapshot, if any.
    """

    req: Request
    copy_id: int = 0
    snapshot: object | None = None      # repro.serve.snapshot.DecodeSnapshot
    is_resubmission: bool = False


class AdmissionQueue:
    """FIFO admission queue with head-of-line resubmissions.

    Fresh requests join at the tail in arrival order; resubmissions of
    failed requests jump to the head (Algorithm 3 resubmits "as soon as
    possible").  ``cancel`` drops the pending copies of a request the moment
    one replica completes, so hedges never consume slots posthumously.

    **Queue-length-priced admission**: with ``max_depth`` set, :meth:`admit`
    rejects a fresh request on arrival once depth has crossed the bound and
    returns a ``retry_after`` hint (steps until the backlog ahead of the
    bound drains at ``drain_rate`` tokens/step), so the queue itself stays
    bounded under sustained capacity loss instead of growing without limit.
    Resubmissions always bypass the bound — they carry work already paid
    for.
    """

    def __init__(self, *, max_depth: int | None = None,
                 drain_rate: float = 1.0) -> None:
        self._items: collections.deque[WorkItem] = collections.deque()
        self.max_depth = max_depth
        self.drain_rate = max(float(drain_rate), 1e-9)

    def __len__(self) -> int:
        return len(self._items)

    def submit(self, item: WorkItem) -> None:
        if item.is_resubmission:
            self._items.appendleft(item)
        else:
            self._items.append(item)

    def retry_after_hint(self) -> int:
        """Steps until enough of the backlog ahead of ``max_depth`` drains
        for one fresh item to fit (a lower bound: one decoded token per
        ``1/drain_rate`` steps retires queued work)."""
        if self.max_depth is None:
            return 0
        excess = len(self._items) - self.max_depth + 1
        if excess <= 0:
            return 0
        ahead = [it for i, it in enumerate(self._items) if i < excess]
        tokens = sum(it.req.max_new_tokens for it in ahead)
        return max(1, math.ceil(tokens / self.drain_rate))

    def admit(self, items: list[WorkItem]) -> int | None:
        """All-or-nothing admission of one request's copies.  Returns
        ``None`` on success, or the ``retry_after`` hint (steps) when the
        depth bound rejects the arrival."""
        fresh = items and not any(it.is_resubmission for it in items)
        if (self.max_depth is not None and fresh
                and len(self._items) >= self.max_depth):
            return self.retry_after_hint()
        for it in items:
            self.submit(it)
        return None

    def pop(self, admissible=None) -> WorkItem | None:
        """Pop the first item for which ``admissible(item)`` holds."""
        if admissible is None:
            return self._items.popleft() if self._items else None
        for i, item in enumerate(self._items):
            if admissible(item):
                del self._items[i]
                return item
        return None

    def cancel(self, rid: int) -> int:
        """Remove all pending items of request ``rid``; returns the count."""
        kept = [it for it in self._items if it.req.rid != rid]
        n = len(self._items) - len(kept)
        self._items = collections.deque(kept)
        return n

    def pending_rids(self) -> set[int]:
        return {it.req.rid for it in self._items}

    def items(self) -> tuple[WorkItem, ...]:
        """Read-only view of the queued items, head first."""
        return tuple(self._items)

    def drop_hedges(self) -> int:
        """Degraded mode: keep at most one queued copy per request.

        Under capacity loss the queue stops paying for replication — extra
        queued copies of a request are dropped (never resubmissions, and
        in-flight copies are untouched).  Returns the number dropped.
        """
        seen: set[int] = set()
        kept: list[WorkItem] = []
        dropped = 0
        for it in self._items:
            rid = it.req.rid
            if rid in seen and not it.is_resubmission:
                dropped += 1
                continue
            seen.add(rid)
            kept.append(it)
        self._items = collections.deque(kept)
        return dropped
