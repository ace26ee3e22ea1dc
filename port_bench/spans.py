"""Attribution of a traced window to the program's ranges.

The program marks ranges on the profiler's own timeline
(``repro_torch.obs.trace.range``: the train step's phases ``train.*``, the
layers' ``lm.*`` and ``layer.*``, the MoE layer's ``moe.*``); they are host
events of the kind "user annotation".  :func:`attribute` credits each
device operation, each idle gap and each range's host time to them:

- **a device operation** (kernel, copy, set) goes to the runtime call that
  launched it (the same ``correlation_id``; else the host op its
  ``linked_correlation_id`` names), and from there to the innermost *site*
  open on that call's thread at its start: a program range, or an autograd
  node (``autograd::engine::evaluate_function: ...``);
- **an autograd node** stands for the range that was open at its forward
  op: the host op whose (``start_thread_id``, ``sequence_nr``) is the
  node's (``fwd_thread_id``, ``sequence_nr``), and the innermost site open
  at that op's start (a node again is resolved in turn).  So a backward
  kernel counts under the range whose forward caused it, and a recomputed
  forward under the range that marks it in the recompute;
- **inclusive counts**: an operation counts toward the range it resolves
  to and every range that encloses that one on its thread, up to the first
  autograd node, except the phases; a phase (a range named ``train.*``)
  counts what is launched, on any thread, while it is open (the main
  thread waits in ``train.backward`` while the backward's thread works);
- **idle**: each idle gap of the window (:func:`port_bench.trace.union` of
  the device operations) is named by the site open at its middle, on
  whichever thread opened its site last, resolved and credited by the same
  rules; a gap with nothing open is :data:`OUTSIDE` (the harness's batch
  draw and loss copy);
- **host time** of a range: its instances' lengths in the window
  (inclusive) and that less the part its child ranges cover (self).

The harness's own ranges (``pb.*``) are no program ranges.  A trace with no
program range (a program that marks none) gives only :data:`OUTSIDE`, and
:func:`step_metrics` then gives no number.
"""
from __future__ import annotations

import bisect
import dataclasses

from .trace import DEVICE_WORK, WINDOW, union

__all__ = ["AUTOGRAD_NODE", "OUTSIDE", "PHASE", "STEP", "Device", "Host",
           "Index", "Span", "attribute", "events_of", "from_profile",
           "step_metrics", "read_step", "top"]

#: the prefix of the step's phases, which enclose by time
PHASE = "train."
#: the step's own range
STEP = "train.step"
#: the name of what happens where no program range is open
OUTSIDE = "outside"
#: the prefix of an autograd node's host event
AUTOGRAD_NODE = "autograd::engine::evaluate_function: "
#: the harness's ranges (the window, each step's call)
_HARNESS = "pb."
#: the kind of a program range's host event
RANGE = "user_annotation"


@dataclasses.dataclass(frozen=True, eq=False)
class Host:
    """A host event: ``kind`` :data:`RANGE` for a range (else anything);
    ``corr`` its correlation id, ``link`` the host op a runtime call was
    made in; ``seq`` and ``fwd_thread`` the autograd sequence number and,
    on a node, its forward op's thread."""
    name: str
    thread: int
    start: float
    end: float
    kind: str = ""
    corr: int = 0
    link: int = 0
    seq: int = -1
    fwd_thread: int = 0


@dataclasses.dataclass(frozen=True)
class Device:
    """A device operation: ``corr`` the correlation id of the runtime call
    that launched it, ``link`` the host op's that call was made in."""
    name: str
    start: float
    end: float
    corr: int = 0
    link: int = 0


@dataclasses.dataclass
class Span:
    """One range name's totals over the window (seconds; ``launches``
    device operations launched under it; ``count`` instances)."""
    device_s: float = 0.0
    launches: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    idle_s: float = 0.0
    count: int = 0


def _is_range(h: Host) -> bool:
    return h.kind == RANGE and not h.name.startswith(_HARNESS)


def _is_node(h: Host) -> bool:
    return h.name.startswith(AUTOGRAD_NODE)


def _is_runtime(name: str) -> bool:
    # the CUDA runtime's and driver's calls (cudaLaunchKernel,
    # cuLaunchKernelEx, cudaMemcpyAsync, ...); host ops are aten::*, nodes,
    # ranges
    return name.startswith("cu")


class Index:
    """The sites (program ranges and autograd nodes) of each thread, nested,
    with each node's resolution to a range."""

    def __init__(self, host):
        self.sites: dict = {}
        for h in host:
            if _is_range(h) or _is_node(h):
                self.sites.setdefault(h.thread, []).append(h)
        self.parent: dict = {}
        self.starts: dict = {}
        for thread, sites in self.sites.items():
            sites.sort(key=lambda h: (h.start, -h.end))
            self.starts[thread] = [h.start for h in sites]
            stack: list = []
            for h in sites:
                while stack and stack[-1].end <= h.start:
                    stack.pop()
                self.parent[h] = stack[-1] if stack else None
                stack.append(h)
        # a node's forward op: the first-started host op of its key
        self.forward: dict = {}
        for h in sorted(host, key=lambda h: h.start):
            if h.seq >= 0 and not _is_node(h) and h.kind != RANGE:
                self.forward.setdefault((h.thread, h.seq), h)
        self._resolved: dict = {}

    def innermost(self, thread: int, t: float):
        """The innermost site open at ``t`` on ``thread``, or None."""
        starts = self.starts.get(thread)
        if not starts:
            return None
        i = bisect.bisect_right(starts, t) - 1
        s = self.sites[thread][i] if i >= 0 else None
        while s is not None and s.end <= t:
            s = self.parent[s]
        return s

    def resolve(self, site, depth: int = 0):
        """The program range a site stands for (a range itself; a node the
        range of its forward op), or None."""
        if site is None or _is_range(site):
            return site
        if site in self._resolved:
            return self._resolved[site]
        fwd = self.forward.get((site.fwd_thread, site.seq))
        got = None
        if fwd is not None and depth < 64:
            got = self.resolve(self.innermost(fwd.thread, fwd.start),
                               depth + 1)
        self._resolved[site] = got
        return got

    def chain(self, rng) -> list[str]:
        """``rng`` and the ranges enclosing it on its thread, up to the
        first node, phases left out."""
        out = []
        while rng is not None and _is_range(rng):
            if not rng.name.startswith(PHASE):
                out.append(rng.name)
            rng = self.parent[rng]
        return out


def _phases(host, lo, hi):
    """{phase name: (sorted starts, ends)} of the phases in the window."""
    by: dict = {}
    for h in host:
        if _is_range(h) and h.name.startswith(PHASE) and h.end > lo \
                and h.start < hi:
            by.setdefault(h.name, []).append((h.start, h.end))
    return {k: ([a for a, _ in sorted(v)], [b for _, b in sorted(v)])
            for k, v in by.items()}


def _open_phases(phases, t: float) -> list[str]:
    out = []
    for name, (starts, ends) in phases.items():
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and ends[i] > t:
            out.append(name)
    return out


def _launcher(device: Device, runtime: dict, ops: dict):
    """The host event that launched ``device``: the runtime call of its
    correlation id, else the host op its link names (0: none)."""
    return ((runtime.get(device.corr) if device.corr else None)
            or (ops.get(device.link) if device.link else None))


def attribute(device, host, window) -> dict:
    """{name: :class:`Span`} of the program's ranges over ``window``
    (start_s, end_s), with :data:`OUTSIDE` for what falls under none;
    ``device`` [:class:`Device`], ``host`` [:class:`Host`]."""
    lo, hi = window
    index = Index(host)
    phases = _phases(host, lo, hi)
    runtime, ops = {}, {}
    for h in host:
        if _is_runtime(h.name):
            runtime.setdefault(h.corr, h)
        elif h.kind != RANGE and not _is_node(h):
            ops.setdefault(h.corr, h)
    out: dict = {}

    def credit(names, field, value):
        for n in names:
            rec = out.setdefault(n, Span())
            setattr(rec, field, getattr(rec, field) + value)

    def names_at(thread, t):
        rng = index.resolve(index.innermost(thread, t))
        names = index.chain(rng) + _open_phases(phases, t)
        return names or [OUTSIDE]

    spans = []
    for d in device:
        a, b = max(d.start, lo), min(d.end, hi)
        if b <= a:
            continue
        spans.append((a, b))
        by = _launcher(d, runtime, ops)
        names = names_at(by.thread, by.start) if by else [OUTSIDE]
        credit(names, "device_s", b - a)
        credit(names, "launches", 1)
    _, gaps = union(spans, lo, hi)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        # the site opened last, on any thread
        open_ = [s for s in (index.innermost(t, mid) for t in index.sites)
                 if s is not None]
        site = max(open_, key=lambda s: s.start) if open_ else None
        if site is None:
            credit(_open_phases(phases, mid) or [OUTSIDE], "idle_s", b - a)
        else:
            credit(names_at(site.thread, mid), "idle_s", b - a)
    inside = {}                      # each range's seconds in the window
    for sites in index.sites.values():
        for h in sites:
            a, b = max(h.start, lo), min(h.end, hi)
            if _is_range(h) and b > a:
                inside[h] = b - a
    kids: dict = {}
    for h, s in inside.items():
        p = index.parent[h]
        if p is not None and _is_range(p):
            kids[p] = kids.get(p, 0.0) + s
    for h, s in inside.items():
        credit([h.name], "host_s", s)
        credit([h.name], "self_s", s - kids.get(h, 0.0))
        credit([h.name], "count", 1)
    return out


def events_of(prof):
    """(device [:class:`Device`], host [:class:`Host`], window) of a
    finished ``torch.profiler.profile`` whose steps ran inside the
    harness's :data:`~port_bench.trace.WINDOW` range.  A range recorded on
    the host is mirrored on the device's timeline (kineto's
    ``gpu_user_annotation``) and is no work: where the events carry no
    activity type, a device event that is a user annotation is taken for
    such a mirror and left out."""
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    device, host, window = [], [], None
    for e in events:
        a, b = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            kind = RANGE if e.is_user_annotation() else ""
            if name == WINDOW:
                window = (a, b)
            host.append(Host(name, e.start_thread_id(), a, b, kind,
                             e.correlation_id(), e.linked_correlation_id(),
                             e.sequence_nr(), e.fwd_thread_id()))
        elif (e.activity_type() in DEVICE_WORK
              if hasattr(e, "activity_type") else not e.is_user_annotation()):
            device.append(Device(name, a, b, e.correlation_id(),
                                 e.linked_correlation_id()))
    return device, host, window


def from_profile(prof) -> dict:
    """:func:`attribute` of a finished profile (see :func:`events_of`)."""
    device, host, window = events_of(prof)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    return attribute(device, host, window)


def step_metrics(spans: dict, steps: int) -> dict:
    """The per-step numbers of the step's phases and the MoE layer's stages
    (ms, launches), each None where the trace holds no such range."""
    def ms(*names, field="device_s"):
        got = [spans[n] for n in names if n in spans]
        if not got:
            return None
        return 1e3 * sum(getattr(s, field) for s in got) / steps

    step = spans.get(STEP)
    return {
        "forward_ms": ms("train.forward"),
        "backward_ms": ms("train.backward"),
        "optimizer_ms": ms("train.optimizer"),
        "moe_route_ms": ms("moe.route", "moe.dispatch", "moe.combine"),
        "moe_experts_ms": ms("moe.experts"),
        "step_idle_ms": ms(STEP, field="idle_s"),
        "step_launches": None if step is None else step.launches / steps,
    }


def read_step(run, name: str):
    """:func:`step_metrics`' ``name`` of a run's traced window
    (``run.trace.spans``), None without a trace or without the range."""
    t = run.trace
    return None if t is None else step_metrics(t.spans, t.steps)[name]


def top(spans: dict, field: str, n: int = 10) -> list:
    """The ``n`` ranges with the most ``field``, each as [name, device
    seconds, host seconds, launches, idle seconds]."""
    rows = sorted(spans.items(), key=lambda kv: -getattr(kv[1], field))
    return [[k, v.device_s, v.host_s, v.launches, v.idle_s]
            for k, v in rows[:n] if getattr(v, field) > 0]
