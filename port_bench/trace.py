"""The reduction of a profiler trace to the numbers the per-layer metrics
read.

A traced run records ``torch.profiler`` (CPU and CUDA activities) over a
few steps inside a range named :data:`WINDOW`; :func:`reduce` keeps, from
that range alone: each device operation (kernels, copies, sets) clipped to
it, the union of their intervals (``busy_s``), the range's length
(``window_s``), and each idle gap on the device named by what the host was
doing at its middle: the innermost host event then open, on any thread.  So
the gaps add up to ``window_s - busy_s``, the idle share the run reports.
It also attributes the same window to the program's ranges
(:func:`port_bench.spans.attribute`), which readers find by name in
``Trace.spans``.

Kernels are grouped by name as ``chip_smoke.py::_profile`` (commit 93b320d)
groups them: the port's own (:data:`PORT_KERNELS`), the library's matrix
products (:data:`LIBRARY_PRODUCTS`), and the rest.
"""
from __future__ import annotations

import dataclasses
import heapq

__all__ = ["WINDOW", "PORT_KERNELS", "LIBRARY_PRODUCTS", "DEVICE_WORK", "Trace",
           "group", "reduce", "reduce_events", "union"]

#: the range that bounds the traced window
WINDOW = "pb.window"
#: the port's own kernels, by the names the profiler gives them
PORT_KERNELS = ("pairwise_distance_kernel", "flash_fwd", "flash_bwd",
                "wkv6_", "lru_chunk", "lru_bwd")
#: the library's matrix products (cuBLAS, CUTLASS)
LIBRARY_PRODUCTS = ("gemm", "nvjet", "cutlass", "xmma")
#: device operations that are no kernel
_NOT_KERNELS = ("memcpy", "memset")


def group(name: str) -> str:
    """``port``, ``library`` or ``other`` (a copy or a set: ``copy``)."""
    low = name.lower()
    if any(n in name for n in PORT_KERNELS):
        return "port"
    if any(n in low for n in LIBRARY_PRODUCTS):
        return "library"
    if any(low.startswith(n) for n in _NOT_KERNELS):
        return "copy"
    return "other"


@dataclasses.dataclass
class Trace:
    """One traced window: ``ops`` {name: [seconds, count]} of the device
    operations in it, ``gaps`` {host activity: idle seconds}, ``steps``
    traced, the step calls' host seconds (``enqueue_s``) and ``spans``
    {program range: :class:`port_bench.spans.Span`}."""
    window_s: float
    busy_s: float
    ops: dict
    gaps: dict
    steps: int
    enqueue_s: list
    spans: dict = dataclasses.field(default_factory=dict)

    def seconds(self, pred) -> float:
        """Device seconds of the operations whose name ``pred`` accepts."""
        return sum(v[0] for k, v in self.ops.items() if pred(k))

    def count(self, pred) -> int:
        return sum(v[1] for k, v in self.ops.items() if pred(k))

    def breakdown(self, n: int = 10) -> dict:
        """The ``n`` device operations that took most time, the ``n`` host
        activities with the most idle device time, and the ``n`` program
        ranges with the most device time (``spans``) and idle time
        (``idle_spans``), each as [name, seconds]."""
        from .spans import top as top_spans

        def top(pairs):
            return [[k[:64], v] for k, v in
                    sorted(pairs, key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top((k, v[0]) for k, v in self.ops.items()),
                "idle_gaps": top(self.gaps.items()),
                "spans": [[r[0], r[1]] for r in
                          top_spans(self.spans, "device_s", n)],
                "idle_spans": [[r[0], r[4]] for r in
                               top_spans(self.spans, "idle_s", n)]}


def union(intervals, lo: float, hi: float):
    """(busy length, [gaps]) of ``intervals`` [(start, end)] clipped to
    [lo, hi]."""
    busy, gaps, at = 0.0, [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > at:
            gaps.append((at, a))
        if b > at:
            busy += b - max(a, at)
            at = b
    if at < hi:
        gaps.append((at, hi))
    return busy, gaps


def reduce_events(device, host, window, steps: int, enqueue_s) -> Trace:
    """``device`` [(name, start_s, end_s)] of device operations, ``host``
    [(name, start_s, end_s)] of host events (ranges, ops, runtime calls),
    ``window`` (start_s, end_s)."""
    lo, hi = window
    ops: dict = {}
    spans = []
    for name, a, b in device:
        a2, b2 = max(a, lo), min(b, hi)
        if b2 <= a2:
            continue
        rec = ops.setdefault(name, [0.0, 0])
        rec[0] += b2 - a2
        rec[1] += 1
        spans.append((a2, b2))
    busy, gaps = union(spans, lo, hi)
    events = sorted((a, b, name) for name, a, b in host
                    if name != WINDOW and b > lo and a < hi)
    named: dict = {}
    # a sweep over the gaps' middles in time order: ``open_`` holds the
    # host events begun so far, latest start on top; one that has ended
    # before this middle has ended before every later one too
    open_: list = []
    i = 0
    for a, b in gaps:                 # ``union`` gives them in time order
        mid = 0.5 * (a + b)
        while i < len(events) and events[i][0] <= mid:
            s, e, name = events[i]
            heapq.heappush(open_, (-s, e, name))
            i += 1
        while open_ and open_[0][1] <= mid:
            heapq.heappop(open_)
        who = open_[0][2] if open_ else "host:none"
        named[who] = named.get(who, 0.0) + (b - a)
    return Trace(window_s=hi - lo, busy_s=busy, ops=ops, gaps=named,
                 steps=steps, enqueue_s=list(enqueue_s))


#: kineto's activity types of the device operations
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce(prof, steps: int, enqueue_s) -> Trace:
    """:func:`reduce_events` of a finished ``torch.profiler.profile``, with
    its ``spans`` attributed (:func:`port_bench.spans.attribute`) from the
    same events, read once (:func:`port_bench.spans.events_of`)."""
    from . import spans
    device, host, window = spans.events_of(prof)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    if not device:
        raise RuntimeError("the trace holds no device operation")
    out = reduce_events([(d.name, d.start, d.end) for d in device],
                        [(h.name, h.start, h.end) for h in host], window,
                        steps, enqueue_s)
    out.spans = spans.attribute(device, host, window)
    return out
