"""The reduction of a profiler trace to the numbers the per-layer metrics
read.

A traced run records ``torch.profiler`` (CPU and CUDA activities) over a
few steps inside a range named :data:`WINDOW`; :func:`reduce` keeps, from
that range alone: each device operation (kernels, copies, sets) clipped to
it, the union of their intervals (``busy_s``), the range's length
(``window_s``), and each idle gap on the device named by what the host was
doing at its middle: the innermost host event then open, on any thread.  So
the gaps add up to ``window_s - busy_s``, the idle share the run reports.

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
    traced and the step calls' host seconds (``enqueue_s``)."""
    window_s: float
    busy_s: float
    ops: dict
    gaps: dict
    steps: int
    enqueue_s: list

    def seconds(self, pred) -> float:
        """Device seconds of the operations whose name ``pred`` accepts."""
        return sum(v[0] for k, v in self.ops.items() if pred(k))

    def count(self, pred) -> int:
        return sum(v[1] for k, v in self.ops.items() if pred(k))

    def breakdown(self, n: int = 10) -> dict:
        """The ``n`` device operations that took most time and the ``n``
        host activities with the most idle device time, in seconds."""
        def top(pairs):
            return [[k[:64], v] for k, v in
                    sorted(pairs, key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top((k, v[0]) for k, v in self.ops.items()),
                "idle_gaps": top(self.gaps.items())}


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
    """:func:`reduce_events` of a finished ``torch.profiler.profile``.  A
    range recorded on the host is mirrored on the device's timeline (kineto's
    ``gpu_user_annotation``) and is no work: where the events carry no
    activity type, a device event named as a host event is taken for such a
    mirror and left out."""
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    host_names = {e.name() for e in events
                  if e.device_type() == DeviceType.CPU}
    device, host, window = [], [], None
    for e in events:
        a, b = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name == WINDOW:
                window = (a, b)
            host.append((name, a, b))
        elif (e.activity_type() in DEVICE_WORK
              if hasattr(e, "activity_type") else name not in host_names):
            device.append((name, a, b))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    if not device:
        raise RuntimeError("the trace holds no device operation")
    return reduce_events(device, host, window, steps, enqueue_s)
