"""The work of each kernel launch, for a cost capture.

A launch through ``ctypes`` is no aten op, so neither
``torch.utils.flop_counter.FlopCounterMode`` nor a dispatch mode sees it.
Each wrapper therefore reports the FLOPs and bytes of its launch here, with
the counts of the card's bound for that kernel (each input read once, each
output written once; the operations these inputs need), and
:func:`capture` collects them while it is open
(``repro_torch.obs.profile.ProfiledFn.capture_cost``).  A wrapper reports
only when :func:`active` says a capture is open, so outside one a launch
pays one call and evaluates none of its counts.
"""
from __future__ import annotations

import contextlib

__all__ = ["active", "attended_pairs", "capture", "report", "shape_only"]

_captures: list[dict] = []


@contextlib.contextmanager
def capture():
    """Collect ``{kernel: {"flops", "bytes", "launches"}}`` of the launches
    made while the block runs (captures may nest)."""
    sink: dict = {}
    _captures.append(sink)
    try:
        yield sink
    finally:
        _captures.remove(sink)


def active() -> bool:
    """Whether a capture is open (a wrapper reports only then)."""
    return bool(_captures)


def shape_only(x) -> bool:
    """Whether ``x`` is a fake tensor (a shape without data, as the dry run
    traces with): a wrapper then returns outputs of the kernel's shapes and
    dtypes, reports the launch's work and launches nothing.  A ``meta``
    tensor is a device without a kernel, and raises."""
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x)


def report(name: str, flops: float, nbytes: float) -> None:
    """One launch of kernel ``name``: its FLOPs and bytes."""
    for sink in _captures:
        rec = sink.setdefault(name, {"flops": 0.0, "bytes": 0.0,
                                     "launches": 0})
        rec["flops"] += flops
        rec["bytes"] += nbytes
        rec["launches"] += 1


def attended_pairs(s: int, causal: bool, window: int, sk: int | None = None
                   ) -> int:
    """(query, key) pairs a head attends at s queries (and sk keys, s by
    default; causal only at sk = s)."""
    if not causal:
        return s * (s if sk is None else sk)
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window
