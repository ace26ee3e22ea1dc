"""Profiling hooks for step functions (counterpart of ``repro.obs.profile``).

:func:`profile_jit` wraps a step callable and records, into the unified
metrics registry and (optionally) the span tracer:

* **first-call time** — the first call lands in
  ``profile_compile_seconds{step=<name>}``: on the card it includes the
  kernels' first-use build and load (the counterpart of JAX's trace and XLA
  compile); the steady-state histogram starts at call 2;
* **per-step wall time** — every later call is timed end to end (the
  outputs' CUDA devices are synchronised, so asynchronous launches cannot
  hide the work) into ``profile_step_seconds`` histogram series;
* **cost** — :meth:`ProfiledFn.capture_cost` runs the call once more on
  concrete arguments and counts its FLOPs (``torch.utils.flop_counter.
  FlopCounterMode``) and the bytes its aten ops read and write (each op's
  tensor inputs and outputs, views excluded: what XLA's "bytes accessed"
  sums per HLO op), plus the FLOPs and bytes that each hand-written kernel
  launch reports (:mod:`repro_torch.kernels._cost`; a ``ctypes`` launch is
  no aten op), into FLOPs / bytes-accessed gauges.

:func:`save_profiles` writes the collected profiles as ``profile.json``.

:class:`ProfileSteps` runs a window of a step callable's calls under
``torch.profiler`` and writes the profiler's Chrome export: the device's
kernels, the host's ops, the program's ranges (``trace.range``) and the
recorder's spans, on one clock.

Synchronising makes the wrapper a synchronization point, so the hooks are
opt-in (the launchers enable them only under ``--trace-dir``); results are
bit-identical either way.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..kernels import _cost
from .metrics import MetricsRegistry
from .trace import NULL_TRACER

__all__ = ["ProfileSteps", "ProfiledFn", "profile_jit", "save_profiles"]

STEP_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                2.5, 5.0, 15.0, 60.0)


@dataclasses.dataclass
class _Stats:
    compile_s: float | None = None
    calls: int = 0               # steady-state calls (first call excluded)
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0
    flops: float | None = None
    bytes_accessed: float | None = None


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _sync(out) -> None:
    """Wait for the CUDA devices that hold ``out``'s tensors."""
    for dev in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class _BytesMode(TorchDispatchMode):
    """Sums each aten op's tensor input and output bytes; ops whose output
    aliases an input (views) and allocations (``empty*``) move none."""

    _FREE = ("empty", "empty_like", "empty_strided")

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.overloadpacket.__name__ in self._FREE):
            self.bytes += sum(t.numel() * t.element_size() for t in
                              _tensors((args, kwargs or {}, out)))
        return out


class ProfiledFn:
    """A step callable wrapped with wall-time + first-call-time recording."""

    def __init__(self, fn, *, name: str, registry: MetricsRegistry | None,
                 tracer=None, clock=time.perf_counter):
        self.fn = fn
        self.name = name
        self.registry = registry or MetricsRegistry()
        self.tracer = tracer or NULL_TRACER
        self.clock = clock
        self.stats = _Stats()
        self._g_compile = self.registry.gauge(
            "profile_compile_seconds",
            "first-call (kernel build and load) wall time per step fn",
            ("step",))
        self._h_step = self.registry.histogram(
            "profile_step_seconds",
            "steady-state per-call wall time per step fn", ("step",),
            buckets=STEP_BUCKETS)
        self._g_flops = self.registry.gauge(
            "profile_step_flops",
            "counted FLOPs per call of the step fn (aten ops and kernel "
            "launches)", ("step",))
        self._g_bytes = self.registry.gauge(
            "profile_step_bytes_accessed",
            "counted bytes accessed per call (aten ops and kernel launches)",
            ("step",))

    def __call__(self, *args, **kwargs):
        t0 = self.clock()
        out = self.fn(*args, **kwargs)
        _sync(out)
        dt = self.clock() - t0
        st = self.stats
        if st.compile_s is None:
            st.compile_s = dt
            self._g_compile.set(dt, step=self.name)
            self.tracer.event("profile.compile", step=self.name, seconds=dt)
        else:
            st.calls += 1
            st.total_s += dt
            st.min_s = min(st.min_s, dt)
            st.max_s = max(st.max_s, dt)
            self._h_step.observe(dt, step=self.name)
        return out

    # -- cost -----------------------------------------------------------------
    def capture_cost(self, *args, **kwargs) -> dict:
        """Run the call once on these arguments and record its FLOPs and
        bytes accessed: aten ops counted by dispatch modes, hand-written
        kernels by their own reports.  Returns ``{"flops", "bytes
        accessed", "aten_flops", "aten_bytes", "kernels"}``."""
        flop_mode, bytes_mode = FlopCounterMode(display=False), _BytesMode()
        with _cost.capture() as kernels, flop_mode, bytes_mode:
            out = self.fn(*args, **kwargs)
        _sync(out)
        aten_flops = float(flop_mode.get_total_flops())
        aten_bytes = float(bytes_mode.bytes)
        flops = aten_flops + sum(k["flops"] for k in kernels.values())
        nbytes = aten_bytes + sum(k["bytes"] for k in kernels.values())
        self.stats.flops = flops
        self.stats.bytes_accessed = nbytes
        self._g_flops.set(flops, step=self.name)
        self._g_bytes.set(nbytes, step=self.name)
        return {"flops": flops, "bytes accessed": nbytes,
                "aten_flops": aten_flops, "aten_bytes": aten_bytes,
                "kernels": kernels}

    def report(self) -> dict:
        st = self.stats
        mean = st.total_s / st.calls if st.calls else None
        return {
            "name": self.name,
            "compile_s": st.compile_s,
            "calls": st.calls,
            "total_s": st.total_s,
            "mean_s": mean,
            "min_s": None if st.calls == 0 else st.min_s,
            "max_s": None if st.calls == 0 else st.max_s,
            "flops": st.flops,
            "bytes_accessed": st.bytes_accessed,
            "achieved_flops_per_s": (st.flops / mean
                                     if st.flops and mean else None),
        }


def profile_jit(fn, *, name: str, registry: MetricsRegistry | None = None,
                tracer=None, clock=time.perf_counter) -> ProfiledFn:
    """Wrap a step callable with first-call/step wall-time recording (the
    JAX package's name, kept for its callers)."""
    return ProfiledFn(fn, name=name, registry=registry, tracer=tracer,
                      clock=clock)


def save_profiles(path: str, profiled: list[ProfiledFn]) -> str:
    """Write ``[ProfiledFn.report(), ...]`` as the ``profile.json``
    artifact."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump([p.report() for p in profiled], f, indent=1,
                  sort_keys=True)
    return path


class ProfileSteps:
    """A step callable whose calls ``first`` to ``last`` (counted from 0,
    replays after a restore included) run under ``torch.profiler``: CPU
    activity, and CUDA where a card is present.  The profiler starts as
    call ``first`` begins and stops when call ``last`` has returned and its
    outputs' devices are synchronised, so what runs between those calls
    (the loss's copy, checkpoint saves) is in the window too; the Chrome
    trace is then written to ``path`` (returned by :meth:`close`, which
    also ends a window the run left open)."""

    def __init__(self, fn, first: int, last: int, path: str):
        self.fn, self.first, self.last, self.path = fn, first, last, path
        self.calls = 0
        self.written: str | None = None
        self._prof = None

    def __call__(self, *args, **kwargs):
        i = self.calls
        self.calls += 1
        if i == self.first:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        out = self.fn(*args, **kwargs)
        if i == self.last:
            self.close(out)
        return out

    def close(self, out=None) -> str | None:
        """Stop a window that is open and write its trace."""
        if self._prof is not None:
            if out is not None:
                _sync(out)
            elif torch.cuda.is_available():
                torch.cuda.synchronize()
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            prof.export_chrome_trace(self.path)
            self.written = self.path
        return self.written
