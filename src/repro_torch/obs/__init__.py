"""repro_torch.obs — flight-recorder tracing, unified metrics, profiling
hooks (counterpart of ``repro.obs``).

The observability subsystem that makes the fault-taxonomy recovery paths
*witnessable* instead of merely survivable:

``trace.py``
    Structured span tracer: nested spans with monotonic-clock timestamps
    (injectable for determinism), per-event attributes, and
    ``fault.<kind>`` / ``recover.<kind>`` annotations.
    :data:`NULL_TRACER` is the always-safe disabled default — one branch on
    the hot path, no allocation.  ``trace.range(name)`` is the profiler
    mirror: a range on ``torch.profiler``'s timeline (the device trace's
    clock) while a profiler records, the shared null span after one
    attribute read otherwise.  The train step's phases, its layers and the
    MoE layer's stages are marked so (``train.*``, ``lm.*``, ``layer.*``,
    ``moe.*``), and an enabled tracer's spans open the same range; ranges
    never reach the recorder.

``recorder.py``
    Bounded flight-recorder ring buffer; dumps the last-N-seconds window as
    JSONL + Chrome ``trace_event`` JSON whenever a fault fires or a
    recovery path is taken (``dump_on_fault``), capped per run.  The dumps
    have the JAX package's format: each package's validator reads the
    other's.

``metrics.py``
    Unified counters/gauges/histograms with labeled series, Prometheus-text
    and JSON exporters.  Absorbs ``serve/metrics.py`` and the training
    coordinator's inline counters behind one API.

``profile.py``
    Wraps step functions: first-call time (the kernels' build and load on
    the card), per-step wall time, and ``capture_cost``'s FLOPs and bytes
    (aten ops by dispatch modes, hand-written kernels by their own
    reports); :class:`ProfileSteps` records a window of steps under
    ``torch.profiler`` into a Chrome trace (the train launcher's
    ``--profile-steps``).

``validate.py``
    Dump schema validation + required-span assertions
    (``python -m repro_torch.obs.validate DIR --require-span NAME``).

The launchers build one :class:`ObsContext` via :func:`setup` from their
``--trace-dir`` / ``--trace-dump-on-fault`` flags and thread
``ctx.tracer`` / ``ctx.registry`` through the engine, coordinator, cluster,
checkpoint store and chaos engine.  With no trace dir everything collapses
to :data:`NULL_TRACER` and a detached registry: a traced run ends
bit-identical to an untraced one, and the disabled recorder costs one
branch per call site.
"""
from __future__ import annotations

import dataclasses
import time

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .profile import ProfiledFn, ProfileSteps, profile_jit, save_profiles
from .recorder import FlightRecorder, load_jsonl, to_chrome
from .trace import NULL_TRACER, Span, Tracer

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "ObsContext",
    "ProfileSteps",
    "ProfiledFn",
    "Span",
    "Tracer",
    "load_jsonl",
    "profile_jit",
    "save_profiles",
    "setup",
    "to_chrome",
]


@dataclasses.dataclass
class ObsContext:
    """One run's observability handles (tracer + recorder + registry)."""

    tracer: Tracer
    recorder: FlightRecorder | None
    registry: MetricsRegistry

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled

    def finish(self, label: str = "run_end") -> str | None:
        """Final dump + metrics export into the trace dir (no-op when
        tracing is disabled).  Returns the JSONL dump path."""
        if self.recorder is None or self.recorder.out_dir is None:
            return None
        path = self.recorder.dump(label)
        self.registry.write(self.recorder.out_dir)
        return path


def setup(trace_dir: str | None = None, *, dump_on_fault: bool = False,
          capacity: int = 8192, window_s: float | None = None,
          max_dumps: int = 64, clock=time.monotonic,
          registry: MetricsRegistry | None = None) -> ObsContext:
    """Build an :class:`ObsContext`.  ``trace_dir=None`` disables tracing
    (NULL tracer, no recorder) but still returns a live registry."""
    registry = registry or MetricsRegistry()
    if trace_dir is None:
        return ObsContext(tracer=NULL_TRACER, recorder=None,
                          registry=registry)
    recorder = FlightRecorder(capacity, out_dir=trace_dir,
                              window_s=window_s,
                              dump_on_fault=dump_on_fault,
                              max_dumps=max_dumps, clock=clock)
    return ObsContext(tracer=Tracer(recorder, clock=clock),
                      recorder=recorder, registry=registry)
