"""repro_torch.obs — the span tracer and the metrics registry.

Copies of ``repro.obs.trace`` and ``repro.obs.metrics``.  The flight
recorder, the profiling hooks and the ``--trace*`` launcher flags wait for a
later slice.
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import NULL_TRACER, Span, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NULL_TRACER", "Span", "Tracer"]
