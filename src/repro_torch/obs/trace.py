"""Zero-dependency structured span tracer.

The tracing unit is a *span* — a named interval with monotonic-clock
timestamps, key/value attributes, and a parent link (nesting follows the
tracer's span stack).  Point-in-time *events* hang off the current span.
Completed spans and events are emitted as plain dicts into a
:class:`~repro.obs.recorder.FlightRecorder` ring buffer (or any object with
a ``record(dict)`` method), so the tracer itself holds no history.

Two properties the fault-tolerance layers rely on:

* **off-hot-path when disabled** — :data:`NULL_TRACER` (and any tracer
  constructed with ``enabled=False``) answers every call with a cached
  no-op: ``span()`` costs one branch and returns a shared null context
  manager, ``event()``/``fault()``/``recovery()`` return immediately.
  Instrumented code therefore never needs ``if tracer is not None`` guards;
* **deterministic timestamps on demand** — the clock is injectable
  (``clock=``), so tests drive spans with a fake counter and dumps become
  byte-stable.

Span names form the witness vocabulary of the fault taxonomy (see the
Observability section of ROADMAP.md): every recovery path emits a
``recover.<fault_kind>`` annotation via :meth:`Tracer.recovery`, and every
injected fault a ``fault.<fault_kind>`` annotation via :meth:`Tracer.fault`
— both of which also arm the flight recorder's dump-on-fault trigger.
"""
from __future__ import annotations

import time

__all__ = ["Span", "Tracer", "NULL_TRACER"]


class _NullSpan:
    """Shared no-op span: context manager + attribute sink."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class Span:
    """One live span.  Use as a context manager; emitted on exit."""

    __slots__ = ("tracer", "name", "track", "attrs", "span_id", "parent_id",
                 "t0", "t1")

    def __init__(self, tracer: "Tracer", name: str, track: str,
                 attrs: dict, span_id: int, parent_id: int | None):
        self.tracer = tracer
        self.name = name
        self.track = track
        self.attrs = attrs
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = 0.0
        self.t1 = 0.0

    def set(self, **attrs) -> "Span":
        """Attach attributes mid-span (e.g. an outcome discovered late)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self.t0 = self.tracer.clock()
        self.tracer._stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1 = self.tracer.clock()
        stack = self.tracer._stack
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self.tracer._emit({
            "type": "span", "name": self.name, "track": self.track,
            "t0": self.t0, "t1": self.t1, "span_id": self.span_id,
            "parent_id": self.parent_id, "attrs": self.attrs,
        })
        return False


class Tracer:
    """Emits spans/events into a recorder.  Disabled = one-branch no-op."""

    def __init__(self, recorder=None, *, clock=time.monotonic,
                 enabled: bool = True):
        self.recorder = recorder
        self.clock = clock
        self.enabled = enabled and recorder is not None
        self._stack: list[Span] = []
        self._next_id = 1

    # -- emission -------------------------------------------------------------
    def _emit(self, rec: dict) -> None:
        if self.recorder is not None:
            self.recorder.record(rec)

    def _ids(self) -> tuple[int, int | None]:
        sid = self._next_id
        self._next_id += 1
        parent = self._stack[-1].span_id if self._stack else None
        return sid, parent

    # -- spans ----------------------------------------------------------------
    def span(self, name: str, *, track: str = "main", **attrs):
        """Open a nested span (context manager)."""
        if not self.enabled:
            return _NULL_SPAN
        sid, parent = self._ids()
        return Span(self, name, track, attrs, sid, parent)

    def complete(self, name: str, t0: float, t1: float, *,
                 track: str = "main", **attrs) -> None:
        """Emit an already-timed span directly, bypassing the span stack.

        The thread-safe entry point: the async checkpoint writer times its
        own interval and reports it here without touching the (single-
        threaded) nesting stack."""
        if not self.enabled:
            return
        sid = self._next_id
        self._next_id += 1
        self._emit({"type": "span", "name": name, "track": track,
                    "t0": t0, "t1": t1, "span_id": sid, "parent_id": None,
                    "attrs": attrs})

    # -- point events ---------------------------------------------------------
    def event(self, name: str, *, track: str = "main", **attrs) -> None:
        if not self.enabled:
            return
        sid, parent = self._ids()
        self._emit({"type": "event", "name": name, "track": track,
                    "t": self.clock(), "span_id": sid, "parent_id": parent,
                    "attrs": attrs})

    # -- fault / recovery annotations (flight-recorder triggers) --------------
    def fault(self, kind: str, *, step: int | None = None, **attrs) -> None:
        """Annotate an injected/observed fault: emits ``fault.<kind>`` and
        arms the recorder's dump-on-fault trigger."""
        if not self.enabled:
            return
        self.event(f"fault.{kind}", step=step, **attrs)
        if self.recorder is not None:
            self.recorder.on_fault(kind, step=step)

    def recovery(self, kind: str, **attrs) -> None:
        """Annotate a recovery path being taken: emits ``recover.<kind>``
        and triggers a flight-recorder dump (the dump that *contains* the
        recovery spans, unlike the at-fault dump which shows the lead-up)."""
        if not self.enabled:
            return
        self.event(f"recover.{kind}", **attrs)
        if self.recorder is not None:
            self.recorder.on_recovery(kind)


#: the canonical disabled tracer — safe default for every instrumented layer
NULL_TRACER = Tracer(None, enabled=False)
