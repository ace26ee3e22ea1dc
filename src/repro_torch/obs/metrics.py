"""Unified metrics registry: counters / gauges / histograms with labels.

One registry per run absorbs what used to be ad-hoc Python ints scattered
across ``serve/metrics.py``, the training coordinator, and the cross-pod
cluster: an instrument is registered once by name and then incremented with
optional label key/values, so ``serve_drops_total{reason="shed"}`` and
``serve_drops_total{reason="rejected_on_arrival"}`` are two series of one
counter instead of two unrelated attributes.

Exporters:

* :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
  format (``# HELP`` / ``# TYPE`` + escaped label values; histograms as
  cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count``);
* :meth:`MetricsRegistry.to_json` — nested plain dict, JSON-stable
  (sorted series keys);
* :meth:`MetricsRegistry.write` — both files into a directory (the
  launchers call it with the trace dir at run end).

Everything is plain Python floats and dicts — no dependencies, no
background threads, safe to leave enabled in hot paths (one dict lookup +
float add per increment).
"""
from __future__ import annotations

import json
import os

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "escape_label_value", "escape_help"]

DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def escape_help(v: str) -> str:
    """Prometheus HELP escaping: backslash and newline only."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _label_key(labelnames: tuple, labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"expected labels {sorted(labelnames)}, got {sorted(labels)}")
    return tuple((k, str(labels[k])) for k in labelnames)


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.series: dict[tuple, float] = {}

    def value(self, **labels) -> float:
        return self.series.get(_label_key(self.labelnames, labels), 0.0)

    def total(self) -> float:
        return sum(self.series.values())

    def _series_name(self, key: tuple) -> str:
        if not key:
            return self.name
        inner = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in key)
        return f"{self.name}{{{inner}}}"

    def prom_lines(self) -> list[str]:
        return [f"{self._series_name(key)} {self.series[key]}"
                for key in sorted(self.series)]

    def to_json(self) -> dict:
        return {("|".join(f"{k}={v}" for k, v in key) if key else ""):
                self.series[key] for key in sorted(self.series)}


class Counter(_Instrument):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        self.series[key] = self.series.get(key, 0.0) + amount

    def set(self, value: float, **labels) -> None:
        """Direct set — the legacy-attribute compatibility shim's hook
        (``metrics.shed += 1`` reads then writes the series value)."""
        self.series[_label_key(self.labelnames, labels)] = float(value)


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self.series[_label_key(self.labelnames, labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        self.series[key] = self.series.get(key, 0.0) + amount


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name, help, labelnames,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        # series value = observation count; detail per key below
        self._bucket_counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        counts = self._bucket_counts.setdefault(
            key, [0] * (len(self.buckets) + 1))
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        self._sums[key] = self._sums.get(key, 0.0) + float(value)
        self.series[key] = self.series.get(key, 0.0) + 1.0

    def sum(self, **labels) -> float:
        return self._sums.get(_label_key(self.labelnames, labels), 0.0)

    def prom_lines(self) -> list[str]:
        lines = []
        for key in sorted(self.series):
            counts = self._bucket_counts[key]
            cum = 0
            for i, ub in enumerate(self.buckets):
                cum += counts[i]
                bkey = key + (("le", repr(float(ub))),)
                lines.append(
                    f"{self.name}_bucket{{"
                    + ",".join(f'{k}="{escape_label_value(v)}"'
                               for k, v in bkey) + f"}} {cum}")
            cum += counts[-1]
            bkey = key + (("le", "+Inf"),)
            lines.append(
                f"{self.name}_bucket{{"
                + ",".join(f'{k}="{escape_label_value(v)}"'
                           for k, v in bkey) + f"}} {cum}")
            inner = ",".join(f'{k}="{escape_label_value(v)}"'
                             for k, v in key)
            braces = f"{{{inner}}}" if key else ""
            lines.append(f"{self.name}_sum{braces} {self._sums[key]}")
            lines.append(f"{self.name}_count{braces} "
                         f"{int(self.series[key])}")
        return lines

    def to_json(self) -> dict:
        out = {}
        for key in sorted(self.series):
            skey = "|".join(f"{k}={v}" for k, v in key) if key else ""
            out[skey] = {
                "count": int(self.series[key]),
                "sum": self._sums[key],
                "buckets": {repr(float(ub)): c for ub, c in
                            zip(self.buckets, self._bucket_counts[key])},
                "inf": self._bucket_counts[key][-1],
            }
        return out


class MetricsRegistry:
    """Name -> instrument map.  Re-registering a name returns the existing
    instrument (so independent modules can share series); a kind mismatch
    is an error."""

    def __init__(self) -> None:
        self._instruments: dict[str, _Instrument] = {}

    def _get_or_make(self, cls, name, help, labelnames, **kw):
        inst = self._instruments.get(name)
        if inst is not None:
            if not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}")
            return inst
        inst = cls(name, help, tuple(labelnames), **kw)
        self._instruments[name] = inst
        return inst

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help, labelnames,
                                 buckets=buckets)

    def get(self, name: str) -> _Instrument | None:
        return self._instruments.get(name)

    def value(self, name: str, **labels) -> float:
        inst = self._instruments.get(name)
        return 0.0 if inst is None else inst.value(**labels)

    # -- exporters ------------------------------------------------------------
    def to_prometheus(self) -> str:
        lines = []
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if inst.help:
                lines.append(f"# HELP {name} {escape_help(inst.help)}")
            lines.append(f"# TYPE {name} {inst.kind}")
            lines.extend(inst.prom_lines())
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> dict:
        return {name: {"kind": inst.kind, "help": inst.help,
                       "series": inst.to_json()}
                for name, inst in sorted(self._instruments.items())}

    def write(self, out_dir: str) -> tuple[str, str]:
        """Write ``metrics.json`` + ``metrics.prom`` into ``out_dir``."""
        os.makedirs(out_dir, exist_ok=True)
        jpath = os.path.join(out_dir, "metrics.json")
        with open(jpath, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        ppath = os.path.join(out_dir, "metrics.prom")
        with open(ppath, "w") as f:
            f.write(self.to_prometheus())
        return jpath, ppath
