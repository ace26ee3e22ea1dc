"""Finds a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names the cells
(``workloads``), the configurations and the metrics.  Every other part is a
file of its own under ``port_bench/``, found by name:

- ``configs/<config>.json`` (the file ``BENCHMARK.json`` gives): the
  configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix, whose ``driver`` names
  ``drivers/<driver>.py``, the adapter to the program;
- ``metrics/<metric>.py``: one reader a metric (``read(run)``);
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``;
- ``reference/<name>.py``: a plain reference, named by a configuration's
  ``reference`` key, and the one place the harness asks about an
  architecture: beside the reference itself it may define the hooks
  ``ARCH_KEYS``, ``leaf_specs``, ``forward_flops``, ``attention_layers``
  and ``moe_layers``, which :mod:`port_bench.arch` resolves, each against
  the decoder-only llama tree's default.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["HERE", "ROOT", "benchmark", "cell", "config", "traffic",
           "limits", "metrics_of", "reader", "module"]


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; there are: "
                   + ", ".join(e["name"] for e in entries))


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(cell_name: str) -> dict:
    with open(HERE / "limits" / f"{cell_name}.json") as f:
        return json.load(f)


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with ``trace`` on (a metric with a
    ``workloads`` key only in the cells it lists)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if cell_name in m.get("workloads", [cell_name])]


def module(kind: str, name: str):
    """``port_bench/<kind>/<name>.py``, imported once."""
    path = HERE / kind / f"{name}.py"
    mod_name = f"port_bench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    return module("metrics", metric).read
