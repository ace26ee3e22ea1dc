"""Runs one cell of ``BENCHMARK.json`` and prints its result line.

A run, in order:

1. set-up (``setup_s``, from the process's start): the cell's parts by
   name (:mod:`port_bench.spec`), the program's build and kernel caches in
   fixed directories of the checkout, deterministic kernels (the
   launcher's ``make_deterministic``), the traffic's driver
   (``drivers/<driver>.py``) building the system under test from
   ``--seed``, and its first steps through the window's own call, which
   warm every shape and give the program's side of the comparison;
2. the window (set-up's objects frozen out of the garbage collector's
   full collections): the system called step after step for
   ``--seconds``; with
   ``--trace 1`` a few of its steps are recorded by ``torch.profiler``
   (:mod:`port_bench.trace`);
3. after it: the peak of device memory over the window, the program's
   state freed, the plain reference run on the same seed, the comparison
   (:mod:`port_bench.judge`), the metrics (``metrics/<name>.py``), and a
   check that no module of JAX or of the JAX package ``repro`` was loaded.

The last line of standard output is the JSON result; the numbers compared
are the last lines of standard error and the result's last key,
``checks``.  Exits 2 without a card (or with fewer than the cell asks
for), 3 if a forbidden module was loaded; neither prints a result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import sys
import time

from . import judge, spec, trace as tr
from .model import Model, load

__all__ = ["FORBIDDEN", "Run", "forbidden_modules", "main", "run_cell"]

#: top-level module names no run may load (compared whole: ``repro_torch``
#: is the program, ``repro`` the JAX package)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``: ``read(run)``,
    ``None`` where there is nothing to read)."""
    model: Model
    traffic: dict
    kind: str
    setup_s: float
    window_s: float
    steps: int
    tokens: int
    peak_bytes: int
    trace: tr.Trace | None


def _cache_dirs(root) -> None:
    """The build and kernel caches at fixed paths of the checkout (the
    port's nvcc builds go to ``build/kernels`` of the checkout itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "build", sub)


def _window(system, seconds: float, trace_steps: int, sync, t0: float):
    """Steps for ``seconds`` from ``t0``; with ``trace_steps`` the first of
    them under the profiler (one outside the traced range, then
    ``trace_steps`` inside it).  Returns (steps, failed, end time,
    trace)."""
    steps = failed = 0
    traced = None

    def step(enq=None):
        nonlocal steps, failed
        batch = system.next_batch()
        a = time.perf_counter()
        state, loss_t = system.call(batch)
        if enq is not None:
            enq.append(time.perf_counter() - a)
        if math.isfinite(float(loss_t)):
            system.adopt(state)
        else:
            failed += 1
        steps += 1

    if trace_steps:
        from torch.profiler import ProfilerActivity, profile, record_function
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            enq: list = []
            with record_function(tr.WINDOW):
                for _ in range(trace_steps):
                    with record_function("pb.step"):
                        step(enq)
                sync()
        traced = (prof, trace_steps, enq)
    while time.perf_counter() - t0 < seconds:
        step()
    sync()
    end = time.perf_counter()
    if traced is not None:
        traced = tr.reduce(*traced)
    return steps, failed, end, traced


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, *, t_start: float, device: str = "cuda",
             model_overrides=None, traffic_overrides=None
             ) -> tuple[dict, dict]:
    """(result line, the comparison's readings) of one run of cell
    ``name``.  ``device`` "cpu" and the overrides serve the CPU tests."""
    import torch
    cell = spec.cell(bench, name)
    m = load(cell["config"], spec.config(bench, cell["config"]),
             **(model_overrides or {}))
    traffic = dict(spec.traffic(cell["traffic"]), **(traffic_overrides or {}))
    driver = spec.module("drivers", traffic["driver"])
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        from repro_torch.launch.train import make_deterministic
        make_deterministic()
    system = driver.System(m, traffic, seed, device)
    prog = system.setup_steps()
    # what set-up made is kept out of the collector's reach in the window:
    # a full collection there would otherwise walk every object of torch,
    # the program and the harness (~230 ms, every ~15 steps of the MoE
    # cell, on the card's host), a pause that is neither the program's
    # work nor steady
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    steps, failed, end, traced = _window(
        system, seconds, int(traffic["trace_steps"]) if trace else 0, sync,
        t0)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    tokens = (steps - failed) * system.tokens_per_step
    system.close()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(False)
    ref = driver.reference_readings(m, traffic, seed, device,
                                    routes=prog.get("routes"))
    readings = judge.compare(prog, ref)
    correct, checks = judge.judge(readings, spec.limits(name))
    run = Run(model=m, traffic=traffic, kind=kind, setup_s=t0 - t_start,
              window_s=end - t0, steps=steps, tokens=tokens,
              peak_bytes=peak, trace=traced)
    metrics = {}
    for entry in spec.metrics_of(bench, name, trace):
        value = spec.reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct) and failed == 0, "attempted": steps,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    result["checks"]["failed_steps"] = {"value": failed, "limit": 0}
    return result, readings


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 port_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, *, t_start: float) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    _cache_dirs(str(spec.ROOT))
    result, _ = run_cell(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

