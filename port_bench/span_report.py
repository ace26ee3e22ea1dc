"""A cell's traced window attributed to the program's ranges
(:mod:`port_bench.spans`), printed as one JSON line.

    python3 -m port_bench.span_report --workload granitemoe1b-train-8x2048 \\
        --seed 7 [--out chiprun_out/spans.json]

Builds the cell as a run of the harness does (:func:`port_bench.harness.
run_cell`'s set-up: the driver's system from ``--seed``, its warm-up steps,
``gc.freeze()``), then records one step and the traffic's ``trace_steps``
steps inside the window's range, as the harness's ``--trace 1`` run does.
It prints the per-step numbers of :func:`spans.step_metrics` (the
harness's per-layer readers read the same from ``Trace.spans``), the host
seconds of the harness's reduction of the window with its attribution
(``reduce_s``), the harness's busy and idle time of the window, the top
ranges by device and by idle seconds, two checks of the attribution (the
phases' share of the kernels' device time, and of all device operations';
the share of the experts' batched products, forward and backward, that
lands in ``moe.experts``) and the host cost of a range (nanoseconds a
call, with no profiler and under one).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time


def _range_cost(n: int = 200_000) -> dict:
    """Host ns a ``with range(...)`` block: off, and under a CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace

    def loop(k):
        t = time.perf_counter()
        for _ in range(k):
            with trace.range("bench.range"):
                pass
        return 1e9 * (time.perf_counter() - t) / k

    off = min(loop(n) for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU]):
        on = loop(n // 20)
    return {"range_off_ns": off, "range_on_ns": on}


def _experts_share(device, host, window) -> float | None:
    """Share of the device time of the kernels that ``aten::bmm`` launched
    (outside a node) or a ``BmmBackward0`` node launched, that the
    attribution puts under ``moe.experts``."""
    from . import spans as sp
    lo, hi = window
    index = sp.Index(host)
    runtime = {h.corr: h for h in host if h.name.startswith("cu")}
    ops = {h.corr: h for h in host
           if not h.name.startswith("cu") and h.kind != sp.RANGE}
    total = under = 0.0
    for d in device:
        a, b = max(d.start, lo), min(d.end, hi)
        call = runtime.get(d.corr)
        if b <= a or call is None:
            continue
        site = index.innermost(call.thread, call.start)
        op = ops.get(call.link)
        node = site is not None and site.name.startswith(sp.AUTOGRAD_NODE)
        if (node and site.name.endswith("BmmBackward0")) or (
                not node and op is not None and op.name == "aten::bmm"):
            total += b - a
            if "moe.experts" in index.chain(index.resolve(site)):
                under += b - a
    return under / total if total else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.span_report")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import harness, spec, spans as sp, trace as tr
    from .model import load
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    harness._cache_dirs(str(spec.ROOT))
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    m = load(cell["config"], spec.config(bench, cell["config"]))
    traffic = spec.traffic(cell["traffic"])
    driver = spec.module("drivers", traffic["driver"])
    from repro_torch.launch.train import make_deterministic
    make_deterministic()
    system = driver.System(m, traffic, args.seed, "cuda")
    system.setup_steps()
    gc.collect()
    gc.freeze()
    n = int(traffic["trace_steps"])
    enq: list = []

    def step(times=None):
        batch = system.next_batch()
        a = time.perf_counter()
        state, loss_t = system.call(batch)
        if times is not None:
            times.append(time.perf_counter() - a)
        if math.isfinite(float(loss_t)):
            system.adopt(state)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        with record_function(tr.WINDOW):
            for _ in range(n):
                with record_function("pb.step"):
                    step(enq)
            torch.cuda.synchronize()
    gc.unfreeze()
    t0 = time.perf_counter()
    trace = tr.reduce(prof, n, enq)          # the harness's reduction
    reduce_s = time.perf_counter() - t0
    spans = trace.spans
    device, host, window = sp.events_of(prof)
    kernels = trace.seconds(lambda k: tr.group(k) != "copy")
    only = sp.attribute([d for d in device if tr.group(d.name) != "copy"],
                        host, window)

    def phases(got):
        return sum(got[p].device_s for p in
                   ("train.forward", "train.backward", "train.optimizer")
                   if p in got)

    out = {
        "workload": args.workload, "seed": args.seed, "steps": n,
        "card": torch.cuda.get_device_name(0),
        "metrics": sp.step_metrics(spans, n),
        "enqueue_ms": 1e3 * sum(enq) / len(enq),
        "window_ms": 1e3 * trace.window_s / n,
        "busy_ms": 1e3 * trace.busy_s / n,
        "device_ms": 1e3 * trace.seconds(lambda k: True) / n,
        "kernel_ms": 1e3 * kernels / n,
        "idle_share": (trace.window_s - trace.busy_s) / trace.window_s,
        # the phases' kernels over all kernels; their operations over all
        "phases_of_kernels": phases(only) / kernels if kernels else None,
        "phases_of_device": phases(spans) / trace.seconds(lambda k: True),
        "experts_share": _experts_share(device, host, window),
        "spans": sp.top(spans, "device_s", 40),
        "idle_spans": sp.top(spans, "idle_s", 15),
        "self_host_ms": {k: 1e3 * v.self_s / n for k, v in spans.items()},
        "reduce_s": reduce_s,
        **_range_cost(),
    }
    system.close()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    _root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [_root, os.path.join(_root, "src")]
    sys.exit(main())
