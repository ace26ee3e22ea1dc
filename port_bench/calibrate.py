"""The readings that a cell's limits are set from (a card tool; the
benchmark's own runs do not run it).

    python3 port_bench/calibrate.py --workload olmo1b-train-8x2048 \\
        --seeds 101-112 --control-seeds 201-203 --fault-seeds 301-303 \\
        --out chiprun_out/calibrate-olmo.jsonl

In one process, for each seed: the program's set-up steps against the
plain reference (the lower reading: sound runs); the control, the
reference with its products in fp8 (:func:`reference.decoder.fp8_mm`), put
in the program's place (the upper reading); and the program with half of
each batch left out, the mean taken over the rest (a fault).  A state
left unchanged reads 1 by the comparison's measure and needs no run.  Each
reading is one JSON line (to ``--out`` and standard output), with the
reference's seconds and the peak of device memory.
"""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

from port_bench import harness, judge, spec  # noqa: E402
from port_bench.model import load  # noqa: E402


def seeds(text: str) -> list[int]:
    """"1-3,7" -> [1, 2, 3, 7]."""
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def program_readings(driver, m, traffic, seed, half: bool):
    import torch
    torch.use_deterministic_algorithms(True)
    system = driver.System(m, traffic, seed, "cuda")
    if half:
        call = system.call
        rows = int(traffic["batch"]) // 2
        system.call = lambda batch: call({k: v[:rows]
                                          for k, v in batch.items()})
    readings = system.setup_steps()
    system.close()
    del system
    _free()
    torch.use_deterministic_algorithms(False)
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 port_bench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--fp32-seeds", default="",
                    help="the program computing in fp32 (a second witness)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.launch.train import make_deterministic
    make_deterministic()
    harness._cache_dirs(str(spec.ROOT))
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    m = load(cell["config"], spec.config(bench, cell["config"]))
    traffic = spec.traffic(cell["traffic"])
    driver = spec.module("drivers", traffic["driver"])
    out = open(args.out, "a") if args.out else None
    jobs = ([("program", s) for s in seeds(args.seeds)]
            + [("control", s) for s in seeds(args.control_seeds)]
            + [("half_batch", s) for s in seeds(args.fault_seeds)]
            + [("program_fp32", s) for s in seeds(args.fp32_seeds)])
    for kind, seed in jobs:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        if kind == "control":
            prog = driver.reference_readings(m, traffic, seed, "cuda", "fp8")
        else:
            pm = (dataclasses.replace(m, compute_dtype="float32")
                  if kind == "program_fp32" else m)
            prog = program_readings(driver, pm, traffic, seed,
                                    kind == "half_batch")
        t1 = time.perf_counter()
        peak_prog = torch.cuda.max_memory_allocated()
        _free()
        torch.cuda.reset_peak_memory_stats()
        ref = driver.reference_readings(m, traffic, seed, "cuda",
                                        routes=prog.get("routes"))
        t2 = time.perf_counter()
        rd = judge.compare(prog, ref)
        line = {"workload": args.workload, "kind": kind, "seed": seed,
                **rd, "program_s": t1 - t0, "reference_s": t2 - t1,
                "peak_gb": peak_prog / 1e9,
                "reference_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "losses": prog["losses"], "ref_losses": ref["losses"],
                "grad_norms": [prog["grad_norms"], ref["grad_norms"]],
                "delta_norms": [prog["delta_norms"], ref["delta_norms"]]}
        _free()
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    if out:
        out.close()
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
