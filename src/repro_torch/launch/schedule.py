"""CRCH workflow scheduling end to end (the paper's core use case).

Counterpart of ``examples/schedule_workflow.py``: generates a scientific
workflow, learns replication counts with PCA + triplet-loss clustering (PCA
and the distance kernel on ``--device``), schedules with over-provisioned
HEFT, simulates execution under the chosen failure environment and compares
against plain HEFT and ReplicateAll(3).  Runs on the GPU unless ``--device
cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.schedule --workflow montage \\
        --size 700 --env unstable [--runs 10] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import (CloudEnvironment, aggregate, baselines,
                    generate_workflow, metrics_from_result, plan,
                    sample_failure_trace, sim_config, simulate)


def setup(kind: str, size: int):
    """The workflow and its 20-VM pool, seeded as the example's."""
    wf = generate_workflow(kind, size, seed=1)
    return wf, CloudEnvironment(wf, n_vms=20, seed=2)


def evaluate(wf, env, envname: str, runs: int, *, device="cuda"):
    """Plan CRCH on ``device`` and simulate CRCH, HEFT and ReplicateAll(3)
    over ``runs`` failure traces (horizon 40 x makespan, seeds 100 + i, as
    the example).  Returns the plan and, per algorithm, the aggregate
    metrics with the simulations' host seconds (``wall_s``)."""
    p = plan(wf, env, environment=envname, device=device)
    algos = {
        "CRCH": (p.schedule, sim_config(p)),
        "HEFT": (baselines.heft_plan(wf, env), baselines.heft_sim_config()),
        "ReplicateAll(3)": (baselines.replicate_all_plan(wf, env, 3),
                            baselines.replicate_all_sim_config()),
    }
    out = {}
    for name, (sched, scfg) in algos.items():
        results = []
        t0 = time.perf_counter()
        for i in range(runs):
            tr = sample_failure_trace(envname, env.n_vms,
                                      horizon_s=40 * sched.makespan,
                                      seed=100 + i)
            results.append(metrics_from_result(sched,
                                               simulate(sched, tr, scfg)))
        agg = aggregate(results)
        agg["wall_s"] = time.perf_counter() - t0
        out[name] = agg
    return p, out


def table(results: dict) -> list[str]:
    lines = [f"{'algo':16s} {'ok':>5s} {'TET':>8s} {'usage/TET':>10s} "
             f"{'waste/TET':>10s} {'SLR':>6s} {'resub':>6s}"]
    for name, a in results.items():
        lines.append(f"{name:16s} {a['success_rate']:5.2f} {a['tet']:8.0f} "
                     f"{a['usage_frac']:10.2f} {a['wastage_frac']:10.3f} "
                     f"{a['slr']:6.2f} {a['resubmissions']:6.1f}")
    return lines


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workflow", default="montage",
                    choices=("montage", "cybershake", "ligo", "sipht"))
    ap.add_argument("--size", type=int, default=100)
    ap.add_argument("--env", default="normal",
                    choices=("stable", "normal", "unstable"))
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device of PCA and the distance kernel; the "
                         "CPU only when asked (tests)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run "
                         "on the CPU")
    wf, env = setup(args.workflow, args.size)
    print(f"workflow: {wf.name} ({wf.n_tasks} tasks, "
          f"{len(wf.deps)} dependencies) on 20 VMs, env={args.env}, "
          f"device={device}")
    p, results = evaluate(wf, env, args.env, args.runs, device=device)
    hist = np.bincount(p.rep_counts)
    print(f"\nPCA: {p.pca.components.shape[0]} components "
          f"(COV={p.pca.cov:.2f})")
    print(f"supercluster sizes: "
          f"{sorted(p.clustering.cluster_sizes, reverse=True)}")
    print("replication counts: "
          + ", ".join(f"{n} tasks x{c}" for c, n in enumerate(hist) if n))
    print(f"dynamic checkpoint interval lambda* = {p.ckpt_lambda:.0f}s "
          f"(Lemma 3.1, env={args.env})")
    print(f"HEFT makespan (no failures): {p.schedule.makespan:.0f}s; "
          f"critical path: {len(p.schedule.critical_path())} tasks")
    print("plan phases (host s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in p.timing.items()))
    print()
    for line in table(results):
        print(line)
    return {"plan": p, "results": results}


if __name__ == "__main__":
    main()
