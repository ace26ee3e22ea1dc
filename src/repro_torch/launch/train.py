"""Training launcher of the port: fault-tolerant training with checkpoints.

Counterpart of ``repro.launch.train`` on one device, without ``--pods``
(the cross-pod cluster), ``--mesh`` (sharding) and ``--trace*`` (the flight
recorder), which wait for later slices.  The train step runs under
:class:`~repro_torch.ft.TrainingCoordinator` with the pointer checkpoint
store, the dynamic checkpoint interval, an optional Weibull failure
injector and the ``--chaos*`` fault traces, and prints the JAX launcher's
lines.  Runs on the GPU unless ``--device cpu`` is given; ``--arch`` takes
the families the port trains (olmo-1b).

    PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \\
        --steps 20 --global-batch 4 --seq-len 32 --inject-mtbf-steps 8

On the GPU the run is deterministic (``torch.use_deterministic_algorithms``
and a fixed cuBLAS workspace, set before the first cuBLAS call), so a step
replayed after a restore gives the bits of its first run.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..chaos import TRAIN_KINDS
from ..configs import get_config
from ..data import DataConfig, SyntheticTokenPipeline
from ..distributed.steps import make_train_step
from ..ft import (CheckpointStore, DynamicInterval, FaultInjector,
                  TrainingCoordinator)
from ..models import lm
from ..optim import AdamWConfig, adamw_init
from .serve import add_chaos_args, make_chaos

#: cuBLAS's reproducible workspace setting (read at its first use)
CUBLAS_WORKSPACE = ":4096:8"


def make_deterministic() -> None:
    """Deterministic kernels for a bit-identical replay on the GPU: the
    embedding gather's backward then adds without atomics, and cuBLAS
    keeps one workspace layout.  Call before the process's first cuBLAS
    call (the workspace setting is read then)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    torch.use_deterministic_algorithms(True)


def build(cfg, args, *, params=None, tracer=None) -> dict:
    """The coordinator and what it runs, as the JAX launcher builds them:
    seeded params (or ``params``, e.g. converted from JAX), AdamW state
    without a master copy, the train step at ``q_chunk = min(1024,
    seq_len)``, ``xent_chunk = 512`` and ``total_steps = --steps``, the
    pipeline, the injector, the chaos engine and the checkpoint store."""
    device = torch.device(args.device)
    lm.check_train_family(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = lm.init_params(cfg, gen)
    step_fn = make_train_step(cfg, AdamWConfig(lr=args.lr),
                              accum_steps=args.accum,
                              q_chunk=min(1024, args.seq_len),
                              xent_chunk=512, total_steps=args.steps)
    pipeline = SyntheticTokenPipeline(
        DataConfig(args.global_batch, args.seq_len, seed=args.seed), cfg)
    injector = (FaultInjector(mtbf_steps=args.inject_mtbf_steps,
                              seed=args.seed, horizon_steps=args.steps)
                if args.inject_mtbf_steps else None)
    chaos = make_chaos(args, kinds=TRAIN_KINDS, n_targets=1,
                       horizon=args.chaos_horizon or args.steps)
    coord = TrainingCoordinator(
        train_step=step_fn, params=params, opt_state=adamw_init(params),
        pipeline=pipeline, store=CheckpointStore(args.ckpt_dir, tracer=tracer),
        interval=DynamicInterval(gamma_s=args.ckpt_gamma_s),
        injector=injector, chaos=chaos, tracer=tracer)
    return {"coord": coord, "chaos": chaos, "injector": injector,
            "step_fn": step_fn, "pipeline": pipeline}


def run(cfg, args, built: dict) -> dict:
    """Run the coordinator for ``--steps``, print the JAX launcher's lines
    and apply ``--chaos-assert``'s checks; returns the report, the wall
    time and what ``build`` made."""
    coord, chaos = built["coord"], built["chaos"]
    t0 = time.time()
    report = coord.run(args.steps)
    dt = time.time() - t0
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"steps={report.steps_completed} failures={report.failures} "
          f"restores={report.restores} ckpts={report.checkpoints} "
          f"device={args.device}")
    if chaos is not None:
        print(f"chaos applied: {dict(chaos.applied_by_kind)} | "
              f"nan-rollbacks {report.nan_rollbacks} skipped-batches "
              f"{report.skipped_batches} ckpt-fallbacks "
              f"{report.ckpt_fallbacks} ckpt-corruptions "
              f"{report.ckpt_corruptions} slowdowns {report.slowdowns} "
              f"backoff {report.backoff_steps:.0f} steps | partitions "
              f"{report.partitions} parked {report.parked_steps:.0f} "
              f"disk-full {report.disk_full_events} enospc-retries "
              f"{report.enospc_retries} index-violations "
              f"{report.index_violations}")
    n = max(1, len(report.losses) // 10)
    first = float(np.mean(report.losses[:n]))
    last = float(np.mean(report.losses[-n:]))
    print(f"loss: first10%={first:.4f} last10%={last:.4f} "
          f"({'improved' if last < first else 'NOT improved'}) "
          f"wall={dt:.1f}s ({dt / max(report.steps_completed, 1):.2f}s/step)")
    if args.chaos_assert:
        if chaos is None or not chaos.applied:
            raise SystemExit("--chaos-assert needs a chaos run that fired "
                             "events")
        if report.steps_completed != args.steps:
            raise SystemExit(f"training did not survive: "
                             f"{report.steps_completed}/{args.steps} steps")
        if report.restores <= 0:
            raise SystemExit("chaos run exercised no restore path")
        if report.index_violations:
            raise SystemExit("committed checkpoint index failed its audit "
                             "after chaos")
        if not all(np.isfinite(report.losses)):
            raise SystemExit("non-finite loss escaped the NaN guard")
        print(f"chaos-assert OK: {report.steps_completed} steps, "
              f"{report.restores} restores, all losses finite, "
              "committed index clean")
    return {"report": report, "wall_s": dt, **built}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint store root (default: a temporary "
                         "directory, removed at the end)")
    ap.add_argument("--ckpt-gamma-s", type=float, default=5.0)
    ap.add_argument("--inject-mtbf-steps", type=float, default=0.0,
                    help="simulate failures every ~N steps (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked (tests)")
    add_chaos_args(ap)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available; pass --device cpu to "
                             "run on the CPU")
        make_deterministic()
    try:
        cfg = get_config(args.arch, tiny=args.tiny)
        lm.check_train_family(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.ckpt_dir:
        return run(cfg, args, build(cfg, args))
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as d:
        args.ckpt_dir = d
        return run(cfg, args, build(cfg, args))


if __name__ == "__main__":
    main()
