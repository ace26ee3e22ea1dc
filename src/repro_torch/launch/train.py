"""Training launcher of the port: fault-tolerant training with checkpoints.

Counterpart of ``repro.launch.train``.  The train step runs under
:class:`~repro_torch.ft.TrainingCoordinator` with the pointer checkpoint
store, the dynamic checkpoint interval, an optional Weibull failure
injector and the ``--chaos*`` fault traces, and prints the JAX launcher's
lines.  Runs on the GPU unless ``--device cpu`` is given; ``--arch`` takes
every family of the JAX package (``lm.TRAIN_FAMILIES``; the MoE families
add their load-balancing loss to the loss, as in JAX; whisper-small's
batches carry frame embeddings and llava-next-mistral-7b's image
embeddings, from the pipeline's seed).

    PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \\
        --steps 20 --global-batch 4 --seq-len 32 --inject-mtbf-steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
        --tiny --device cpu --steps 12 --global-batch 4 --seq-len 32 \\
        --inject-mtbf-steps 5
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --tiny --device cpu --steps 12 \\
        --global-batch 4 --seq-len 32 --inject-mtbf-steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \\
        --tiny --device cpu --steps 12 --global-batch 4 --seq-len 32 \\
        --inject-mtbf-steps 5

``--pods N`` (N > 1) switches to the multi-pod cluster mode: N replicated
data-parallel pods training through the partition-tolerant compressed
exchange (:mod:`repro_torch.ft.crosspod`), with ``net_partition`` /
``disk_full`` chaos targeting the pod set.  Under ``--chaos-assert`` the run
must finish with zero split-brain fingerprint divergences, a clean
committed-index audit, and final params bit-identical to a fault-free
reference cluster:

    PYTHONPATH=src python -m repro_torch.launch.train --tiny --pods 3 \\
        --steps 12 --global-batch 2 --seq-len 32 --chaos unstable \\
        --chaos-seed 29 --chaos-assert --device cpu

``--trace-dir D`` turns the flight recorder on (:mod:`repro_torch.obs`):
the coordinator or the cluster, the checkpoint store and the chaos engine
report into it, the train step is profiled (``D/profile.json``, with
``capture_cost``'s FLOPs and bytes of one step), and the run ends with a
dump and the metrics under ``D`` (``--trace-dump-on-fault`` also dumps at
every fault and recovery); ``python -m repro_torch.obs.validate D
--require-span crosspod.partition`` checks the dumps.  ``--profile-steps
A:B`` (with ``--trace-dir``, not with ``--pods``) runs the train step's
calls A to B (from 0) under ``torch.profiler`` and writes its Chrome
export to ``D/device_trace.json``: the card's kernels, the host's ops, the
step's ranges (``train.step``, ``train.forward``, ``train.backward``,
``train.optimizer``, the layers' ``layer.*`` and the MoE layer's
``moe.*``) and the recorder's spans, on one clock (open it in Perfetto or
``chrome://tracing``):

    PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \
        --steps 6 --global-batch 2 --seq-len 32 --trace-dir D \
        --profile-steps 2:3

``--mesh debug`` lays the params and the AdamW state out as DTensors under
``distributed.params.param_specs`` (the JAX launcher's placement) on a
one-rank ``DeviceMesh`` of ``--device`` and runs each step inside
``sharding.use_rules``; ``single`` / ``multi`` need a process group of 256
/ 512 ranks.  Without the flag the launcher runs on plain tensors and
starts no process group (JAX's default is ``debug``): the measured paths
stay off DTensor's per-op host cost.  Checkpoints and fingerprints read
each leaf whole, so a sharded run writes and hashes what an unsharded one
does.

    PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \
        --steps 8 --global-batch 4 --seq-len 32 --mesh debug

On the GPU the run is deterministic (``torch.use_deterministic_algorithms``
and a fixed cuBLAS workspace, set before the first cuBLAS call), so a step
replayed after a restore gives the bits of its first run, and the pods of a
cluster ship bit-identical payloads.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..chaos import DISK_FULL, NET_PARTITION, TRAIN_KINDS
from ..configs import get_config
from ..data import DataConfig, SyntheticTokenPipeline
from ..distributed import params as pshard
from ..distributed.sharding import use_rules
from ..distributed.steps import make_train_step
from ..ft import (CheckpointStore, DynamicInterval, FaultInjector,
                  PodTrainingCluster, TrainingCoordinator, tree_digest)
from ..models import lm
from ..obs import ProfileSteps, profile_jit, save_profiles
from ..optim import AdamWConfig, adamw_init
from .mesh import destroy_group, mesh_from_flag
from .serve import (add_chaos_args, add_trace_args, make_chaos, make_obs,
                    print_trace)

#: cuBLAS's reproducible workspace setting (read at its first use)
CUBLAS_WORKSPACE = ":4096:8"


def make_deterministic() -> None:
    """Deterministic kernels for a bit-identical replay on the GPU: the
    embedding gather's backward then adds without atomics, and cuBLAS
    keeps one workspace layout.  Call before the process's first cuBLAS
    call (the workspace setting is read then)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    torch.use_deterministic_algorithms(True)


def seeded_params(cfg, args):
    """The launcher's params: drawn from ``--seed`` on ``--device``."""
    gen = torch.Generator(device=torch.device(args.device)).manual_seed(
        args.seed)
    return lm.init_params(cfg, gen)


def in_rules(step_fn, mesh):
    """``step_fn`` run inside ``use_rules(mesh)`` at each call."""
    def step(*a, **k):
        with use_rules(mesh):
            return step_fn(*a, **k)
    return step


def parse_steps(text: str) -> tuple[int, int]:
    """``--profile-steps``' "A:B" as (A, B)."""
    try:
        a, b = (int(v) for v in text.split(":"))
    except ValueError:
        raise ValueError(f"--profile-steps {text!r}: expected A:B") from None
    if not 0 <= a <= b:
        raise ValueError(f"--profile-steps {text!r}: need 0 <= A <= B")
    return a, b


def build(cfg, args, *, params=None, ctx=None, mesh=None) -> dict:
    """The coordinator and what it runs, as the JAX launcher builds them:
    seeded params (or ``params``, e.g. converted from JAX), AdamW state
    without a master copy, the train step at ``q_chunk = min(1024,
    seq_len)``, ``xent_chunk = 512`` and ``total_steps = --steps`` (wrapped
    by ``profile_jit`` under ``--trace-dir``), the pipeline, the injector,
    the chaos engine and the checkpoint store, all reporting to ``ctx``
    (default: :func:`~repro_torch.launch.serve.make_obs` of the flags).
    With ``mesh`` (``--mesh``) the params and the AdamW state are DTensors
    under ``param_specs``, the gradient sum is placed there too
    (``grad_shardings``) and the step runs inside ``use_rules(mesh)``."""
    lm.check_train_family(cfg)
    ctx = ctx if ctx is not None else make_obs(args)
    if params is None:
        params = seeded_params(cfg, args)
    step_fn = make_train_step(
        cfg, AdamWConfig(lr=args.lr), accum_steps=args.accum,
        q_chunk=min(1024, args.seq_len), xent_chunk=512,
        total_steps=args.steps,
        grad_shardings=(None if mesh is None
                        else pshard.param_shardings(params, mesh)))
    if mesh is not None:
        params = pshard.distribute_params(params, mesh)
        step_fn = in_rules(step_fn, mesh)
    profiled = None
    if args.trace_dir:
        # the wrapper synchronises on each step's outputs (exact wall times
        # at the cost of launch overlap): opt-in with --trace-dir
        profiled = profile_jit(step_fn, name="train_step",
                               registry=ctx.registry, tracer=ctx.tracer)
        step_fn = profiled
    window = None
    if args.profile_steps:
        first, last = parse_steps(args.profile_steps)
        window = ProfileSteps(step_fn, first, last, os.path.join(
            args.trace_dir, "device_trace.json"))
        step_fn = window
    pipeline = SyntheticTokenPipeline(
        DataConfig(args.global_batch, args.seq_len, seed=args.seed), cfg)
    injector = (FaultInjector(mtbf_steps=args.inject_mtbf_steps,
                              seed=args.seed, horizon_steps=args.steps)
                if args.inject_mtbf_steps else None)
    chaos = make_chaos(args, kinds=TRAIN_KINDS, n_targets=1,
                       horizon=args.chaos_horizon or args.steps,
                       tracer=ctx.tracer)
    coord = TrainingCoordinator(
        train_step=step_fn, params=params, opt_state=adamw_init(params),
        pipeline=pipeline,
        store=CheckpointStore(args.ckpt_dir, tracer=ctx.tracer),
        interval=DynamicInterval(gamma_s=args.ckpt_gamma_s),
        injector=injector, chaos=chaos, tracer=ctx.tracer,
        registry=ctx.registry)
    return {"coord": coord, "chaos": chaos, "injector": injector,
            "step_fn": step_fn, "pipeline": pipeline, "obs": ctx,
            "profiled": profiled, "window": window, "mesh": mesh}


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
    profiled = built["profiled"]
    if profiled is not None:
        profiled.capture_cost(coord.params, coord.opt_state,
                              coord.pipeline.batch_at(0))
        prof = profiled.report()
        mean_ms = (prof["mean_s"] or 0.0) * 1e3
        print(f"profile: first call {prof['compile_s'] or 0.0:.2f}s, "
              f"{prof['calls']} steps mean {mean_ms:.1f} ms, "
              f"{prof['flops']:.3g} FLOP/step, "
              f"{prof['bytes_accessed']:.3g} bytes/step")
        save_profiles(os.path.join(args.trace_dir, "profile.json"),
                      [profiled])
    window = built["window"]
    if window is not None:
        path = window.close()
        print(f"device trace: {path or 'none (the run ended first)'} "
              f"(step calls {window.first}:{window.last})")
    print_trace(args, built["obs"])
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


def cluster_main(cfg, args, *, params=None) -> dict:
    """Multi-pod mode (``--pods N``): the quorum trains through partitions,
    minority pods park and catch up from the quorum checkpoint at heal.
    Prints the JAX launcher's lines; under ``--chaos-assert`` a fault-free
    reference cluster runs in a temporary directory beside ``--ckpt-dir``
    and every pod must end bit-identical to it.  ``params`` (e.g. converted
    from JAX) replaces the seeded draw in both clusters.  Returns the
    report, the cluster, the chaos engine, the obs context and the wall
    time."""
    lm.check_train_family(cfg)
    # --chaos-assert needs the exact per-step split-brain check; otherwise
    # fingerprints are sampled (tree_digest copies every leaf to the host)
    fingerprint_every = 1 if args.chaos_assert else args.fingerprint_every

    def build_cluster(chaos_engine, ckpt_dir, ctx=None):
        tracer = ctx.tracer if ctx is not None else None
        return PodTrainingCluster(
            cfg=cfg,
            params=params if params is not None else seeded_params(cfg,
                                                                   args),
            pipeline=SyntheticTokenPipeline(
                DataConfig(args.global_batch, args.seq_len, seed=args.seed),
                cfg),
            store=CheckpointStore(ckpt_dir, tracer=tracer),
            n_pods=args.pods, opt_cfg=AdamWConfig(lr=args.lr),
            q_chunk=min(1024, args.seq_len), xent_chunk=512,
            chaos=chaos_engine, fingerprint_every=fingerprint_every,
            tracer=tracer,
            registry=ctx.registry if ctx is not None else None)

    ctx = make_obs(args)
    chaos = make_chaos(args, kinds=(NET_PARTITION, DISK_FULL),
                       n_targets=args.pods,
                       horizon=args.chaos_horizon or args.steps,
                       tracer=ctx.tracer)
    cluster = build_cluster(chaos, args.ckpt_dir, ctx)
    t0 = time.time()
    report = cluster.run(args.steps)
    dt = time.time() - t0
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"pods={args.pods} steps={report.steps_completed} "
          f"rounds={report.rounds} ckpts={report.checkpoints} "
          f"compression={cluster.exchange.compression_ratio:.1f}x "
          f"device={args.device}")
    print(f"partitions {report.partitions} parked-pod-rounds "
          f"{report.parked_pod_rounds} heals {report.heals} catchups "
          f"{report.catchups} disk-full {report.disk_full_events} "
          f"enospc-retries {report.enospc_retries} | split-brain "
          f"{report.split_brain_divergences} index-violations "
          f"{report.index_violations} | fingerprints "
          f"{report.fingerprints_taken} taken / "
          f"{report.fingerprints_skipped} skipped (every "
          f"{fingerprint_every})")
    if chaos is not None:
        print(f"chaos applied: {dict(chaos.applied_by_kind)}")
    if ctx.finish() is not None:
        print(f"trace: {len(ctx.recorder.dumps)} dump(s) + metrics under "
              f"{args.trace_dir}")
    print(f"final loss {report.final_loss:.4f} wall={dt:.1f}s "
          f"({dt / max(report.steps_completed, 1):.2f}s/step)")
    out = {"report": report, "cluster": cluster, "chaos": chaos, "obs": ctx,
           "wall_s": dt}
    if args.chaos_assert:
        if chaos is None or not chaos.applied:
            raise SystemExit("--chaos-assert needs a chaos run that fired "
                             "events")
        if report.steps_completed != args.steps:
            raise SystemExit(f"cluster did not survive: "
                             f"{report.steps_completed}/{args.steps} steps")
        if report.split_brain_divergences:
            raise SystemExit(f"{report.split_brain_divergences} split-brain "
                             "fingerprint divergence(s): two components "
                             "advanced independently")
        if report.index_violations:
            raise SystemExit("committed checkpoint index failed its audit "
                             "after chaos")
        if not all(np.isfinite(report.losses)):
            raise SystemExit("non-finite loss in cluster")
        parent = os.path.dirname(os.path.abspath(args.ckpt_dir))
        with tempfile.TemporaryDirectory(prefix="repro_torch_ref_",
                                         dir=parent) as ref_dir:
            reference = build_cluster(None, ref_dir)
            ref = reference.run(args.steps)
        ref_digest = tree_digest(reference.params[0])
        mismatched = [p for p in range(args.pods)
                      if tree_digest(cluster.params[p]) != ref_digest]
        if ref.steps_completed != args.steps:
            raise SystemExit("the fault-free reference cluster did not "
                             "finish")
        if mismatched:
            raise SystemExit(
                f"pods {mismatched} are not bit-identical to the fault-free "
                f"reference after heal (digest {ref_digest[:12]})")
        print(f"chaos-assert OK: {report.steps_completed} steps, "
              f"{report.heals} heals, all {args.pods} pods bit-identical "
              "to the fault-free reference, 0 split-brain divergences")
        out.update(reference=reference, reference_report=ref)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="olmo-1b",
                    help="the family: " + ", ".join(lm.TRAIN_FAMILIES))
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
    ap.add_argument("--pods", type=int, default=1,
                    help="N > 1: multi-pod cluster mode through the "
                         "partition-tolerant exchange")
    ap.add_argument("--fingerprint-every", type=int, default=8,
                    help="cluster mode: take the split-brain sha1 "
                         "fingerprint every N applied steps (forced to 1 "
                         "under --chaos-assert)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked (tests)")
    ap.add_argument("--mesh", choices=("debug", "single", "multi"),
                    default=None,
                    help="lay params and optimizer state out as DTensors "
                         "on this mesh (default: none, plain tensors)")
    add_chaos_args(ap)
    add_trace_args(ap)
    ap.add_argument("--profile-steps", default="", metavar="A:B",
                    help="with --trace-dir: run the train step's calls A "
                         "to B (from 0) under torch.profiler and write "
                         "D/device_trace.json")
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
    if args.mesh and args.pods > 1:
        raise SystemExit("--mesh and --pods > 1 do not combine: the "
                         "cluster's pods hold plain tensors")
    if args.profile_steps:
        if not args.trace_dir or args.pods > 1:
            raise SystemExit("--profile-steps needs --trace-dir and one pod")
        try:
            parse_steps(args.profile_steps)
        except ValueError as e:
            raise SystemExit(str(e)) from None

    def go():
        if args.pods > 1:
            return cluster_main(cfg, args)
        mesh = mesh_from_flag(args.mesh, args.device)
        try:
            return run(cfg, args, build(cfg, args, mesh=mesh))
        finally:
            if mesh is not None:
                destroy_group()

    if args.ckpt_dir:
        return go()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as d:
        args.ckpt_dir = d
        return go()


if __name__ == "__main__":
    main()
