"""Serving launcher of the port: fault-tolerant continuous batching.

Counterpart of ``repro.launch.serve`` (continuous engine only).  Requests
are admitted through ``repro_torch.serve``: freed decode slots prefill new
requests while live ones keep decoding; replication follows ``--policy``
(``none`` / ``all`` / ``crch``) and failed workers resume requests from
their last decode snapshot.  ``--verify-static`` checks the engine's tokens
token-for-token against the batch=1 reference.  Runs on the GPU unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --tiny --device cpu --requests 6 --policy crch --env normal

``--arch`` takes olmo-1b, rwkv6-3b or recurrentgemma-2b.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..chaos import SERVE_KINDS, ChaosEngine, FaultTrace, sample_trace
from ..configs import get_config
from ..models import lm
from ..serve import (EngineConfig, Request, ServeEngine, WorkerPool,
                     crch_policy, engine_supported, greedy_reference,
                     prompt_bucket, uniform_policy)


def make_chaos(args, *, kinds, n_targets: int, horizon: int):
    """Build a ChaosEngine from the --chaos* flags (None when disabled)."""
    if args.chaos_trace:
        trace = FaultTrace.load(args.chaos_trace)
    elif args.chaos != "none":
        trace = sample_trace(args.chaos, horizon=horizon,
                             n_targets=n_targets, seed=args.chaos_seed,
                             kinds=kinds)
    else:
        return None
    if args.chaos_record:
        trace.save(args.chaos_record)
    print(f"chaos: {len(trace)} events over {sorted(trace.kinds())} "
          f"(meta={trace.meta})")
    return ChaosEngine(trace)


def add_chaos_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--chaos", choices=("none", "stable", "normal",
                                        "unstable"), default="none",
                    help="sample a multi-fault chaos trace from this profile")
    ap.add_argument("--chaos-trace", default="",
                    help="replay a recorded fault trace (JSON) verbatim")
    ap.add_argument("--chaos-record", default="",
                    help="record the active fault trace to this path")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--chaos-horizon", type=int, default=0,
                    help="trace horizon in steps (0 = derive from the run)")
    ap.add_argument("--chaos-assert", action="store_true",
                    help="CI smoke: require survival — completions with "
                         "nonzero restores/resubmissions and zero "
                         "past-first-token drops")


def make_requests(cfg, n: int, prompt_len: int, new_tokens: int,
                  seed: int) -> list[Request]:
    """The launcher's seeded request mix: the JAX launcher's for the
    text-only families (no encoder frames or image embeddings)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(max(prompt_len // 2, 4), prompt_len + 1))
        newt = new_tokens if i % 3 else new_tokens * 2
        reqs.append(Request(
            rid=i, prompt=rng.integers(1, cfg.vocab_size, plen,
                                       dtype=np.int64).astype(np.int32),
            max_new_tokens=newt, arrival=0, deadline=16 * (plen + newt)))
    return reqs


def continuous_main(cfg, args) -> dict:
    """Run the engine over the seeded requests; returns what a caller needs
    to check the run (engine, requests, params, cache_len, summary...)."""
    device = torch.device(args.device)
    reqs = make_requests(cfg, args.requests, args.prompt_len,
                         args.new_tokens, args.seed)
    cache_len = max(prompt_bucket(r.prompt_len) + r.max_new_tokens
                    for r in reqs)
    if cfg.rglru:
        # the engine refuses a cache shorter than the rolling window
        cache_len = max(cache_len, cfg.window)
    if args.policy == "crch":
        policy = crch_policy(reqs, device=device)
    elif args.policy == "all":
        policy = uniform_policy(args.max_rep)
    else:
        policy = uniform_policy(1)
    pool = WorkerPool(args.workers, args.slots_per_worker,
                      environment=(args.env if args.env != "none" else None),
                      seed=args.seed)
    horizon = args.chaos_horizon or min(
        args.max_steps, 8 * max(r.max_new_tokens for r in reqs))
    chaos = make_chaos(args, kinds=SERVE_KINDS, n_targets=args.workers,
                       horizon=horizon)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(cfg, gen)
    engine = ServeEngine(
        cfg, EngineConfig(cache_len=cache_len,
                          max_queue_depth=args.max_queue_depth or None),
        pool=pool, policy=policy, params=params, chaos=chaos, device=device)
    for r in reqs:
        engine.submit(r)
    t0 = time.time()
    metrics = engine.run(max_steps=args.max_steps)
    wall = time.time() - t0
    s = metrics.summary(engine.step_no)
    tok_s = metrics.decode_tokens / max(wall, 1e-9)
    tm = engine.timing
    print(f"arch={cfg.name} ({cfg.param_count() / 1e6:.0f}M params) "
          f"requests={args.requests} slots={pool.n_slots} "
          f"policy={policy.name} env={args.env} device={device}")
    print(f"policy by_class: "
          f"{ {str(c): r for c, r in sorted(policy.by_class.items(), key=str)} }")
    print(f"{engine.step_no} engine steps in {wall:.2f}s "
          f"({tok_s:.1f} tok/s aggregate) | completed "
          f"{int(s['completed'])}/{args.requests} "
          f"(in-deadline {int(s['in_deadline'])}) | "
          f"p50/p99 latency {s['p50_latency']:.0f}/{s['p99_latency']:.0f} "
          f"steps")
    print(f"prefill {1e3 * tm['prefill_s'] / max(tm['prefill_calls'], 1):.2f}"
          f" ms/call x {tm['prefill_calls']} | decode "
          f"{1e3 * tm['decode_s'] / max(tm['decode_calls'], 1):.2f} ms/step "
          f"x {tm['decode_calls']}")
    print(f"usage {s['usage_tokens']:.0f} tok | wasted "
          f"{s['wasted_tokens']:.0f} tok ({100 * s['wastage_frac']:.1f}%) | "
          f"failures {int(s['failures'])} resubmissions "
          f"{int(s['resubmissions'])} snapshot-restores "
          f"{int(s['restores'])} rejected-on-arrival "
          f"{int(s['rejected_on_arrival'])}")
    if chaos is not None:
        print(f"chaos applied: {dict(chaos.applied_by_kind)} | shed "
              f"{int(s['shed'])} hedge-drops {int(s['hedge_drops'])} "
              f"snapshot-verify-fails {int(s['snapshot_restore_failures'])} "
              f"past-first-token drops {int(s['past_first_drops'])}")
    done = sorted(engine.completed)
    if not done:
        raise SystemExit("no requests completed")
    print("sample:", engine.completed[done[0]][:12])
    if args.chaos_assert:
        if chaos is None or not chaos.applied:
            raise SystemExit("--chaos-assert needs a chaos run that fired "
                             "events")
        recoveries = int(s["restores"]) + int(s["resubmissions"])
        if s["completed"] == 0 or recoveries == 0:
            raise SystemExit(
                f"chaos run: {int(s['completed'])} completed, {recoveries} "
                f"recoveries (applied {dict(chaos.applied_by_kind)})")
        if s["past_first_drops"]:
            raise SystemExit(
                f"{int(s['past_first_drops'])} request(s) dropped past their "
                f"first token — degraded mode must never shed live work")
        print(f"chaos-assert OK: {int(s['completed'])} completed, "
              f"{recoveries} recoveries, 0 past-first-token drops")
    if args.verify_static:
        ref = greedy_reference(params, cfg, reqs, cache_len, device=device)
        mismatched = [r.rid for r in reqs
                      if engine.output(r.rid) != ref[r.rid]]
        print(f"parity vs static reference: "
              f"{len(reqs) - len(mismatched)}/{len(reqs)} token-exact"
              + (f" (MISMATCH rids {mismatched})" if mismatched else ""))
        if mismatched:
            raise SystemExit(f"token parity failed for rids {mismatched}")
    return {"engine": engine, "requests": reqs, "params": params,
            "policy": policy, "cache_len": cache_len, "summary": s,
            "wall_s": wall, "tok_s": tok_s}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--requests", "--batch", type=int, default=4,
                    dest="requests")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--slots-per-worker", type=int, default=2)
    ap.add_argument("--policy", choices=("none", "all", "crch"),
                    default="crch")
    ap.add_argument("--max-rep", type=int, default=3)
    ap.add_argument("--max-queue-depth", type=int, default=0,
                    help="queue-length-priced admission: reject fresh "
                         "arrivals with a retry_after hint once the queue "
                         "holds this many work items (0 = unbounded)")
    ap.add_argument("--env", choices=("none", "stable", "normal", "unstable"),
                    default="none")
    ap.add_argument("--max-steps", type=int, default=20_000)
    ap.add_argument("--verify-static", action="store_true",
                    help="check engine tokens against the batch=1 static "
                         "reference, token-for-token")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked (tests)")
    add_chaos_args(ap)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("CUDA is not available; pass --device cpu to run "
                         "on the CPU")
    try:
        cfg = get_config(args.arch, tiny=args.tiny)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    supported, why = engine_supported(cfg)
    if not supported:
        raise SystemExit(f"{args.arch}: {why}")
    return continuous_main(cfg, args)


if __name__ == "__main__":
    main()
