"""Serving launcher of the port: fault-tolerant continuous batching.

Counterpart of ``repro.launch.serve``.  Requests are admitted through
``repro_torch.serve``: freed decode slots prefill new requests while live
ones keep decoding; replication follows ``--policy`` (``none`` / ``all`` /
``crch``) and failed workers resume requests from their last decode
snapshot.  ``--verify-static`` checks the engine's tokens token-for-token
against the batch=1 reference; ``--static`` runs the one-shot static batch
instead of the engine (a baseline, not a fallback).  Runs on the GPU unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --tiny --device cpu --requests 6 --policy crch --env normal

``--arch`` takes every family of the JAX package (``lm.TRAIN_FAMILIES``);
whisper-small's requests carry frame embeddings and llava-next-mistral-7b's
image embeddings, drawn from the seed (``--arch whisper-small --tiny
--device cpu --verify-static``).

``--trace-dir D`` turns the flight recorder on (:mod:`repro_torch.obs`):
the engine, the chaos engine and the metrics registry report into it, and
the run ends with a dump and the metrics under ``D``
(``--trace-dump-on-fault`` also dumps at every fault and recovery);
``python -m repro_torch.obs.validate D`` checks the dumps.

``--mesh debug`` serves from DTensors: the params under the ZeRO-1 specs
(the JAX launcher's ``_sharded_params``) and the engine's cache under
``cache_specs`` on a one-rank ``DeviceMesh`` of ``--device``, each engine
tick inside ``sharding.use_rules``; ``--verify-static`` then holds the
engine's tokens against the reference on the gathered params, without a
mesh.  Without the flag nothing is sharded and no process group starts.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from .. import obs
from ..chaos import SERVE_KINDS, ChaosEngine, FaultTrace, sample_trace
from ..configs import get_config
from ..distributed import params as pshard
from ..distributed.sharding import host_view, use_rules
from ..distributed.steps import make_prefill_step, make_serve_step
from ..models import lm
from ..serve import (EngineConfig, Request, ServeEngine, ServeMetrics,
                     WorkerPool, crch_policy, engine_supported,
                     greedy_reference, prompt_bucket, uniform_policy)
from .mesh import destroy_group, mesh_from_flag


def make_chaos(args, *, kinds, n_targets: int, horizon: int, tracer=None):
    """Build a ChaosEngine from the --chaos* flags (None when disabled).

    ``--chaos-trace`` replays a recorded trace verbatim (bit-identical run);
    otherwise ``--chaos PROFILE`` samples a fresh trace from the profile's
    Section 4.1 distributions, optionally recorded with ``--chaos-record``.
    An obs tracer annotates every applied fault (``fault.<kind>``) and arms
    the flight recorder's dump-on-fault trigger."""
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
    return ChaosEngine(trace, tracer=tracer)


def add_trace_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--trace-dir", default="",
                    help="enable the repro_torch.obs flight recorder; JSONL "
                         "+ Chrome trace dumps and metrics land here")
    ap.add_argument("--trace-dump-on-fault", action="store_true",
                    help="dump the recorder window on every fault injected "
                         "and every recovery path taken")
    ap.add_argument("--trace-capacity", type=int, default=8192,
                    help="flight-recorder ring capacity (events)")
    ap.add_argument("--trace-window-s", type=float, default=0.0,
                    help="dump only the last N seconds of the ring "
                         "(0 = the whole ring)")


def make_obs(args) -> obs.ObsContext:
    """Build the run's ObsContext from the --trace* flags.  Without
    ``--trace-dir`` this is the NULL tracer + a detached registry."""
    return obs.setup(args.trace_dir or None,
                     dump_on_fault=args.trace_dump_on_fault,
                     capacity=args.trace_capacity,
                     window_s=args.trace_window_s or None)


def print_trace(args, ctx: obs.ObsContext) -> None:
    """``ctx.finish()`` and the launchers' ``trace:`` line (nothing without
    ``--trace-dir``)."""
    if ctx.finish() is not None:
        rec = ctx.recorder
        print(f"trace: {len(rec.dumps)} dump(s) + metrics under "
              f"{args.trace_dir} (faults seen {dict(rec.faults_seen)}, "
              f"recoveries {dict(rec.recoveries_seen)})")


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
    """The launcher's seeded request mix, the JAX launcher's: each
    request draws its prompt length, then its frame embeddings
    (encoder-decoder) and image embeddings (image family), then its
    prompt, from one generator."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(max(prompt_len // 2, 4), prompt_len + 1))
        newt = new_tokens if i % 3 else new_tokens * 2
        frames = (rng.normal(size=(cfg.n_frames, cfg.d_model))
                  .astype(np.float32) if cfg.is_encdec else None)
        embeds = (rng.normal(size=(cfg.n_image_tokens, cfg.d_model))
                  .astype(np.float32) if cfg.n_image_tokens else None)
        reqs.append(Request(
            rid=i, prompt=rng.integers(1, cfg.vocab_size, plen,
                                       dtype=np.int64).astype(np.int32),
            max_new_tokens=newt, arrival=0, deadline=16 * (plen + newt),
            frames=frames, image_embeds=embeds))
    return reqs


def sharded_params(params, mesh):
    """The params as DTensors under the ZeRO-1 specs (TP on ``model``,
    replicated over ``data``), as the JAX launcher serves them."""
    return pshard.distribute_params(params, mesh, zero1=True)


def continuous_main(cfg, args, *, params=None, mesh=None) -> dict:
    """Run the engine over the seeded requests; returns what a caller needs
    to check the run (engine, requests, params, cache_len, summary...).
    ``params`` (in the compute dtype, e.g. an earlier run's) replaces the
    seeded draw, so that two runs of a model that fills the device share
    one copy of its weights.  With ``mesh`` the engine serves from
    :func:`sharded_params` and a DTensor cache."""
    device = torch.device(args.device)
    reqs = make_requests(cfg, args.requests, args.prompt_len,
                         args.new_tokens, args.seed)
    cache_len = max(cfg.n_image_tokens + prompt_bucket(r.prompt_len)
                    + r.max_new_tokens for r in reqs)
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
    ctx = make_obs(args)
    chaos = make_chaos(args, kinds=SERVE_KINDS, n_targets=args.workers,
                       horizon=horizon, tracer=ctx.tracer)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = lm.init_params(cfg, gen, cast=True)
    engine = ServeEngine(
        cfg, EngineConfig(cache_len=cache_len,
                          max_queue_depth=args.max_queue_depth or None),
        pool=pool, policy=policy,
        params=params if mesh is None else sharded_params(params, mesh),
        metrics=ServeMetrics(registry=ctx.registry), chaos=chaos,
        tracer=ctx.tracer, device=device, mesh=mesh)
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
          f"policy={policy.name} env={args.env} device={device}"
          + (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
             if mesh is not None else ""))
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
    print_trace(args, ctx)
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
        # the reference runs without a mesh (on the whole params)
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
            "wall_s": wall, "tok_s": tok_s, "obs": ctx}


def static_batch(cfg, batch: int, seq: int, seed: int, device) -> dict:
    """The static baseline's prompts, drawn as the JAX launcher's
    ``make_batch`` draws them: tokens, (targets, unused here), then frames
    or image embeddings rounded to bf16."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    rng.integers(0, cfg.vocab_size, (batch, seq))      # JAX's targets
    out = {"tokens": torch.from_numpy(tokens)}
    if cfg.is_encdec:
        out["frames"] = torch.from_numpy(rng.normal(
            size=(batch, cfg.n_frames, cfg.d_model))).to(torch.bfloat16)
    if cfg.n_image_tokens:
        out["image_embeds"] = torch.from_numpy(rng.normal(
            size=(batch, cfg.n_image_tokens, cfg.d_model))).to(torch.bfloat16)
    return {k: v.to(device) for k, v in out.items()}


def static_main(cfg, args, *, params=None, mesh=None) -> dict:
    """The one-shot static batch, JAX's ``static_main``: one prefill of
    ``--requests`` prompts of ``--prompt-len`` tokens, then ``--new-tokens
    - 1`` batched greedy decode steps at one shared position.  An explicit
    baseline, not a fallback: no replicas, failures or snapshots.  Returns
    the tokens (B, new_tokens), the last logits and the params."""
    device = torch.device(args.device)
    cache_len = args.prompt_len + args.new_tokens + cfg.n_image_tokens
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = lm.init_params(cfg, gen, cast=True)
    params = lm.cast_params(params, cfg)
    prefill = make_prefill_step(cfg, cache_len)
    serve = make_serve_step(cfg)
    batch = static_batch(cfg, args.requests, args.prompt_len, args.seed,
                         device)
    scope = contextlib.nullcontext()
    if mesh is not None:
        params, scope = sharded_params(params, mesh), use_rules(mesh)
    with scope:
        t0 = time.time()
        logits, cache = prefill(params, batch)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out = [host_view(tok).cpu()]
        t_prefill = time.time() - t0
        pos0 = args.prompt_len + cfg.n_image_tokens
        t0 = time.time()
        for i in range(args.new_tokens - 1):
            tok, logits, cache = serve(params, cache, tok, pos0 + i)
            out.append(host_view(tok).cpu())
        t_decode = time.time() - t0
        logits = host_view(logits)
    gen = torch.cat(out, dim=1)
    tok_s = args.requests * (args.new_tokens - 1) / max(t_decode, 1e-9)
    print(f"arch={cfg.name} ({cfg.param_count() / 1e6:.0f}M params) "
          f"batch={args.requests} prompt={args.prompt_len} "
          f"new={args.new_tokens} device={device} [static]")
    print(f"prefill {t_prefill * 1e3:.0f} ms | decode "
          f"{t_decode * 1e3 / max(args.new_tokens - 1, 1):.1f} ms/token "
          f"({tok_s:.1f} tok/s aggregate)")
    if not torch.isfinite(logits).all():
        raise SystemExit("static run: non-finite logits")
    print("sample:", gen[0][:12].tolist())
    return {"tokens": gen, "logits": logits, "params": params}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="olmo-1b",
                    help="the family: " + ", ".join(lm.TRAIN_FAMILIES))
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
    ap.add_argument("--static", action="store_true",
                    help="run the one-shot static batch baseline")
    ap.add_argument("--verify-static", action="store_true",
                    help="check engine tokens against the batch=1 static "
                         "reference, token-for-token")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked (tests)")
    ap.add_argument("--mesh", choices=("debug", "single", "multi"),
                    default=None,
                    help="serve from DTensors on this mesh (default: none, "
                         "plain tensors)")
    add_chaos_args(ap)
    add_trace_args(ap)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.static and (args.chaos != "none" or args.chaos_trace):
        raise SystemExit("--static has no fault tolerance to chaos-test; "
                         "use the continuous engine")
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
    mesh = mesh_from_flag(args.mesh, args.device)
    try:
        if args.static:
            return static_main(cfg, args, mesh=mesh)
        return continuous_main(cfg, args, mesh=mesh)
    finally:
        if mesh is not None:
            destroy_group()


if __name__ == "__main__":
    main()
