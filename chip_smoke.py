#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one card

Phases, in order; the first failure ends the run with a non-zero exit:

1. device: the card's name and power limit (``nvidia-smi``); no CUDA, no run;
2. build: ``nvcc`` compiles every ``kernels/csrc/*.cu`` for sm_90a, in
   parallel, into ``build/kernels``;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the JAX package's test shapes, at the serve path's shapes and at large
   ones, with times (CUDA events, median of 25 after warm-up) beside the
   plain version's, a library call's and the card's bound;
4. serve: the port's launcher on olmo-1b at full width (random seeded
   weights, bf16) with CRCH replication under the ``unstable`` failure
   environment; every request must complete, failures must have been
   recovered, and both kernels must have been launched (their launch counts
   are zeroed just before this phase and read just after);
5. fault transparency: the same requests with no failures give the same
   tokens, token for token (paper: checkpointed resubmission does not
   change the output);
6. reference parity: engine tokens against the batch=1 greedy reference;
   where they part, the reference's logit gap between the two tokens must
   be below a bound derived from measured logit differences.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense): the bound of a kernel's time
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"bfloat16": 989e12, "float32": 67e12}   # fp32: no tensor core

PA_SHAPES = [(16, 4), (100, 10), (130, 3), (256, 64), (4096, 10)]
FA_TEST_SHAPES = [(1, 4, 2, 128, 128), (2, 8, 8, 256, 128),
                  (1, 2, 1, 130, 128), (1, 4, 2, 384, 256)]
FA_BIG_SHAPES = [(1, 16, 16, 512, 128), (4, 16, 16, 2048, 128)]
# fp32: the JAX tests' limit.  bf16: both sides accumulate in fp32 and
# round the output to bf16 once, so they may differ by the output's own
# rounding, one bf16 ulp (<= 2^-7 |x|), and no more
FA_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
          "bfloat16": dict(atol=4e-3, rtol=1e-2)}
PA_TOL = dict(atol=3e-3, rtol=1e-3)

SERVE_ARGS = ["--arch", "olmo-1b", "--requests", "8", "--prompt-len", "384",
              "--new-tokens", "32", "--workers", "2", "--slots-per-worker",
              "2", "--policy", "crch", "--seed", "0", "--device", "cuda"]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters=25, warmup=3):
    """Median of per-call CUDA-event times, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(bytes_, flops, dtype):
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def pairwise_case(n, f, *, timed):
    import numpy as np
    import torch
    from repro_torch.kernels.pairwise_affinity import ops, ref
    pts_np = np.random.default_rng(n * 31 + f).normal(size=(n, f)).astype(
        np.float32)
    x = torch.from_numpy(pts_np).cuda()
    got = ops.pairwise_distance(x)
    torch.cuda.synchronize()
    want = ref.pairwise_distance(x)
    g, w = got.cpu().numpy(), want.cpu().numpy()
    off = ~np.eye(n, dtype=bool)
    # off the diagonal the stated tolerance; on it the exact answer is 0 and
    # both sides return sqrt of cancellation noise, bounded by
    # sqrt(8 eps |x|^2)
    diag_bound = np.sqrt(8 * np.finfo(np.float32).eps
                         * (pts_np.astype(np.float64) ** 2).sum(1))
    ok = (np.allclose(g[off], w[off], **PA_TOL)
          and (np.abs(np.diag(g)) <= diag_bound).all()
          and (np.abs(np.diag(w)) <= diag_bound).all())
    err = float(np.abs(g - w).max())
    rec = {"shape": [n, f], "max_abs_err": err, "ok": bool(ok)}
    if timed:
        rec["ms"] = time_ms(lambda: ops.pairwise_distance(x))
        rec["plain_ms"] = time_ms(lambda: ref.pairwise_distance(x))
        rec["library_ms"] = time_ms(lambda: torch.cdist(
            x, x, compute_mode="use_mm_for_euclid_dist"))
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            4 * (n * f + n * n), n * n * (3 * f + 4), "float32")
    print(f"  pairwise_distance {n}x{f}: max_abs_err {err:.3g} "
          f"(off-diagonal atol 3e-3 rtol 1e-3; diagonal <= sqrt(8 eps "
          f"|x|^2)) {'ok' if ok else 'FAIL'}"
          + (f" | kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms "
             f"cdist {rec['library_ms']:.4f} ms bound {rec['bound_ms']:.5f}"
             f" ms ({rec['bound_by']})" if timed else ""))
    check(ok, f"pairwise_distance {n}x{f} disagrees with its plain version")
    return rec


def flash_case(b, h, kv, s, d, dtype_name, causal, *, timed):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    dt = getattr(torch, dtype_name)
    rng = np.random.default_rng(b * 7 + h * 5 + s + d)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to("cuda", dt)
               for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.attention(q, k, v, causal=causal)
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), **FA_TOL[dtype_name]))
    rec = {"shape": [b, h, kv, s, d], "dtype": dtype_name, "causal": causal,
           "max_abs_err": err, "ok": ok}
    if timed:
        rec["ms"] = time_ms(lambda: ops.flash_attention(q, k, v,
                                                        causal=causal))
        rec["plain_ms"] = time_ms(lambda: ref.attention(q, k, v,
                                                        causal=causal))
        gqa = {"enable_gqa": True} if h != kv else {}
        rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, **gqa))
        pairs = s * (s + 1) // 2 if causal else s * s
        item = q.element_size()
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            item * (2 * b * h * s * d + 2 * b * kv * s * d),
            4 * b * h * pairs * d, dtype_name)
    tol = FA_TOL[dtype_name]
    print(f"  flash_attention {(b, h, kv, s, d)} {dtype_name} "
          f"{'causal' if causal else 'bidir'}: max_abs_err {err:.3g} "
          f"(atol {tol['atol']} rtol {tol['rtol']}) {'ok' if ok else 'FAIL'}"
          + (f" | kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms "
             f"sdpa {rec['library_ms']:.4f} ms bound {rec['bound_ms']:.5f} "
             f"ms ({rec['bound_by']})" if timed else ""))
    check(ok, f"flash_attention {(b, h, kv, s, d)} {dtype_name} "
              f"causal={causal} disagrees with its plain version")
    return rec


def main_path_shapes():
    """The shapes the serve phase gives each kernel: B1 sees the request
    sample after PCA, B2 each prompt bucket's causal prefill."""
    from repro_torch.configs import get_config
    from repro_torch.core.pca import fit_pca
    from repro_torch.launch.serve import build_parser, make_requests
    from repro_torch.serve import prompt_bucket, request_features
    args = build_parser().parse_args(SERVE_ARGS)
    cfg = get_config(args.arch)
    reqs = make_requests(cfg, args.requests, args.prompt_len,
                         args.new_tokens, args.seed)
    k = fit_pca(request_features(reqs), device="cuda").projected.shape[1]
    buckets = sorted({prompt_bucket(r.prompt_len) for r in reqs})
    return (len(reqs), k), [(1, cfg.n_heads, cfg.n_kv_heads, s, cfg.head_dim)
                            for s in buckets]


def phase_kernels():
    pa_main, fa_main = main_path_shapes()
    print(f"main-path shapes: pairwise {pa_main}, flash {fa_main} bf16 causal")
    pa_recs = [pairwise_case(n, f, timed=False) for n, f in PA_SHAPES]
    fa_recs = [flash_case(*shape, dt, causal, timed=False)
               for shape in FA_TEST_SHAPES
               for dt in ("float32", "bfloat16") for causal in (True, False)]
    pa_main_rec = pairwise_case(*pa_main, timed=True)
    fa_main_recs = [flash_case(*shape, "bfloat16", True, timed=True)
                    for shape in fa_main]
    # the fp32 instance of the same template, at the tight limit
    for shape in fa_main:
        flash_case(*shape, "float32", True, timed=False)
    pairwise_case(4096, 10, timed=True)
    for shape in FA_BIG_SHAPES:
        flash_case(*shape, "bfloat16", True, timed=True)
    return pa_main_rec, max(fa_main_recs, key=lambda r: r["shape"][3])


# ---------------------------------------------------------------------------
# phases 4-6: the serve path at full width
# ---------------------------------------------------------------------------

def phase_serve():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.pairwise_affinity import ops as pa_ops
    from repro_torch.launch import serve as launch
    pa_ops.pairwise_distance.launches = 0
    fa_ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    res = launch.main(SERVE_ARGS + ["--env", "unstable"])
    wall = time.perf_counter() - t0
    launches = {"pairwise_distance": pa_ops.pairwise_distance.launches,
                "flash_attention": fa_ops.flash_attention.launches}
    s, eng = res["summary"], res["engine"]
    tm = eng.timing
    serve_rec = {
        "tok_s": res["tok_s"], "wall_s": res["wall_s"],
        "steps": eng.step_no,
        "prefill_ms": 1e3 * tm["prefill_s"] / max(tm["prefill_calls"], 1),
        "prefill_calls": tm["prefill_calls"],
        "decode_ms": 1e3 * tm["decode_s"] / max(tm["decode_calls"], 1),
        "decode_steps": tm["decode_calls"],
        "completed": int(s["completed"]), "in_deadline": int(s["in_deadline"]),
        "failures": int(s["failures"]),
        "resubmissions": int(s["resubmissions"]),
        "restores": int(s["restores"]),
        "by_class": {str(c): r for c, r in res["policy"].by_class.items()},
        "launches": launches}
    print(f"serve (unstable): {json.dumps(serve_rec)} (phase {wall:.1f} s)")
    n = len(res["requests"])
    check(serve_rec["completed"] == n,
          f"{serve_rec['completed']}/{n} requests completed")
    check(serve_rec["failures"] >= 1, "the unstable run saw no failure")
    check(serve_rec["restores"] + serve_rec["resubmissions"] >= 1,
          "no restore or resubmission in the unstable run")
    for name, count in launches.items():
        check(count > 0, f"the serve path never launched {name}")
    return res, serve_rec, launches


def profile_engine(res, steps=8):
    """Where the time goes: torch.profiler over one prefill at the largest
    prompt bucket and ``steps`` batched decode steps at the last cache
    position, of the serve phase's engine (all slots live), after warm-up.  Prints host wall time, device busy time (sum of
    kernel times; one stream, so no overlap), the device's idle share and
    the top kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import prompt_bucket
    eng = res["engine"]
    n = eng.pool.n_slots
    seq = max(prompt_bucket(r.prompt_len) for r in res["requests"])
    prompt = torch.ones((1, seq), dtype=torch.int32, device="cuda")
    last = torch.tensor([seq - 1], device="cuda")
    toks = torch.ones((n, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((n,), res["cache_len"] - 1, dtype=torch.int64,
                     device="cuda")
    live = torch.ones((n,), dtype=torch.bool, device="cuda")

    def prefill():
        logits, _ = eng._prefill_step(eng.params, {"tokens": prompt}, last)
        return logits.cpu()

    def decode():
        nxt, _, _ = eng._serve(eng.params, eng.cache, toks, pos, live)
        return nxt.cpu()

    out = {}
    for name, fn, reps in (("prefill", prefill, 1), ("decode", decode,
                                                      steps)):
        fn(), fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        evs = [e for e in prof.key_averages()
               if "CUDA" in str(e.device_type)]
        check(evs, f"torch.profiler recorded no CUDA kernel in {name}")
        busy = sum(e.self_device_time_total for e in evs) / 1e3 / reps
        launches = sum(e.count for e in evs) / reps
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
        out[name] = {"wall_ms": wall, "device_busy_ms": busy,
                     "idle_share": max(0.0, 1 - busy / wall),
                     "kernels_per_call": launches}
        print(f"profile {name}: host wall {wall:.3f} ms/call, device busy "
              f"{busy:.3f} ms/call, idle share {out[name]['idle_share']:.3f}"
              f", {launches:.0f} kernels/call; top by device time:")
        for e in top:
            print(f"    {e.self_device_time_total / 1e3 / reps:9.4f} ms  "
                  f"x{e.count / reps:5.0f}  {e.key[:90]}")
    return out


def phase_fault_transparency(res):
    import torch
    from repro_torch.launch import serve as launch
    clean = launch.main(SERVE_ARGS + ["--env", "none"])
    check(clean["summary"]["failures"] == 0, "the --env none run failed")
    diff = [r.rid for r in res["requests"]
            if res["engine"].output(r.rid) != clean["engine"].output(r.rid)]
    print(f"fault transparency: {len(res['requests']) - len(diff)}/"
          f"{len(res['requests'])} requests token-identical to the "
          f"failure-free run" + (f" (DIFFER: {diff})" if diff else ""))
    check(not diff, f"failures changed the tokens of requests {diff}")
    del clean
    torch.cuda.empty_cache()


def phase_reference(res):
    """Engine tokens against the batch=1 reference.  The two paths differ
    in prompt padding and decode batch width, so the matrix products may
    round differently; a divergence is accepted only where the reference's
    logit gap between the two tokens is below BOUND = 4 * delta, delta the
    largest logit difference measured between the two paths' prefill
    (bucket-padded vs exact) and first decode step (batch 4 vs batch 1)
    (2 for the two logits, 2 for growth over the decode steps)."""
    import torch
    from repro_torch.distributed.steps import (make_prefill_step,
                                               make_serve_step)
    from repro_torch.serve import greedy_decode, prompt_bucket
    eng, cfg = res["engine"], res["engine"].cfg
    params, cache_len = eng.params, res["cache_len"]
    pre = make_prefill_step(cfg, cache_len)
    serve = make_serve_step(cfg)
    delta = 0.0
    for r in res["requests"]:
        p = r.prompt_len
        toks = torch.zeros((1, prompt_bucket(p)), dtype=torch.int32)
        toks[0, :p] = torch.as_tensor(r.prompt)
        lp, _ = pre(params, {"tokens": toks.cuda()},
                        torch.tensor([p - 1], device="cuda"))
        le, cache = pre(params, {"tokens": toks[:, :p].cuda()})
        delta = max(delta, float((lp - le).abs().max()))
        tok = torch.argmax(le, -1).to(torch.int32)[:, None]
        wide = {k: v.expand(-1, eng.pool.n_slots, -1, -1, -1).clone()
                for k, v in cache.items()}
        _, l1, _ = serve(params, cache, tok, p)
        _, l4, _ = serve(params, wide, tok.expand(eng.pool.n_slots, 1), p)
        delta = max(delta, float((l4 - l1).abs().max()))
    bound = 4 * delta
    print(f"reference parity: measured path logit difference delta "
          f"{delta:.4g}, divergence bound 4*delta = {bound:.4g}")
    exact, worst = 0, 0.0
    for r in res["requests"]:
        ref_toks, logits = greedy_decode(params, cfg, r, cache_len,
                                         device="cuda")
        got = eng.output(r.rid)
        t = next((i for i, (a, b) in enumerate(zip(got, ref_toks))
                  if a != b), None)
        if t is None:
            check(len(got) == len(ref_toks), f"rid {r.rid}: length differs")
            exact += 1
            continue
        gap = float(logits[t, ref_toks[t]] - logits[t, got[t]])
        worst = max(worst, gap)
        print(f"  rid {r.rid}: first differs at step {t} "
              f"(engine {got[t]}, reference {ref_toks[t]}), reference gap "
              f"{gap:.4g} {'<=' if gap <= bound else '>'} bound")
        check(gap <= bound, f"rid {r.rid}: divergence at step {t} with "
                            f"logit gap {gap:.4g} > bound {bound:.4g}")
    print(f"reference parity: {exact}/{len(res['requests'])} token-exact, "
          f"largest divergence gap {worst:.4g} (bound {bound:.4g})")
    return {"exact": exact, "delta": delta, "bound": bound, "worst_gap": worst}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a GPU only", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port under {SRC}; run it from a checkout of "
              f"the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(card, f"nvidia-smi gave nothing: {smi.stderr.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # 2. build
    from repro_torch.kernels import _build
    secs = _build.build_all()
    print(f"build: {len(_build.SOURCES)} kernels with nvcc for sm_90a in "
          f"{secs:.1f} s")
    for name, log in sorted(_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 3. kernels
    print("kernels against their plain versions on the card:")
    pa_rec, fa_rec = phase_kernels()
    # 4-6. serve, fault transparency, reference parity
    res, _, launches = phase_serve()
    profile_engine(res)
    phase_fault_transparency(res)
    phase_reference(res)
    kernels = [
        {"name": "pairwise_distance", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pairwise_distance.cu",
         "replaces": "src/repro/kernels/pairwise_affinity/kernel.py:22",
         "launches": launches["pairwise_distance"], "shape": pa_rec["shape"],
         **{k: pa_rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:24",
         "launches": launches["flash_attention"], "shape": fa_rec["shape"],
         **{k: fa_rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}},
    ]
    print("kernels: " + "; ".join(
        f"{k['name']} launches={k['launches']} ms={k['ms']:.4f} "
        f"plain_ms={k['plain_ms']:.4f} library_ms={k['library_ms']:.4f} "
        f"bound_ms={k['bound_ms']:.5f} ({k['bound_by']}) "
        f"max_abs_err={k['max_abs_err']:.3g} at {k['shape']}"
        for k in kernels))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
