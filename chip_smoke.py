#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one card

Phases, in order; the first failure ends the run with a non-zero exit:

1. device: the card's name and power limit (``nvidia-smi``); no CUDA, no run;
2. build: ``nvcc`` compiles every ``kernels/csrc/*.cu`` for sm_90a, in
   parallel, into ``build/kernels``; prints ptxas's registers and spill
   bytes of the backward's kernels and fails if its bf16 (tensor-core)
   kernels spill; ``cuobjdump -sass`` counts each library's ``HGMMA``
   (wgmma) and ``UTMALDG`` (TMA load) instructions, and the run fails if a
   bf16 flash-attention kernel, forward or backward, has none of either;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the JAX package's test shapes, at the serve paths' shapes and at large
   ones, with times (CUDA events, median of 25 after warm-up, the host's
   submission included, and the device's time alone) beside the plain
   version's, a library call's and the card's bound (and the share of it
   reached); bf16 flash attention also at a grid that covers every SM
   (128-row query blocks), which must give the same bits, and its fp32
   SIMT instance timed on its own; WKV6 also at its 16-token chunk edges
   and at both ends of log_w's clamp, against its sequential and its
   chunked plain version; WKV6 and pairwise distance give the same bits
   on a repeat call; the flash-attention backward against its plain
   version in fp32 on the same inputs at olmo-1b's training shape (timed
   beside SDPA's backward, whose own error against the same reference is
   printed at every case), at its tile edges, GQA groups 1/2/4 and
   windows 1/37/2048, in fp32 and bf16, with the forward's row
   log-sum-exp against its plain version, the forward's bits unchanged
   when it writes the lse, a bit-identical repeat, and a x1.1
   softmax-scale mutant of the backward failing the limit;
4. planner: the CRCH workflow planner at the paper's largest size, each
   of the four workflow types at 700 tasks on 20 VMs under each of the
   three failure environments: ``crch.plan`` on the card (PCA and B1 there,
   one B1 launch a plan), then CRCH, HEFT and ReplicateAll(3) over 10
   seeded failure traces each; prints each plan's K, replication counts,
   lambda*, phase times and the three algorithms' metrics, and requires
   CRCH to complete every workflow.  B1 is held against its plain version
   at the four projections (the cancellation-bound rule for near-coincident
   tasks) and timed there; each type's card plan under ``normal`` is held
   against the CPU's plan (equal, or the near-tie rule of
   ``core.clustering.compare_merges``), and a repeated card plan must be
   identical;
5. then, for each family the port serves (olmo-1b, rwkv6-3b,
   recurrentgemma-2b), at full width (random seeded weights, bf16):

   a. serve: the port's launcher with CRCH replication under the
      ``unstable`` failure environment; every request must complete,
      failures must have been recovered from snapshots, and every kernel of
      the family's path must have been launched (all launch counts are
      zeroed just before this phase and read just after);
   b. profile: one prefill and a few batched decode steps of that engine
      under ``torch.profiler``;
   c. fault transparency: the same requests with no failures give the same
      tokens, token for token (paper: checkpointed resubmission does not
      change the output);
   d. reference parity: engine tokens against the batch=1 greedy reference;
      where they part, the reference's logit gap between the two tokens must
      be below a bound derived from measured logit differences.

   Each family's engines are freed before the next family starts.

6. train: olmo-1b at full width and depth (16 layers, d_model 2048, fp32
   params, bf16 compute, global batch 4 x 2048 tokens, deterministic
   kernels) through the train launcher's code path under the training
   coordinator, with one host crash forced through the failure injector:
   every step completes, restores == failures > 0, all losses finite, both
   flash kernels launched, and the final params bit-identical (a sha1 of
   every leaf) to a fault-free run of the same steps from the same init on
   the same batches; prints step time, tokens/s, model FLOPs a step,
   checkpoint save/restore seconds and bytes, and a ``torch.profiler``
   view of one step;
7. train chaos: the launcher's code path at the published widths with 2
   layers, replaying a fault trace that fires every train-side fault class
   (host_crash, slowdown, capacity_loss, ckpt_corrupt, nan_poison,
   net_partition, disk_full) under the launcher's ``--chaos-assert``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense): the bound of a kernel's time
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"bfloat16": 989e12, "float32": 67e12}   # fp32: no tensor core
SLEEP_CYCLES = 2_000_000   # ~1 ms at the H100's clock: covers a submission

PA_SHAPES = [(16, 4), (100, 10), (130, 3), (256, 64), (4096, 10)]
FA_TEST_SHAPES = [(1, 4, 2, 128, 128), (2, 8, 8, 256, 128),
                  (1, 2, 1, 130, 128), (1, 4, 2, 384, 256)]
FA_BIG_SHAPES = [(1, 16, 16, 512, 128), (4, 16, 16, 2048, 128)]
# fp32: the JAX tests' limit.  bf16 flash attention: the kernel rounds the
# output to bf16 once and, on the tensor cores, each probability P to bf16
# before the PV product (at most 2^-9 absolute, |P| <= 1), where the plain
# version keeps P in fp32; the limit stays one bf16 ulp of the output
# (<= 2^-7 |x|) over a 4e-3 floor.  WKV6 on bf16 r, k, v: both sides
# compute in fp32 and round the output once, one output ulp (its fp32 limit
# is the one tests/test_kernels.py gives the model's chunked path)
FA_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
          "bfloat16": dict(atol=4e-3, rtol=1e-2)}
WKV_TOL = {"float32": dict(atol=2e-4, rtol=1e-3),
           "bfloat16": dict(atol=4e-3, rtol=1e-2)}
LRU_TOL = dict(atol=2e-4, rtol=2e-4)
PA_TOL = dict(atol=3e-3, rtol=1e-3)
# the JAX test shapes of the two scans (tests/test_kernels.py)
WKV_TEST_SHAPES = [(1, 2, 32, 64), (2, 3, 48, 64), (1, 1, 20, 64),
                   (1, 2, 64, 128)]
# B3's chunk edges (16-token chunks) and a long prompt, at rwkv6's 40 heads
WKV_EDGE_T = (0, 1, 15, 16, 17, 33, 3000)
LRU_TEST_SHAPES = [(2, 128, 128), (3, 100, 96), (8, 256, 256), (1, 17, 130)]
# the flash-attention backward: each gradient against the plain backward in
# fp32 on the same inputs (o and lse from the forward kernel), normalised by
# max(1, its largest magnitude): fp32 at the JAX tests' limit; bf16 one
# bf16 ulp of the gradient (rtol 1e-2) over a floor of 4e-3 of that scale
# (the kernel computes in fp32 and rounds each gradient to bf16 once).  The
# row log-sum-exp is fp32 on both sides
FA_BWD_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
              "bfloat16": dict(atol=4e-3, rtol=1e-2)}
LSE_TOL = dict(atol=2e-4, rtol=2e-4)
# olmo-1b's training shape: global batch 4 x 2048 tokens, 16 heads of 128
FA_BWD_MAIN = (4, 16, 16, 2048, 128)
# the 64-row tiles' edges, at (1, 4, 2, S, D)
FA_BWD_EDGE_S = (1, 63, 64, 65, 127, 129, 2048)
# (B, H, KV, S, D, window): GQA groups 1, 2, 4, windows 1, 37, 2048
FA_BWD_CASES = [(2, 4, 4, 200, 128, 0), (2, 4, 2, 200, 128, 0),
                (2, 8, 2, 200, 64, 0), (1, 4, 2, 300, 64, 1),
                (1, 4, 2, 300, 128, 37), (1, 4, 4, 2100, 128, 2048)]

# the families served, each with its prompt length and the kernels its
# serve path must launch
FAMILIES = {
    "olmo-1b": (384, ("pairwise_distance", "flash_attention")),
    "rwkv6-3b": (384, ("pairwise_distance", "wkv6")),
    # prompts draw from 1536..3072 tokens: most exceed the 2048 window
    "recurrentgemma-2b": (3072, ("pairwise_distance", "flash_attention",
                                 "lru_scan")),
}


def serve_args(arch):
    return ["--arch", arch, "--requests", "8", "--prompt-len",
            str(FAMILIES[arch][0]), "--new-tokens", "32", "--workers", "2",
            "--slots-per-worker", "2", "--policy", "crch", "--seed", "0",
            "--device", "cuda"]

# the planner phase: the paper's workflow types at its largest size
PLANNER_KINDS = ("montage", "cybershake", "ligo", "sipht")
PLANNER_ENVS = ("stable", "normal", "unstable")
PLANNER_SIZE = 700
PLANNER_RUNS = 10


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def wrappers():
    """Kernel name -> its wrapper, which carries the launch count."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.pairwise_affinity import ops as pa_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rwkv6_scan import ops as wk_ops
    return {"pairwise_distance": pa_ops.pairwise_distance,
            "flash_attention": fa_ops.flash_attention,
            "flash_attention_bwd": fa_ops.flash_attention_bwd,
            "wkv6": wk_ops.wkv6, "lru_scan": lru_ops.lru_scan}


def time_ms(fn, iters=25, warmup=3, queued=False):
    """Median of per-call CUDA-event times, after warm-up.  The events
    bracket the host's submission of the call too.  ``queued``: each call
    is queued behind a ~1 ms sleep kernel, so that the host has submitted
    it before the first event fires and the time is the device's alone."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_kernel(rec, fn, prefix=""):
    """A call's time with the host's submission (``ms``) and the device's
    alone (``device_ms``), under ``prefix`` (``library_`` for the library
    call)."""
    rec[prefix + "ms"] = time_ms(fn)
    rec[prefix + "device_ms"] = time_ms(fn, queued=True)


def add_bound(rec, bytes_, flops, dtype):
    """The card's least time for the work (bytes once over the memory rate,
    operations over the peak for ``dtype``, the larger) and the share of it
    the kernel reached."""
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    rec["bound_ms"] = max(t_bytes, t_ops)
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]


def _timing_text(rec, library):
    lib = (f"{library} {rec['library_ms']:.4f} ms (device "
           f"{rec['library_device_ms']:.4f})"
           if rec["library_ms"] is not None else f"{library}: none")
    return (f" | kernel {rec['ms']:.4f} ms (device "
            f"{rec['device_ms']:.4f}) plain {rec['plain_ms']:.4f} ms "
            f"{lib} bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}, "
            f"share {rec['bound_share']:.3f})")


def ptxas_report(log):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from a
    ``ptxas -v`` log, by short name (``flash_bwd_dq_tc<128,2>``)."""
    import re
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            ints = re.search(r"(flash_[a-z_]+?)I((?:Li\d+E)+)E", m.group(1))
            typed = re.search(r"(flash_[a-z_]+?)I(\w+?)EEv", m.group(1))
            fn = (f"{ints.group(1)}<"
                  f"{','.join(re.findall(r'Li(\d+)E', ints.group(2)))}>"
                  if ints else f"{typed.group(1)}<{typed.group(2)}>"
                  if typed else m.group(1))
            out[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m[1])
    return out


def phase_build_report(build):
    """Every kernel's ptxas lines; the backward kernels' registers and spill
    bytes by name, and no spill in its bf16 (tensor-core) kernels."""
    for name, log in sorted(build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print(f"  ptxas {name}: {line.strip()}")
    report = ptxas_report(build.build_logs.get("flash_attention_bwd", ""))
    check(report, "no ptxas report of the flash-attention backward")
    for fn, r in sorted(report.items()):
        print(f"  ptxas flash_attention_bwd {fn}: {r.get('registers')} "
              f"registers, spill stores {r.get('spill_stores')} B, spill "
              f"loads {r.get('spill_loads')} B")
    tc = {fn: r for fn, r in report.items() if "_tc<" in fn}
    check(tc and all(r.get("spill_stores") == r.get("spill_loads") == 0
                     for r in tc.values()),
          f"the bf16 backward kernels spill: {tc}")


def phase_sass(build):
    """Counts of HGMMA (wgmma) and UTMALDG (TMA load) in each library's SASS,
    by kernel; the bf16 flash-attention kernels, forward and backward, must
    hold both."""
    import re
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    by_fn = {}
    for name in build.SOURCES:
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build._lib_path(name))],
                              capture_output=True, text=True, timeout=120)
        check(sass.returncode == 0, f"cuobjdump failed on {name}: "
                                    f"{sass.stderr.strip()}")
        fn, counts = None, {}
        for line in sass.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
            elif fn:
                for op in ("HGMMA", "UTMALDG"):
                    counts[fn][op] += op in line
        total = {op: sum(c[op] for c in counts.values())
                 for op in ("HGMMA", "UTMALDG")}
        print(f"  sass {name}: HGMMA {total['HGMMA']}, UTMALDG "
              f"{total['UTMALDG']} in {len(counts)} kernels")
        by_fn.update({f"{name}:{fn}": c for fn, c in counts.items()})
    tc = {fn: c for fn, c in by_fn.items()
          if any(fn.startswith(f"flash_attention{lib}:") and k in fn
                 for lib, k in (("", "flash_fwd_tc"),
                                ("_bwd", "flash_bwd_dq_tc"),
                                ("_bwd", "flash_bwd_dkdv_tc")))}
    for fn, c in sorted(tc.items()):
        print(f"    {fn[:60]}: HGMMA {c['HGMMA']} UTMALDG {c['UTMALDG']}")
    check(any("flash_bwd_dq_tc" in fn for fn in tc)
          and any("flash_bwd_dkdv_tc" in fn for fn in tc),
          "no bf16 backward kernel in the SASS")
    check(tc and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                     for c in tc.values()),
          "a bf16 flash-attention kernel holds no HGMMA or no UTMALDG "
          "instruction")


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
    same = bool(torch.equal(got, ops.pairwise_distance(x)))
    rec = {"shape": [n, f], "max_abs_err": err, "ok": bool(ok) and same}
    if timed:
        time_kernel(rec, lambda: ops.pairwise_distance(x))
        rec["plain_ms"] = time_ms(lambda: ref.pairwise_distance(x))
        time_kernel(rec, lambda: torch.cdist(
            x, x, compute_mode="use_mm_for_euclid_dist"), "library_")
        add_bound(rec, 4 * (n * f + n * n), n * n * (3 * f + 4), "float32")
    print(f"  pairwise_distance {n}x{f}: max_abs_err {err:.3g} "
          f"(off-diagonal atol 3e-3 rtol 1e-3; diagonal <= sqrt(8 eps "
          f"|x|^2)){'' if same else ', REPEAT DIFFERS'} "
          f"{'ok' if ok else 'FAIL'}"
          + (_timing_text(rec, "cdist") if timed else ""))
    check(ok, f"pairwise_distance {n}x{f} disagrees with its plain version")
    check(same, f"pairwise_distance {n}x{f}: a repeat call changed the bits")
    return rec


def flash_wide_grid_check(q, k, v, got, causal, window):
    """The bf16 kernel takes 128-row query blocks where its grid covers
    every SM, else 64: the batch repeated until it does must give the same
    bits in every copy.  Returns that grid's size (0: no check needed)."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    b, h, s, _ = q.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = -(-s // 128) * b * h
    if grid >= sms:
        return 0
    reps = -(-sms // grid)
    wide = ops.flash_attention(*(x.repeat(reps, 1, 1, 1) for x in (q, k, v)),
                               causal=causal, window=window)
    check(all(torch.equal(wide[i * b:(i + 1) * b], got)
              for i in range(reps)),
          f"flash_attention {tuple(q.shape)} changed its bits at a grid of "
          f"{grid * reps} blocks of 128 query rows")
    return grid * reps


def flash_case(b, h, kv, s, d, dtype_name, causal, *, timed, window=0):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    dt = getattr(torch, dtype_name)
    rng = np.random.default_rng(b * 7 + h * 5 + s + d + window)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to("cuda", dt)
               for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.attention(q, k, v, causal=causal, window=window)
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), **FA_TOL[dtype_name]))
    rec = {"shape": [b, h, kv, s, d], "dtype": dtype_name, "causal": causal,
           "window": window, "max_abs_err": err, "ok": ok}
    wide = (flash_wide_grid_check(q, k, v, got, causal, window)
            if dtype_name == "bfloat16" and d <= 128 else 0)
    if timed:
        time_kernel(rec, lambda: ops.flash_attention(
            q, k, v, causal=causal, window=window))
        rec["plain_ms"] = time_ms(lambda: ref.attention(
            q, k, v, causal=causal, window=window))
        gqa = {"enable_gqa": True} if h != kv else {}
        if window:
            diff = (torch.arange(s, device="cuda")[:, None]
                    - torch.arange(s, device="cuda")[None, :])
            mask = (diff >= 0) & (diff < window)
            time_kernel(rec, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, **gqa), "library_")
            pairs = sum(min(i + 1, window) for i in range(s))
        else:
            time_kernel(rec, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, **gqa), "library_")
            pairs = s * (s + 1) // 2 if causal else s * s
        item = q.element_size()
        add_bound(rec, item * (2 * b * h * s * d + 2 * b * kv * s * d),
                  4 * b * h * pairs * d, dtype_name)
    tol = FA_TOL[dtype_name]
    mode = (f"window {window}" if window else
            "causal" if causal else "bidir")
    print(f"  flash_attention {(b, h, kv, s, d)} {dtype_name} {mode}: "
          f"max_abs_err {err:.3g} (atol {tol['atol']} rtol {tol['rtol']}) "
          f"{'ok' if ok else 'FAIL'}"
          + (f", same bits at {wide} blocks of 128 rows" if wide else "")
          + (_timing_text(rec, "sdpa") if timed else ""))
    check(ok, f"flash_attention {(b, h, kv, s, d)} {dtype_name} "
              f"{mode} disagrees with its plain version")
    return rec


def _bwd_inputs(b, h, kv, s, d, dtype_name, window):
    """q, k, v, dO as the model hands them to the kernels: (B, H, S, D)
    views of (B, S, H, D) tensors."""
    import numpy as np
    import torch
    rng = np.random.default_rng(b * 7 + h * 5 + s + d + window + 1)
    return [torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(
        np.float32)).to("cuda", getattr(torch, dtype_name)).transpose(1, 2)
        for n in (h, kv, kv, h)]


def _bwd_check(got, want, dtype_name):
    """(max abs error, max error over the gradient's scale, within the
    limit) of the three gradients."""
    import torch
    err = nerr = 0.0
    ok = True
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        e = float((g.float() - w).abs().max())
        err, nerr = max(err, e), max(nerr, e / scale)
        ok = ok and bool(torch.allclose(g.float() / scale, w / scale,
                                        **FA_BWD_TOL[dtype_name]))
    return err, nerr, ok


def _sdpa_graph(q, k, v, causal, window):
    """Leaf copies of q, k, v and SDPA's output on them (the same mask), for
    SDPA's backward as a yardstick: never the port's path."""
    import torch
    import torch.nn.functional as F
    qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q, k, v))
    kw = {"enable_gqa": True} if q.shape[1] != k.shape[1] else {}
    if window:
        s = q.shape[2]
        diff = (torch.arange(s, device="cuda")[:, None]
                - torch.arange(s, device="cuda")[None, :])
        kw["attn_mask"] = (diff >= 0) & (diff < window)
    else:
        kw["is_causal"] = causal
    return (qq, kk, vv), F.scaled_dot_product_attention(qq, kk, vv, **kw)


def flash_bwd_case(b, h, kv, s, d, dtype_name, causal, *, timed, window=0):
    """The backward kernel against the plain backward in fp32 on the same
    inputs, beside SDPA's backward against the same reference; the
    forward's lse against its plain version and the forward's bits with and
    without it; a repeat call's bits."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v, do = _bwd_inputs(b, h, kv, s, d, dtype_name, window)
    kw = dict(causal=causal, window=window)
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    same_fwd = bool(torch.equal(o, ops.flash_attention(q, k, v, **kw)))
    lse_want = ref.attention_lse(q, k, v, **kw)
    lse_err = float((lse - lse_want).abs().max())
    lse_ok = bool(torch.allclose(lse, lse_want, **LSE_TOL))
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = ref.attention_backward(q.float(), k.float(), v.float(), o.float(),
                                  lse, do.float(), **kw)
    err, nerr, ok = _bwd_check(got, want, dtype_name)
    leaves, out = _sdpa_graph(q, k, v, causal, window)
    sdpa_nerr = _bwd_check(torch.autograd.grad(out, leaves, do), want,
                           dtype_name)[1]
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    same = all(bool(torch.equal(x, y)) for x, y in zip(got, again))
    del want, again, leaves, out
    rec = {"shape": [b, h, kv, s, d], "dtype": dtype_name, "causal": causal,
           "window": window, "max_abs_err": err, "max_err_over_scale": nerr,
           "sdpa_err_over_scale": sdpa_nerr, "lse_err": lse_err,
           "ok": ok and lse_ok and same_fwd and same}
    if timed:
        time_kernel(rec, lambda: ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                         **kw))
        rec["plain_ms"] = time_ms(lambda: ref.attention_backward(
            q, k, v, o, lse, do, **kw))
        # SDPA's backward, as a yardstick only
        leaves, out = _sdpa_graph(q, k, v, causal, window)
        time_kernel(rec, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), "library_")
        pairs = s * (s + 1) // 2 if causal else s * s
        item = q.element_size()
        # q, o, dO and dq (B, H, S, D); k, v, dk, dv (B, KV, S, D); lse
        add_bound(rec, item * (4 * b * h * s * d + 4 * b * kv * s * d)
                  + 4 * b * h * s, 10 * b * h * pairs * d, dtype_name)
    tol = FA_BWD_TOL[dtype_name]
    mode = (f"window {window}" if window else
            "causal" if causal else "bidir")
    print(f"  flash_attention_bwd {(b, h, kv, s, d)} {dtype_name} {mode}: "
          f"max_abs_err {err:.3g}, over the gradient's scale {nerr:.3g} "
          f"(atol {tol['atol']} rtol {tol['rtol']} of max(1, |grad|max); "
          f"SDPA's backward {sdpa_nerr:.3g}); "
          f"lse err {lse_err:.3g} (2e-4); forward bits "
          f"{'unchanged' if same_fwd else 'CHANGED'} with lse; repeat "
          f"{'same bits' if same else 'DIFFERS'} "
          f"{'ok' if rec['ok'] else 'FAIL'}"
          + (_timing_text(rec, "sdpa backward") if timed else ""))
    check(ok, f"flash_attention_bwd {(b, h, kv, s, d)} {dtype_name} {mode} "
              f"disagrees with its plain version")
    check(lse_ok, f"flash_attention lse {(b, h, kv, s, d)} {dtype_name} "
                  f"disagrees with its plain version")
    check(same_fwd, f"flash_attention {(b, h, kv, s, d)}: writing the lse "
                    f"changed the output's bits")
    check(same, f"flash_attention_bwd {(b, h, kv, s, d)}: a repeat call "
                f"changed the bits")
    return rec


def flash_bwd_mutant_case(b, h, kv, s, d, dtype_name):
    """The limit's power: the backward kernel launched with its softmax
    scale x 1.1 (the wrapper's own call with that one argument changed)
    must fail the check that the true kernel passes."""
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v, do = _bwd_inputs(b, h, kv, s, d, dtype_name, 0)
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    loader = ops._bwd_fn
    real = loader()

    def mutant(*args):
        args = list(args)
        # the softmax scale: P's exponent and dQ, dK in both the tensor-core
        # and the SIMT kernels
        args[19] *= 1.1
        return real(*args)

    ops._bwd_fn = lambda: mutant
    try:
        got = ops.flash_attention_bwd(q, k, v, o, lse, do)
    finally:
        ops._bwd_fn = loader
    want = ref.attention_backward(q.float(), k.float(), v.float(), o.float(),
                                  lse, do.float())
    err, nerr, ok = _bwd_check(got, want, dtype_name)
    print(f"  flash_attention_bwd x1.1 softmax-scale mutant "
          f"{(b, h, kv, s, d)} {dtype_name}: max error over the gradient's "
          f"scale {nerr:.3g}, {'passes (BAD)' if ok else 'fails the limit'}")
    check(not ok, "a x1.1 softmax-scale mutant of the backward passes the "
                  "limit")


def _max_err(got, want):
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def wkv6_case(b, h, t, n, dtype_name, with_s0, *, timed, fill="uniform"):
    """The kernel on (B, H, T, N) inputs in ``dtype_name`` (r, k, v) against
    the plain versions (sequential, and chunked as the kernel computes)
    evaluated in fp64 on the same rounded inputs: over thousands of tokens
    with decays near 1 the sequential fp32 version drifts past the fp32
    limit itself, and its own error is printed.  ``fill``: log_w uniform
    in [-2.5, -0.01], or all at an end of the model's clamp ("min" -2.5,
    "max" -1e-4)."""
    import numpy as np
    import torch
    from repro_torch.kernels.rwkv6_scan import ops, ref
    dt = getattr(torch, dtype_name)
    rng = np.random.default_rng(b * 3 + h * 11 + t + n)

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)

    r, k, v = (dev(0.5 * rng.normal(size=(b, h, t, n)), dt)
               for _ in range(3))
    lw = dev({"uniform": -rng.uniform(0.01, 2.5, (b, h, t, n)),
              "min": np.full((b, h, t, n), -2.5),
              "max": np.full((b, h, t, n), -1e-4)}[fill])
    u = dev(0.2 * rng.normal(size=(h, n)))
    S0 = dev(0.3 * rng.normal(size=(b, h, n, n))) if with_s0 else None
    o, S = ops.wkv6(r, k, v, lw, u, S0)
    torch.cuda.synchronize()
    args = (r.float(), k.float(), v.float(), lw, u, S0)
    args64 = [None if x is None else x.double() for x in args]
    err, ok = 0.0, True
    seq64 = ref.wkv6(*args64)
    for want_o, want_S in (seq64, ref.wkv6_chunked(*args64,
                                                   chunk=ops.CHUNK)):
        want_o, want_S = want_o.float(), want_S.float()
        err = max(err, _max_err(o, want_o), _max_err(S, want_S))
        ok = ok and bool(
            torch.allclose(o.float(), want_o, **WKV_TOL[dtype_name])
            and torch.allclose(S, want_S, **WKV_TOL["float32"]))
    # the plain sequential version in fp32 against the same fp64 oracle
    seq32 = ref.wkv6(*args)
    plain_err = max(_max_err(seq32[0], seq64[0].float()),
                    _max_err(seq32[1], seq64[1].float()))
    o2, S2 = ops.wkv6(r, k, v, lw, u, S0)
    same = bool(torch.equal(o, o2) and torch.equal(S, S2))
    rec = {"shape": [b, h, t, n], "dtype": dtype_name, "s0": with_s0,
           "fill": fill, "max_abs_err": err, "plain_fp32_err": plain_err,
           "ok": ok and same}
    if timed:
        time_kernel(rec, lambda: ops.wkv6(r, k, v, lw, u, S0))
        rec["plain_ms"] = time_ms(lambda: ref.wkv6(r, k, v, lw, u, S0))
        rec["library_ms"] = None   # no single PyTorch call computes WKV6
        rec["library_device_ms"] = None
        item = r.element_size()
        state = (2 if with_s0 else 1) * 4 * b * h * n * n
        add_bound(rec, (4 * item + 4) * b * h * t * n + 4 * h * n + state,
                  b * h * t * (4 * n * n + 3 * n), dtype_name)
    tol = WKV_TOL[dtype_name]
    print(f"  wkv6 {(b, h, t, n)} {dtype_name} "
          f"{'S0' if with_s0 else 'zero state'} log_w {fill}: max_abs_err "
          f"{err:.3g} against the sequential and chunked plain versions in "
          f"fp64 (o atol {tol['atol']} rtol {tol['rtol']}; S fp32 limit; "
          f"the sequential fp32 version's own error {plain_err:.3g})"
          f"{'' if same else ', REPEAT DIFFERS'} {'ok' if ok else 'FAIL'}"
          + (_timing_text(rec, "library") if timed else ""))
    check(ok, f"wkv6 {(b, h, t, n)} {dtype_name} disagrees with its plain "
              f"versions")
    check(same, f"wkv6 {(b, h, t, n)} {dtype_name}: a repeat call changed "
                f"the bits")
    return rec


def lru_case(b, s, w, with_h0, *, timed):
    import numpy as np
    import torch
    from repro_torch.kernels.rglru_scan import ops, ref
    rng = np.random.default_rng(b * 13 + s + w)

    def dev(x):
        return torch.from_numpy(x.astype(np.float32)).cuda()

    a = dev(rng.uniform(0.8, 0.999, (b, s, w)))
    x = dev(0.1 * rng.normal(size=(b, s, w)))
    h0 = dev(rng.normal(size=(b, w))) if with_h0 else None
    h, last = ops.lru_scan(a, x, h0)
    torch.cuda.synchronize()
    want, want_last = ref.lru_scan(a, x, h0)
    err = max(float((h - want).abs().max()),
              float((last - want_last).abs().max()))
    ok = bool(torch.allclose(h, want, **LRU_TOL)
              and torch.allclose(last, want_last, **LRU_TOL))
    rec = {"shape": [b, s, w], "h0": with_h0, "max_abs_err": err, "ok": ok}
    if timed:
        time_kernel(rec, lambda: ops.lru_scan(a, x, h0))
        rec["plain_ms"] = time_ms(lambda: ref.lru_scan(a, x, h0))
        rec["library_ms"] = None   # no single PyTorch call computes it
        rec["library_device_ms"] = None
        add_bound(rec, 4 * (3 * b * s * w + (2 if with_h0 else 1) * b * w),
                  2 * b * s * w, "float32")
    print(f"  lru_scan {(b, s, w)} {'h0' if with_h0 else 'zero state'}: "
          f"max_abs_err {err:.3g} (atol 2e-4 rtol 2e-4) "
          f"{'ok' if ok else 'FAIL'}"
          + (_timing_text(rec, "library") if timed else ""))
    check(ok, f"lru_scan {(b, s, w)} disagrees with its plain version")
    return rec


def family_requests(arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_parser, make_requests
    args = build_parser().parse_args(serve_args(arch))
    cfg = get_config(args.arch, tiny=args.tiny)
    return cfg, make_requests(cfg, args.requests, args.prompt_len,
                              args.new_tokens, args.seed)


def main_path_shapes():
    """The shapes each serve phase gives each kernel: B1 sees the request
    sample after PCA, B2 olmo's prompt buckets (causal) and
    recurrentgemma's longest prompt (window), B3 rwkv's longest prompt of a
    length that is not a multiple of 16, B4 recurrentgemma's longest."""
    from repro_torch.core.pca import fit_pca
    from repro_torch.serve import prompt_bucket, request_features
    cfg, reqs = family_requests("olmo-1b")
    k = fit_pca(request_features(reqs), device="cuda").projected.shape[1]
    fa = [(1, cfg.n_heads, cfg.n_kv_heads, s, cfg.head_dim)
          for s in sorted({prompt_bucket(r.prompt_len) for r in reqs})]
    rcfg, rreqs = family_requests("rwkv6-3b")
    t = max(r.prompt_len for r in rreqs if r.prompt_len % 16)
    wkv = (1, rcfg.d_model // 64, t, 64)
    gcfg, greqs = family_requests("recurrentgemma-2b")
    s = max(r.prompt_len for r in greqs)
    window = ((1, gcfg.n_heads, gcfg.n_kv_heads, s, gcfg.head_dim),
              gcfg.window)
    return (len(reqs), k), fa, wkv, window, (1, s, gcfg.lru_width)


def phase_kernels():
    pa_main, fa_main, wkv_main, (fw_shape, window), lru_main = \
        main_path_shapes()
    print(f"main-path shapes: pairwise {pa_main}, flash {fa_main} bf16 "
          f"causal, flash {fw_shape} bf16 window {window}, wkv6 {wkv_main} "
          f"bf16, lru_scan {lru_main} fp32")
    for n, f in PA_SHAPES:
        pairwise_case(n, f, timed=False)
    for shape in FA_TEST_SHAPES:
        for dt in ("float32", "bfloat16"):
            for causal in (True, False):
                flash_case(*shape, dt, causal, timed=False)
            flash_case(*shape, dt, True, timed=False, window=64)
    for shape in WKV_TEST_SHAPES:
        for dt in ("float32", "bfloat16"):
            wkv6_case(*shape, dt, True, timed=False)
    wkv6_case(*wkv_main, "float32", True, timed=False)
    for shape in LRU_TEST_SHAPES:
        for with_h0 in (False, True):
            lru_case(*shape, with_h0, timed=False)
    recs = {"pairwise_distance": pairwise_case(*pa_main, timed=True)}
    fa_recs = [flash_case(*shape, "bfloat16", True, timed=True)
               for shape in fa_main]
    recs["flash_attention"] = max(fa_recs, key=lambda r: r["shape"][3])
    # the fp32 SIMT kernel, at the tight limit, timed on its own
    fp32_recs = [flash_case(*shape, "float32", True, timed=True)
                 for shape in fa_main]
    recs["flash_attention_fp32"] = max(fp32_recs, key=lambda r: r["shape"][3])
    recs["flash_attention_window"] = flash_case(
        *fw_shape, "bfloat16", True, timed=True, window=window)
    flash_case(*fw_shape, "float32", True, timed=True, window=window)
    flash_case(*fw_shape, "bfloat16", True, timed=False, window=16)
    recs["wkv6"] = wkv6_case(*wkv_main, "bfloat16", True, timed=True)
    for fill in ("min", "max"):
        wkv6_case(*wkv_main, "bfloat16", True, timed=False, fill=fill)
    for t in WKV_EDGE_T:
        wkv6_case(1, wkv_main[1], t, 64, "bfloat16", True, timed=True)
    wkv6_case(1, wkv_main[1], WKV_EDGE_T[-1], 64, "float32", True,
              timed=False, fill="max")
    wkv6_case(2, 4, 77, 128, "float32", False, timed=False)
    lru_case(*lru_main, False, timed=False)
    recs["lru_scan"] = lru_case(*lru_main, True, timed=True)
    recs["pairwise_distance_large"] = pairwise_case(4096, 10, timed=True)
    big = [flash_case(*shape, "bfloat16", True, timed=True)
           for shape in FA_BIG_SHAPES]
    # olmo-1b's training shape, (4, 16, 16, 2048, 128)
    recs["flash_attention_train"] = big[-1]
    # the backward: olmo-1b's training shape, then its edges and cases
    recs["flash_attention_bwd"] = flash_bwd_case(*FA_BWD_MAIN, "bfloat16",
                                                 True, timed=True)
    flash_bwd_case(*FA_BWD_MAIN, "float32", True, timed=False)
    flash_bwd_mutant_case(*FA_BWD_MAIN, "bfloat16")
    for dt in ("float32", "bfloat16"):
        for d in (64, 128):
            for s in FA_BWD_EDGE_S:
                flash_bwd_case(1, 4, 2, s, d, dt, True, timed=False)
            flash_bwd_case(2, 4, 2, 129, d, dt, False, timed=False)
        for b, h, kv, s, d, window in FA_BWD_CASES:
            flash_bwd_case(b, h, kv, s, d, dt, True, timed=False,
                           window=window)
    return recs


# ---------------------------------------------------------------------------
# phase 4: the CRCH workflow planner at full size
# ---------------------------------------------------------------------------

def planner_b1_case(kind, pts_np):
    """B1 against its plain version at one plan's (N, K) projection, with
    the cancellation-bound rule for near-coincident tasks; timed."""
    import numpy as np
    import torch
    from repro_torch.core.clustering import distance_faults
    from repro_torch.kernels.pairwise_affinity import ops, ref
    x = torch.from_numpy(pts_np.astype(np.float32)).cuda()
    n, f = x.shape
    got = ops.pairwise_distance(x)
    torch.cuda.synchronize()
    want = ref.pairwise_distance(x)
    g, w = got.cpu().numpy(), want.cpu().numpy()
    bad, n_close = distance_faults(x.cpu().numpy(), g, w)
    err = float(np.abs(g - w).max())
    same = bool(torch.equal(got, ops.pairwise_distance(x)))
    rec = {"shape": [n, f], "max_abs_err": err, "close_pairs": n_close,
           "ok": not bad.any() and same}
    time_kernel(rec, lambda: ops.pairwise_distance(x))
    rec["plain_ms"] = time_ms(lambda: ref.pairwise_distance(x))
    time_kernel(rec, lambda: torch.cdist(
        x, x, compute_mode="use_mm_for_euclid_dist"), "library_")
    add_bound(rec, 4 * (n * f + n * n), n * n * (3 * f + 4), "float32")
    print(f"  pairwise_distance {kind} {n}x{f}: max_abs_err {err:.3g}, "
          f"{n_close} pairs inside the cancellation bound (each side within "
          f"sqrt(max(K+1, 4) eps (|x_p|^2 + |x_q|^2)) of the fp64 distance; "
          f"the rest atol 3e-3 rtol 1e-3), {int(bad.sum())} outside"
          f"{'' if same else ', REPEAT DIFFERS'} "
          f"{'ok' if rec['ok'] else 'FAIL'}" + _timing_text(rec, "cdist"))
    check(not bad.any(), f"pairwise_distance disagrees with its plain "
                         f"version at the {kind} planner points")
    check(same, f"pairwise_distance {kind} planner points: a repeat call "
                f"changed the bits")
    return rec


def phase_planner():
    """Plans on the card for every (type, env) and their simulations, with
    the launch counts zeroed just before and read just after; then the
    checks.  Returns the planner path's launch counts and B1's record at
    montage's projection."""
    import numpy as np
    from repro_torch.core import plan
    from repro_torch.core.clustering import compare_merges
    from repro_torch.launch import schedule as launch
    setups = {kind: launch.setup(kind, PLANNER_SIZE) for kind in PLANNER_KINDS}
    counted = wrappers()
    for fn in counted.values():
        fn.launches = 0
    card, card_plans = {}, 0
    for kind, (wf, env) in setups.items():
        for envname in PLANNER_ENVS:
            card[kind, envname] = launch.evaluate(wf, env, envname,
                                                  PLANNER_RUNS, device="cuda")
            card_plans += 1
    wf, env = setups[PLANNER_KINDS[0]]
    again = plan(wf, env, environment="normal", device="cuda")
    card_plans += 1
    launches = {name: fn.launches for name, fn in counted.items()}
    print(f"planner launches over {card_plans} card plans: {launches}")
    check(launches["pairwise_distance"] == card_plans,
          f"the planner launched pairwise_distance "
          f"{launches['pairwise_distance']} times in {card_plans} card plans")

    for (kind, envname), (p, res) in card.items():
        wf = setups[kind][0]
        hist = np.bincount(p.rep_counts, minlength=5)[1:].tolist()
        sim_s = res["CRCH"]["wall_s"] / PLANNER_RUNS
        print(f"planner {kind} {envname}: {wf.n_tasks} tasks, K "
              f"{p.pca.projected.shape[1]} (COV {p.pca.cov:.3f}), tasks with "
              f"1..4 copies {hist}, lambda* {p.ckpt_lambda:.2f} s, HEFT "
              f"makespan {p.schedule.makespan:.1f} s")
        print("  phases (host s; the device phases end in a copy to the "
              "host): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                    p.timing.items())
              + f", one CRCH simulate {sim_s:.4f}")
        for line in launch.table(res):
            print(f"  {line}")
        check(res["CRCH"]["success_rate"] == 1.0,
              f"CRCH failed {kind} workflows under {envname}: success rate "
              f"{res['CRCH']['success_rate']}")

    recs = {}
    for kind in PLANNER_KINDS:
        recs[kind] = planner_b1_case(kind, card[kind, "normal"][0]
                                     .pca.projected)

    equal = 0
    for kind, (wf, env) in setups.items():
        p = card[kind, "normal"][0]
        cpu = plan(wf, env, environment="normal", device="cpu")
        verdict = compare_merges(p.clustering, cpu.clustering,
                                 p.pca.projected, cpu.pca.projected)
        same = bool(np.array_equal(p.rep_counts, cpu.rep_counts))
        equal += same
        print(f"  card vs CPU plan {kind}: rep_counts "
              f"{'equal' if same else 'differ'}, merges {verdict.verdict}"
              + (f" at step {verdict.step} (picks {verdict.pairs}, excess "
                 f"{verdict.excess[0]:.3g} / {verdict.excess[1]:.3g}, bound "
                 f"{verdict.bound:.3g})" if verdict.step is not None else "")
              + f", lambda* {p.ckpt_lambda:.2f} / {cpu.ckpt_lambda:.2f}")
        check(verdict.ok, f"{kind}: the card's plan diverged from the CPU's "
                          f"beyond the near-tie rule: {verdict}")
        if verdict.verdict == "equal":
            check(same and p.schedule.placements == cpu.schedule.placements,
                  f"{kind}: equal merges but another plan")
    print(f"planner: {equal}/{len(PLANNER_KINDS)} card plans equal to the "
          f"CPU's under normal, the rest within the near-tie rule")
    first = card[PLANNER_KINDS[0], "normal"][0]
    check(np.array_equal(again.rep_counts, first.rep_counts)
          and again.clustering.merge_history
          == first.clustering.merge_history
          and again.schedule.placements == first.schedule.placements
          and again.ckpt_lambda == first.ckpt_lambda,
          "a repeated card plan differs")
    print(f"planner: a repeated {PLANNER_KINDS[0]} card plan is identical")
    return launches, recs[PLANNER_KINDS[0]]


# ---------------------------------------------------------------------------
# phase 5: each family's serve path at full width
# ---------------------------------------------------------------------------

def phase_serve(arch):
    from repro_torch.launch import serve as launch
    counted = wrappers()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = launch.main(serve_args(arch) + ["--env", "unstable"])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    s, eng = res["summary"], res["engine"]
    tm = eng.timing
    plens = [r.prompt_len for r in res["requests"]]
    serve_rec = {
        "arch": arch, "tok_s": res["tok_s"], "wall_s": res["wall_s"],
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
        "prompt_lens": plens, "launches": launches}
    print(f"serve {arch} (unstable): {json.dumps(serve_rec)} "
          f"(phase {wall:.1f} s)")
    cfg = eng.cfg
    if cfg.rwkv or cfg.rglru:
        odd = [p for p in plens if p % 16]
        print(f"  exact-length prefill: {len(odd)}/{len(plens)} prompt "
              f"lengths not a multiple of 16 (e.g. {odd[:3]})")
        check(odd, "no prompt length off the 16-token grid")
    if cfg.rglru:
        over = sum(p > cfg.window for p in plens)
        print(f"  {over}/{len(plens)} prompts exceed the {cfg.window}-token "
              f"window (longest {max(plens)})")
        check(over, "no prompt exceeds the local-attention window")
    n = len(res["requests"])
    check(serve_rec["completed"] == n,
          f"{arch}: {serve_rec['completed']}/{n} requests completed")
    check(serve_rec["failures"] >= 1, f"{arch}: the unstable run saw no "
                                      f"failure")
    check(serve_rec["restores"] >= 1,
          f"{arch}: no snapshot restore in the unstable run")
    for name in FAMILIES[arch][1]:
        check(launches[name] > 0, f"the {arch} serve path never launched "
                                  f"{name}")
    return res, serve_rec, launches


def _prefill_len(cfg, plen):
    from repro_torch.serve import prompt_bucket
    return plen if (cfg.rwkv or cfg.rglru) else prompt_bucket(plen)


# the port's own kernels, by the names the profiler gives them
PORT_KERNELS = ("pairwise_distance_kernel", "flash_fwd", "flash_bwd",
                "wkv6_", "lru_chunk")


def _profile(label, fn, reps):
    """torch.profiler over ``reps`` calls of ``fn`` after two warm-up calls:
    host wall time, device busy time (sum of kernel times; one stream, so
    no overlap), the device's idle share, kernels a call, device time by
    group (the port's kernels, the library's matrix products, the rest),
    the top kernels by device time and the port's own kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(), fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    evs = [e for e in prof.key_averages() if "CUDA" in str(e.device_type)]
    check(evs, f"torch.profiler recorded no CUDA kernel in {label}")
    busy = sum(e.self_device_time_total for e in evs) / 1e3 / reps
    launches = sum(e.count for e in evs) / reps
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    out = {"wall_ms": wall, "device_busy_ms": busy,
           "idle_share": max(0.0, 1 - busy / wall),
           "kernels_per_call": launches, "port_kernels_ms": {}}
    print(f"profile {label}: host wall {wall:.3f} ms/call, device busy "
          f"{busy:.3f} ms/call, idle share {out['idle_share']:.3f}, "
          f"{launches:.0f} kernels/call; top by device time:")
    for e in top:
        print(f"    {e.self_device_time_total / 1e3 / reps:9.4f} ms  "
              f"x{e.count / reps:5.0f}  {e.key[:90]}")
    groups = {"port kernels": 0.0, "library products": 0.0, "other": 0.0}
    for e in evs:
        key = ("port kernels" if any(n in e.key for n in PORT_KERNELS)
               else "library products"
               if any(n in e.key.lower()
                      for n in ("gemm", "nvjet", "cutlass", "xmma"))
               else "other")
        groups[key] += e.self_device_time_total / 1e3 / reps
    out["groups_ms"] = groups
    print("    device time by group: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in groups.items()))
    for name in PORT_KERNELS:
        mine = [e for e in evs if name in e.key]
        for e in mine:
            ms = e.self_device_time_total / 1e3 / reps
            print(f"    port kernel {ms:9.4f} ms  x{e.count / reps:5.0f}  "
                  f"{e.key[:70]}")
        if mine:
            ms = sum(e.self_device_time_total for e in mine) / 1e3 / reps
            out["port_kernels_ms"][name] = ms
            if len(mine) > 1:   # a kernel of several passes: their sum
                print(f"    port kernel {name}* passes together "
                      f"{ms:9.4f} ms")
    return out


def profile_engine(res, steps=8):
    """Where the time goes: one prefill at the longest prompt's prefill
    length (its bucket for dense, exact for the recurrent families) and
    ``steps`` batched decode steps at the last cache position, of the serve
    phase's engine (all slots live), after warm-up (:func:`_profile`)."""
    import torch
    eng = res["engine"]
    n = eng.pool.n_slots
    seq = max(_prefill_len(eng.cfg, r.prompt_len) for r in res["requests"])
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

    return {name: _profile(f"{eng.cfg.name} {name} (length {seq})", fn,
                           reps)
            for name, fn, reps in (("prefill", prefill, 1),
                                   ("decode", decode, steps))}


def phase_fault_transparency(arch, res):
    import torch
    from repro_torch.launch import serve as launch
    clean = launch.main(serve_args(arch) + ["--env", "none"])
    check(clean["summary"]["failures"] == 0, "the --env none run failed")
    diff = [r.rid for r in res["requests"]
            if res["engine"].output(r.rid) != clean["engine"].output(r.rid)]
    print(f"fault transparency {arch}: {len(res['requests']) - len(diff)}/"
          f"{len(res['requests'])} requests token-identical to the "
          f"failure-free run" + (f" (DIFFER: {diff})" if diff else ""))
    check(not diff, f"{arch}: failures changed the tokens of requests "
                    f"{diff}")
    del clean
    torch.cuda.empty_cache()


def phase_reference(res):
    """Engine tokens against the batch=1 reference.  The two paths differ
    in prompt padding (dense only: the recurrent families prefill at the
    exact length on both) and decode batch width, so the matrix products
    may round differently; a divergence is accepted only where the
    reference's logit gap between the two tokens is below BOUND = 4 * delta,
    delta the largest logit difference measured between the two paths'
    prefill (engine length vs exact) and first decode step (batch 4 vs
    batch 1) (2 for the two logits, 2 for growth over the decode steps)."""
    import torch
    from repro_torch.distributed.steps import (make_prefill_step,
                                               make_serve_step)
    from repro_torch.serve import greedy_decode
    from repro_torch.serve.snapshot import cache_batch_axes
    eng, cfg = res["engine"], res["engine"].cfg
    params, cache_len = eng.params, res["cache_len"]
    axes = cache_batch_axes(cfg, cache_len)
    pre = make_prefill_step(cfg, cache_len)
    serve = make_serve_step(cfg)
    n = eng.pool.n_slots
    delta = 0.0
    for r in res["requests"]:
        p = r.prompt_len
        toks = torch.zeros((1, _prefill_len(cfg, p)), dtype=torch.int32)
        toks[0, :p] = torch.as_tensor(r.prompt)
        lp, _ = pre(params, {"tokens": toks.cuda()},
                    torch.tensor([p - 1], device="cuda"))
        le, cache = pre(params, {"tokens": toks[:, :p].cuda()})
        delta = max(delta, float((lp - le).abs().max()))
        tok = torch.argmax(le, -1).to(torch.int32)[:, None]
        wide = {k: v.repeat_interleave(n, dim=axes[k])
                for k, v in cache.items()}
        _, l1, _ = serve(params, cache, tok, p)
        _, l4, _ = serve(params, wide, tok.expand(n, 1), p)
        delta = max(delta, float((l4 - l1).abs().max()))
        del cache, wide
    bound = 4 * delta
    print(f"reference parity {cfg.name}: measured path logit difference "
          f"delta {delta:.4g}, divergence bound 4*delta = {bound:.4g}")
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
    print(f"reference parity {cfg.name}: {exact}/{len(res['requests'])} "
          f"token-exact, largest divergence gap {worst:.4g} (bound "
          f"{bound:.4g})")
    return {"exact": exact, "delta": delta, "bound": bound, "worst_gap": worst}


def phase_family(arch):
    """Serve, profile, fault transparency and reference parity of one
    family; frees its engines before returning the launch counts."""
    import torch
    res, _, launches = phase_serve(arch)
    profile_engine(res)
    phase_fault_transparency(arch, res)
    phase_reference(res)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 6-7: olmo-1b training under the fault-tolerant coordinator
# ---------------------------------------------------------------------------

# full width and depth, global batch 4 x 2048; a checkpoint every 10 steps
# (the interval's floor), a host crash forced at step 6
TRAIN_ARGS = ["--arch", "olmo-1b", "--steps", "10", "--global-batch", "4",
              "--seq-len", "2048", "--seed", "0", "--device", "cuda",
              "--ckpt-gamma-s", "0.001"]
TRAIN_CRASH_STEP = 6
# the published widths at 2 layers; a trace that fires every train-side
# fault class: the crash at step 4 (capacity loss) replays from step 0, the
# corrupted step-10 checkpoint falls back to step 0, the forced save at
# step 12 hits ENOSPC and prunes step 0
CHAOS_LAYERS = 2
CHAOS_ARGS = ["--arch", "olmo-1b", "--steps", "14", "--global-batch", "4",
              "--seq-len", "512", "--seed", "0", "--device", "cuda",
              "--ckpt-gamma-s", "0.001", "--chaos-assert"]
CHAOS_EVENTS = [(1, "slowdown", (), 3, 0), (2, "nan_poison", (), 0, 0),
                (3, "net_partition", (0,), 2, 0),
                (4, "capacity_loss", (0,), 2, 0),
                (11, "ckpt_corrupt", (), 0, 7), (11, "host_crash", (), 2, 0),
                (12, "disk_full", (), 0, 0)]
PEAK_BF16 = PEAK_FLOPS_S["bfloat16"]


class SpanLog:
    """A recorder for the port's tracer that keeps every span."""

    def __init__(self):
        self.spans = []

    def record(self, rec):
        if rec["type"] == "span":
            self.spans.append(rec)

    def on_fault(self, kind, step=None):
        pass

    def on_recovery(self, kind):
        pass

    def seconds(self, name):
        return [sp["t1"] - sp["t0"] for sp in self.spans
                if sp["name"] == name]


def tree_digest(tree):
    """(leaf name, sha1 of its bytes) of every leaf."""
    from repro_torch.tree import flatten, leaf_name
    return [(leaf_name(path), hashlib.sha1(
        t.detach().cpu().numpy().tobytes()).hexdigest())
        for path, t in flatten(tree)]


def train_flops(cfg, b, s):
    """(model FLOPs, executed FLOPs) of one train step: 6 x the matmul
    parameters x tokens plus three times the causal attention's forward
    (2 products of 2 B H pairs D a layer); executed adds what remat
    recomputes (each layer's forward and each xent chunk's logits)."""
    d, hd = cfg.d_model, cfg.head_dim
    layer = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
             + 3 * d * cfg.d_ff)
    tokens = b * s
    attn = 4 * b * cfg.n_heads * (s * (s + 1) // 2) * hd
    model = (6 * tokens * (cfg.n_layers * layer + d * cfg.vocab_size)
             + 3 * cfg.n_layers * attn)
    recompute = (2 * tokens * (cfg.n_layers * layer + d * cfg.vocab_size)
                 + cfg.n_layers * attn)
    return model, model + recompute


def _launch_train(cfg, args, built):
    """The launcher's run, its SystemExit (a --chaos-assert failure) as a
    smoke failure."""
    from repro_torch.launch import train as launch
    try:
        return launch.run(cfg, args, built)
    except SystemExit as e:
        raise SmokeFailure(f"train launcher: {e}") from None


def phase_train(tmp):
    """olmo-1b at full width through the launcher's code path with a forced
    crash, then the same steps without faults; returns the path's launch
    counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.obs import Tracer
    from repro_torch.tree import flatten
    cfg = get_config("olmo-1b")
    parser = launch.build_parser()
    args = parser.parse_args(TRAIN_ARGS + [
        "--inject-mtbf-steps", "1e9", "--ckpt-dir", os.path.join(tmp, "run")])
    log = SpanLog()
    built = launch.build(cfg, args, tracer=Tracer(log))
    coord = built["coord"]
    coord.store.keep = 2
    built["injector"].fail_steps = {TRAIN_CRASH_STEP: 1}
    ckpt_bytes = sum(t.numel() * t.element_size() for _, t in flatten(
        {"params": coord.params, "opt": coord.opt_state}))
    counted = wrappers()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = _launch_train(cfg, args, built)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    rep = res["report"]
    print(f"train olmo-1b (crash at step {TRAIN_CRASH_STEP}): "
          f"{rep.steps_completed}/{args.steps} steps, failures "
          f"{rep.failures}, restores {rep.restores}, replayed "
          f"{rep.wasted_steps}, checkpoints {rep.checkpoints}, phase "
          f"{wall:.1f} s; launches {launches}")
    check(rep.steps_completed == args.steps, "the crash run did not finish")
    check(rep.restores == rep.failures == 1,
          f"restores {rep.restores}, failures {rep.failures}: want 1 each")
    check(all(np.isfinite(rep.losses)), "a non-finite loss")
    for name in ("flash_attention", "flash_attention_bwd"):
        check(launches[name] > 0, f"the train path never launched {name}")
    digest = tree_digest(coord.params)
    saves, restores = log.seconds("ckpt.save"), log.seconds("ckpt.restore")
    losses_run = list(rep.losses)
    del res, built, coord
    gc.collect()
    torch.cuda.empty_cache()

    # the same steps from the same init on the same batches, no faults
    ref_args = parser.parse_args(TRAIN_ARGS + [
        "--ckpt-dir", os.path.join(tmp, "ref")])
    ref = launch.build(cfg, ref_args)
    params, opt = ref["coord"].params, ref["coord"].opt_state
    step_fn, pipe = ref["step_fn"], ref["pipeline"]
    del ref
    times, losses = [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, pipe.batch_at(i))
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    same = tree_digest(params) == digest
    print(f"train olmo-1b: final params {'bit-identical' if same else 'DIFFER'}"
          f" to the fault-free run ({len(digest)} leaves, sha1 of each); "
          f"last {args.steps} losses of the crash run "
          f"{'equal' if losses_run[-args.steps:] == losses else 'DIFFER'}; "
          f"losses {[round(x, 4) for x in losses]}")
    check(same, "the crash run's final params differ from the fault-free "
                "run's")
    check(losses_run[-args.steps:] == losses,
          "the crash run's losses differ from the fault-free run's")
    step_s = statistics.median(times[1:])
    b, seq = args.global_batch, args.seq_len
    model, executed = train_flops(cfg, b, seq)
    print(f"train olmo-1b step: {1e3 * step_s:.1f} ms (median of "
          f"{len(times) - 1}, host clock, each step ends in a copy of its "
          f"loss), {b * seq / step_s:.0f} tokens/s, model "
          f"{model / 1e12:.2f} TFLOP a step ({executed / 1e12:.2f} executed "
          f"with remat), {model / step_s / 1e12:.1f} TFLOP/s, "
          f"{model / step_s / PEAK_BF16:.3f} of the bf16 peak")
    print(f"train olmo-1b checkpoints: {ckpt_bytes / 1e9:.2f} GB each "
          f"(params, mu, nu, step); saves "
          f"{[round(x, 2) for x in saves]} s, restores "
          f"{[round(x, 2) for x in restores]} s (host copy, np.save, sha1 "
          f"of every leaf; the restore reads, verifies, copies back)")
    batch = pipe.batch_at(args.steps)
    _profile("olmo-1b train step (4 x 2048)",
             lambda: float(step_fn(params, opt, batch)[2]["loss"]), 1)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_chaos(tmp):
    """Every train-side fault class at the published widths, 2 layers,
    through the launcher's code path and its --chaos-assert; returns the
    path's launch counts."""
    from repro_torch.chaos import TRAIN_KINDS, FaultEvent, FaultTrace
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=CHAOS_LAYERS)
    path = os.path.join(tmp, "chaos_trace.json")
    FaultTrace(events=[FaultEvent(step=st, kind=k, targets=t, duration=d,
                                  seed=sd)
                       for st, k, t, d, sd in CHAOS_EVENTS]).save(path)
    args = launch.build_parser().parse_args(CHAOS_ARGS + [
        "--chaos-trace", path, "--ckpt-dir", os.path.join(tmp, "chaos")])
    counted = wrappers()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = _launch_train(cfg, args, launch.build(cfg, args))
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    rep, chaos = res["report"], res["chaos"]
    print(f"train chaos olmo-1b x {CHAOS_LAYERS} layers: applied "
          f"{dict(chaos.applied_by_kind)}; failures {rep.failures}, restores "
          f"{rep.restores}, ckpt fallbacks {rep.ckpt_fallbacks}, nan "
          f"rollbacks {rep.nan_rollbacks}, enospc retries "
          f"{rep.enospc_retries}, partitions {rep.partitions}, slowdowns "
          f"{rep.slowdowns}, index violations {rep.index_violations}; phase "
          f"{wall:.1f} s; launches {launches}")
    check(set(chaos.applied_by_kind) == set(TRAIN_KINDS),
          f"the trace fired {sorted(chaos.applied_by_kind)}, not every "
          f"train-side class")
    check(rep.ckpt_fallbacks >= 1 and rep.enospc_retries >= 1
          and rep.nan_rollbacks == 1 and rep.partitions == 1
          and rep.slowdowns == 1 and rep.failures == 2,
          "a fault class's recovery path did not run")
    for name in ("flash_attention", "flash_attention_bwd"):
        check(launches[name] > 0, f"the chaos train path never launched "
                                  f"{name}")
    return launches


KERNEL_SOURCES = {
    "pairwise_distance": ("src/repro_torch/kernels/csrc/pairwise_distance.cu",
                          "src/repro/kernels/pairwise_affinity/kernel.py:22"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:24"),
    # B2's gradient: the Pallas kernel is forward-only and JAX differentiates
    # its jnp attention (src/repro/models/layers.py:122)
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/kernel.py:24"),
    "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu",
             "src/repro/kernels/rwkv6_scan/kernel.py:27"),
    "lru_scan": ("src/repro_torch/kernels/csrc/lru_scan.cu",
                 "src/repro/kernels/rglru_scan/kernel.py:20"),
}
TIMED_KEYS = ("shape", "max_abs_err", "ms", "device_ms", "plain_ms",
              "bound_ms", "bound_by", "bound_share", "library_ms",
              "library_device_ms")


def kernel_records(recs, by_path):
    """One JSON record per kernel: its main-path timing, its launches summed
    over the planner, serve and train paths and per path.
    flash_attention's record is olmo's causal bf16 prefill (tensor cores);
    its windowed (recurrentgemma) case, its fp32 (SIMT) instance at olmo's
    shape and its case at olmo-1b's training shape ride along, as do
    pairwise_distance's (4096, 10) case and its planner case (montage's
    700-task projection).  flash_attention_bwd's record is olmo-1b's
    training shape."""
    out = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        paths = {arch: counts[name] for arch, counts in by_path.items()
                 if counts[name]}
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": sum(paths.values()),
               "launches_by_path": paths,
               **{k: recs[name][k] for k in TIMED_KEYS}}
        if name == "flash_attention":
            win = recs[name + "_window"]
            rec["window_case"] = {"window": win["window"],
                                  **{k: win[k] for k in TIMED_KEYS}}
            rec["fp32_case"] = {k: recs[name + "_fp32"][k]
                                for k in TIMED_KEYS}
            rec["train_case"] = {k: recs[name + "_train"][k]
                                 for k in TIMED_KEYS}
        if name == "pairwise_distance":
            rec["large_case"] = {k: recs[name + "_large"][k]
                                 for k in TIMED_KEYS}
            rec["planner_case"] = {k: recs[name + "_planner"][k]
                                   for k in TIMED_KEYS}
        out.append(rec)
    return out


def main() -> int:
    # the train phases replay steps bit for bit: cuBLAS reads this at its
    # first use in the process, so it is set before any phase runs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    phase_build_report(_build)
    phase_sass(_build)

    # 3. kernels
    print("kernels against their plain versions on the card:")
    recs = phase_kernels()
    print(f"kernel phase done at {time.perf_counter() - t_start:.1f} s")
    # 4. the CRCH workflow planner
    by_path = {}
    by_path["planner"], recs["pairwise_distance_planner"] = phase_planner()
    print(f"planner done at {time.perf_counter() - t_start:.1f} s")
    # 5. each family: serve, profile, fault transparency, reference parity
    for arch in FAMILIES:
        by_path[arch] = phase_family(arch)
        print(f"{arch} done at {time.perf_counter() - t_start:.1f} s")
    # 6-7. olmo-1b training: full width with a crash, then every fault class
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    torch.use_deterministic_algorithms(True)
    try:
        by_path["train"] = phase_train(tmp)
        print(f"train done at {time.perf_counter() - t_start:.1f} s")
        by_path["train_chaos"] = phase_train_chaos(tmp)
        print(f"train chaos done at {time.perf_counter() - t_start:.1f} s")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = kernel_records(recs, by_path)
    for k in kernels:
        lib = (f"{k['library_ms']:.4f}" if k["library_ms"] is not None
               else "none")
        print(f"kernel {k['name']}: launches={k['launches']} "
              f"{k['launches_by_path']} ms={k['ms']:.4f} "
              f"device_ms={k['device_ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} library_ms={lib} "
              f"bound_ms={k['bound_ms']:.5f} ({k['bound_by']}, share "
              f"{k['bound_share']:.3f}) "
              f"max_abs_err={k['max_abs_err']:.3g} at {k['shape']}")
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
