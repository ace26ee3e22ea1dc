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
   softmax-scale mutant of the backward failing the limit; B2 at the
   decoder-only families' shapes before any of them runs: the forward at
   each one's largest prefill bucket (GQA groups 2 at D = 64, and 4, 7, 48
   and 12), timed beside SDPA, and the backward at granite-moe-1b's
   training shape (timed) and at groups 7, 12 and 48 (the MQA one timed),
   and bf16 forward and backward at deepseek-coder-33b's, granite-20b's and
   command-r-plus-104b's training shapes (4 x 2048 tokens, groups 7, 48 and
   12; ``decoder_train_shapes``), timed beside SDPA's, with the kernel's
   device time over SDPA's;
   B2 at whisper-small's and llava-next's shapes (``multimodal_shapes``):
   the forward at the encoder's 1500 frames (bidirectional), at the
   cross-attention of the largest prompt bucket to them (Sq != Sk, a
   ragged last key tile) and at llava's 576 image rows + its largest
   bucket (causal), the backward at their training shapes, each timed
   beside SDPA, and the backward at cross and bidirectional cases with Sq
   and Sk apart (``FA_BWD_CROSS_CASES``) in fp32 and bf16;
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
   recurrentgemma-2b, granite-moe-1b-a400m, deepseek-coder-33b,
   granite-20b, phi3.5-moe-42b-a6.6b, command-r-plus-104b, whisper-small
   with 1500 frame embeddings a request, llava-next-mistral-7b with 576
   image embeddings before each prompt), at full width
   (random seeded weights drawn a layer at a time straight into bf16;
   :data:`SERVE_LAYERS` cuts the depth of all but olmo-1b and
   whisper-small) with its peak
   device memory:

   a. serve: the port's launcher with CRCH replication under the
      ``unstable`` failure environment; every request must complete,
      failures must have been recovered from snapshots, and every kernel of
      the family's path must have been launched (all launch counts are
      zeroed just before this phase and read just after); prints what a
      decode snapshot of one slot row costs (bytes, host copy, hash).
      olmo-1b's run is traced (``--trace-dir``, ``--trace-dump-on-fault``
      through ``launch.serve.make_obs``) and the port's validator must find
      ``serve.worker_failure``, ``serve.resume`` and ``recover.host_crash``
      in its dumps;
   b. profile: one prefill and a few batched decode steps of that engine
      under ``torch.profiler``;
   c. fault transparency: the same requests with no failures give the same
      tokens, token for token (paper: checkpointed resubmission does not
      change the output);
   d. reference parity: engine tokens against the batch=1 greedy reference;
      where they part, the reference's logit gap between the two tokens must
      be below a bound derived from measured logit differences.  The MoE
      families count each request's pairs dropped for capacity in both
      runs (the engine prefills a bucket, the reference the exact length,
      and the capacity follows the length); a request with drops that
      diverges is printed as a capacity divergence, the rule holds on the
      others.

   Each family's engines are freed before the next family starts.

6. train: olmo-1b at full width and depth (16 layers, d_model 2048, fp32
   params, bf16 compute, global batch 4 x 2048 tokens, deterministic
   kernels) through the train launcher's code path under the training
   coordinator, with one host crash forced through the failure injector:
   every step completes, restores == failures > 0, all losses finite, both
   flash kernels launched, and the final params bit-identical (a sha1 of
   every leaf) to a fault-free run of the same steps from the same init on
   the same batches; prints step time, tokens/s, model FLOPs a step (the
   script's own count against ``analysis.flops.cell_flops``, which must
   agree within 5% executed and 10% model), ``capture_cost``'s FLOPs and
   bytes of one step outside the timed steps (aten ops and the kernels'
   own reports; within 0.35 of ``cell_flops``), checkpoint save/restore
   seconds and bytes, and a ``torch.profiler`` view of one step;
7. train chaos: the launcher's code path at the published widths with 2
   layers, replaying a fault trace that fires every train-side fault class
   (host_crash, slowdown, capacity_loss, ckpt_corrupt, nan_poison,
   net_partition, disk_full), plus two crashes stacked on one step
   (escalating backoff), under the launcher's ``--chaos-assert``, traced:
   the validator must find every witness of those classes
   (:data:`CHAOS_SPANS`), and ``profile.json`` must count every train-step
   call but the first; its store and dumps are kept in host memory
   (:func:`shm_dir`);
   b. the cross-pod cluster: ``--pods 3`` at the published widths with 2
   layers, 4 x 512 tokens, 10 steps, pod 0 partitioned at round 2 for 3
   rounds and an ENOSPC strike at round 7, traced, under
   ``--chaos-assert`` (all pods bit-identical to a fault-free reference
   cluster, no split-brain); partition, heal, catch-up, parking and ENOSPC
   counts, compression 4.0x, both flash kernels launched, the validator's
   witnesses; one more round's split through the calls a round makes (the
   pods' gradients, ``PodGradientExchange.round`` without and with the
   update's fingerprint, the AdamW updates, the pods' fingerprints) by CUDA
   events and the host clock, and each commit's seconds and bytes (both
   clusters' stores and the dumps in host memory, :func:`shm_dir`);
   c. one exchange round at full width: olmo-1b whole, the gradients of
   three 4 x 2048 batches as three identical pods and as three that
   differ; each average within its int8 bound of the fp32 mean, int8
   bytes a quarter of fp32's; each part's ms and ``tree_digest``'s GB/s;
8. train rwkv6-3b, recurrentgemma-2b, llava-next-mistral-7b (4 x (576 +
   1472) positions), deepseek-coder-33b, granite-20b and
   phi3.5-moe-42b-a6.6b (4 x 2048 tokens) at their published widths and a
   cut depth (``FAMILY_TRAIN``: the largest whose peak device memory stays
   under ~70 GB; recurrentgemma at 3k + 2 layers), granite-moe-1b-a400m
   whole (its and phi3.5-moe's logged loss must be xent + 0.01 x the MoE
   aux loss, aux > 0; each also prints one MoE layer's device time) and
   whisper-small whole (12 + 12 layers, 16 x 448 tokens, 1500 frames a
   sample), through the launcher's
   ``build`` and its train step, deterministic: step time, tokens/s, model
   FLOPs and their share of the bf16 peak, peak memory, a profiled step,
   and every kernel of the family's path launched (B3 forward and
   backward; B4 forward and backward and B2 forward and backward at
   D = 256; B2 forward and backward);
9. a crash run of each but llava at reduced depth (rwkv6 2 layers,
   recurrentgemma 3, granite-moe 2, whisper 2 + 2 at 448 tokens;
   ``CRASH_CUTS``: a llava, deepseek-coder, granite-20b or phi3.5-moe
   checkpoint would not fit the disk), 4 x 512 tokens, through the
   launcher's code path with a forced crash: final params bit-identical to
   a fault-free run (sha1 of every leaf), restores == failures > 0;
   b. command-r-plus-104b's gradient at its published widths and one layer
   (the parallel block, the tied 256000 x 12288 embedding): fp32 params
   drawn on the card, bf16 compute, 4 x 2048 tokens, two calls of
   ``distributed.steps.make_grad_fn``; the loss and every gradient leaf
   finite, every leaf nonzero, both flash kernels launched; the call's
   ms and peak memory, and why no AdamW step follows (``GRAD_SPEC``);
   c. the model-level reference: every family of ``configs.all_configs()``
   at its published widths and the smallest depth that holds each of its
   layer kinds (one layer; recurrentgemma two recurrent and one attention
   layer; whisper one encoder and one decoder layer), fp32 params and
   compute, weights drawn on the card from a seed and copied to the host,
   one seeded row of 256 tokens (llava with its 576 image rows, whisper
   with 1500 frames): ``lm.prefill``'s logits (atol = rtol = 2e-4),
   ``make_grad_fn``'s loss (2e-4 relative) and every gradient leaf (1e-3
   relative in the 2-norm, a leaf at a time; whisper's four leaves whose
   gradient is 0 in exact arithmetic to 1e-7 of the whole gradient's norm)
   on the card (B2's fp32
   forward and SIMT backward, B3, B4) against the same functions on the
   CPU (the plain versions); the MoE families' routing first, token by
   token (a difference is a near-tie only where the CPU's gate gap is at
   most 1e-5, and then only the logits of the last token whose routing
   agreed are held); each family's errors, leaf and seconds, and the
   host's memory.
10. mesh: the sharding layer (``distributed.sharding``/``params``) on a
   one-rank CUDA ``DeviceMesh`` (``--mesh debug``): olmo-1b at full width
   and depth, 3 steps of 4 x 2048 tokens in two microbatches, without a
   mesh and with DTensor params, AdamW state and gradient sum from the
   same seed: the losses and final params must be bit-identical and the
   mesh run must launch both flash kernels; olmo-1b served (8 requests,
   2 x 2 slots, CRCH, ``unstable``) without and with the mesh: the same
   tokens, the mesh's cache still at ``cache_specs``' placements, tok/s
   and decode ms/step of both; then two dry-run cells
   (``launch.dryrun``: olmo-1b x train_4k and granite-moe-1b x
   prefill_32k on the 256-rank fake mesh) printed as JSON rows.

Phase 3 also holds the backward kernels of phases 8-9 against their plain
versions: B3's at rwkv6's training shape (4, 40, 2048, 64) and its chunk
edges, and at both ends of log_w's clamp at T = 3000, against the
sequential and chunked plain backwards in fp64; B4's at (2, 4096, 2560)
and its chunk edges; B2's at D = 256, (2, 10, 1, 4096, 256) window 2048 in
bf16 (the tensor cores: a dQ, a dV and a dK pass) and fp32 (SIMT), timed
beside SDPA's masked backward, both tiles' edges (64 and 32 rows) and
windows, and a x1.1 softmax-scale mutant failing the limit; each with a
bit-identical repeat.  Each timed backward also prints the device time of
each of its kernels (B3's: the fold and the chunk gradients).

Every training phase prints the bytes it wrote, measured
(:class:`WriteLedger`), and the running total on disk, which may not pass
:data:`DISK_GATE`, under the machine's allowance (:data:`DISK_ALLOWANCE`).
A phase's directories under ``/dev/shm`` are removed when it ends and on
any exit of the script (SIGTERM included).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import signal
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

# the decoder-only families besides olmo-1b (NEW_DECODERS): B2 forward at
# each one's largest prompt bucket (decoder_prefill_shapes), the backward at
# granite-moe-1b-a400m's training shape (4 x 2048 tokens, 16 query heads of
# 64 on 8 KV heads) and at the new GQA groups 7 (deepseek-coder-33b, 56:8),
# 12 (command-r-plus-104b, 96:8) and 48 (granite-20b's MQA, 48:1) with
# every query head of the family, at a short S
FA_BWD_MOE_MAIN = (4, 16, 8, 2048, 64)
FA_BWD_GROUP_CASES = [(1, 56, 8, 256, 128), (1, 96, 8, 256, 128),
                      (1, 48, 1, 512, 128)]

# B2 on the encoder-decoder's and the image family's paths: whisper-small's
# cross-attention (its 1500 frames are off the 64-key grid: a ragged last
# key tile) and bidirectional encoder, llava-next's causal attention over
# 576 image rows and the text (multimodal_shapes); the backward also at the
# card tests' (B, H, KV, Sq, Sk, D, causal) cases with Sq and Sk apart
FA_BWD_CROSS_CASES = [(1, 12, 12, 77, 1500, 64, False),
                      (2, 12, 12, 448, 1500, 64, False),
                      (1, 12, 12, 1500, 1500, 64, False),
                      (1, 4, 2, 130, 77, 128, False),
                      (2, 4, 4, 65, 200, 64, False),
                      (1, 8, 2, 1, 129, 128, False),
                      (1, 32, 8, 576 + 200, 576 + 200, 128, True)]

# the flash-attention backward at D = 256 (bf16 on the tensor cores in
# 64-row tiles, a dQ, a dV and a dK pass; fp32 on the SIMT kernels in 32-row
# tiles): recurrentgemma's training shape, global batch 2 x 4096 tokens, 10
# query heads of 256 on one KV head, window 2048; both tiles' edges (at
# window 16) and windows
FA_BWD_256_MAIN = (2, 10, 1, 4096, 256)
FA_BWD_256_WINDOW = 2048
FA_BWD_256_EDGE_S = (1, 31, 32, 33, 63, 64, 65, 127, 128, 129)
FA_BWD_256_CASES = [(1, 10, 1, 127, 256, True, 37),
                    (1, 10, 1, 700, 256, True, 200),
                    (1, 10, 1, 2100, 256, True, 2048),
                    (1, 4, 2, 129, 256, False, 0)]
# B3's backward: rwkv6-3b's training shape (4 x 2048 tokens, 40 heads of
# 64), then its 16-token chunks' edges and a long T at 40 heads.  Each
# gradient against the plain backwards (sequential and chunked) in fp64 on
# the same rounded inputs, normalised by max(1, its largest magnitude): the
# state's gradient grows with T where decays are near 1.  dr, dk, dv in
# r's dtype at the forward's limits; dlog_w, du and dS0 fp32
WKV_BWD_MAIN = (4, 40, 2048, 64)
WKV_BWD_EDGE_T = (1, 15, 17, 33, 370)
# B4's backward: recurrentgemma-2b's training shape, then the 128-step
# chunks' edges; fp32 on both sides, normalised as above
LRU_BWD_MAIN = (2, 4096, 2560)
LRU_BWD_EDGES = [(1, 1, 2560), (2, 57, 300), (2, 129, 130), (1, 3055, 2560)]

# the families served, each with its prompt length and the kernels its
# serve path must launch
DECODER = (384, ("pairwise_distance", "flash_attention"))
FAMILIES = {
    "olmo-1b": DECODER,
    "rwkv6-3b": (384, ("pairwise_distance", "wkv6")),
    # prompts draw from 1536..3072 tokens: most exceed the 2048 window
    "recurrentgemma-2b": (3072, ("pairwise_distance", "flash_attention",
                                 "lru_scan")),
    "granite-moe-1b-a400m": DECODER,
    "deepseek-coder-33b": DECODER,
    "granite-20b": DECODER,
    "phi3.5-moe-42b-a6.6b": DECODER,
    "command-r-plus-104b": DECODER,
    # Whisper's prompt limit: half of its 448-token text context; each
    # request also carries 1500 frame embeddings
    "whisper-small": (224, ("pairwise_distance", "flash_attention")),
    # 576 image embeddings a request, before the prompt
    "llava-next-mistral-7b": DECODER,
}
#: serve depth cuts (the published widths are kept): bf16 weights of
#: phi3.5-moe (83.7 GB) and command-r-plus (207.6 GB) do not fit one 80 GB
#: card; deepseek-coder-33b and granite-20b fit whole (66.7 and 56.3 GB,
#: peaks 71.0 and 60.7 GB).  The rest is the time limit: the serve phases
#: are mostly host-bound decoding, whose time follows the depth (at 16,
#: 13, 24 and 18 layers deepseek-coder, granite-20b, phi3.5-moe and
#: command-r-plus took 29, 26, 68 and 33 s on one H100).  For the
#: cross-pod cluster's phase (~170 s) rwkv6-3b, recurrentgemma-2b (2 super
#: blocks and its 2 tail layers), granite-moe-1b and llava-next went to
#: about a quarter of their depth; for the three trained families, the
#: gradient phase and the model-level reference (~85 s, every layer kind
#: of every family at its published widths) deepseek-coder, granite-20b,
#: phi3.5-moe, command-r-plus, rwkv6-3b and llava-next serve 4 layers and
#: granite-moe-1b 3 (their phases 19.1 -> 11.0, 16.5 -> 9.6, 34.8 ->
#: 12.7, 24.1 -> 12.5, 18.8 -> 9.7, 21.7 -> 12.1 and 17.4 -> 8.0 s:
#: chip_serve_depths.py on one H100).  recurrentgemma-2b keeps 8: at 5
#: layers the reference parity's measured logit difference was 0, so its
#: divergence bound was 0, and one request's tokens parted from the
#: reference's at decode step 41 by a 0.0156 logit gap (ROADMAP, Queue C,
#: check 2).  olmo-1b and whisper-small serve whole
SERVE_LAYERS = {"phi3.5-moe-42b-a6.6b": 4, "command-r-plus-104b": 4,
                "deepseek-coder-33b": 4, "granite-20b": 4, "rwkv6-3b": 4,
                "recurrentgemma-2b": 8, "granite-moe-1b-a400m": 3,
                "llava-next-mistral-7b": 4}


def serve_args(arch):
    return ["--arch", arch, "--requests", "8", "--prompt-len",
            str(FAMILIES[arch][0]), "--new-tokens", "32", "--workers", "2",
            "--slots-per-worker", "2", "--policy", "crch", "--seed", "0",
            "--device", "cuda"]


def serve_config(arch):
    """``arch``'s published config, cut to :data:`SERVE_LAYERS`."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in SERVE_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS[arch])
    return cfg


def serve_run(arch, env, params=None, trace_dir=None):
    """The serve launcher on ``arch`` under ``env``: its ``main`` for an
    uncut family with its own seeded weights, else the same code path
    (``continuous_main``) on the cut config or with ``params``.
    ``trace_dir``: the launcher's ``--trace-dir`` (through
    ``launch.serve.make_obs``) with ``--trace-dump-on-fault``."""
    from repro_torch.launch import serve as launch
    argv = serve_args(arch) + ["--env", env]
    if trace_dir:
        argv += ["--trace-dir", trace_dir, "--trace-dump-on-fault"]
    if arch not in SERVE_LAYERS and params is None:
        return launch.main(argv)
    return launch.continuous_main(
        serve_config(arch), launch.build_parser().parse_args(argv),
        params=params)

# the serve run traced through ``launch.serve.make_obs``, and the witnesses
# its dumps must hold (it must recover failures from snapshots)
TRACED_SERVE = "olmo-1b"
SERVE_SPANS = ("serve.worker_failure", "serve.resume", "recover.host_crash")

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


def validate_trace(trace_dir, spans, label):
    """The port's validator (``python -m repro_torch.obs.validate``'s
    ``main``) over a run's dumps, with ``--require-span`` on each
    witness."""
    from repro_torch.obs import validate
    print(f"{label} trace: ", end="", flush=True)
    argv = [trace_dir] + [a for sp in spans for a in ("--require-span", sp)]
    check(validate.main(argv) == 0,
          f"{label}: the validator refused the dumps under {trace_dir}")


#: disk writes the chip machine allows (45 GiB); the script stops at
#: DISK_GATE, leaving ~4 GB for what a phase writes before its check
DISK_ALLOWANCE = 45 * 2 ** 30
DISK_GATE = 44e9
#: host memory left free beside what a phase keeps under /dev/shm
SHM_SPARE = 16e9
_SHM_DIRS: list[str] = []


def written_bytes():
    """The bytes this process has written so far, its threads' writes
    included: ``wchar`` of ``/proc/self/io`` (every write call, to any
    file system or pipe)."""
    with open("/proc/self/io") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key.strip() == "wchar":
                return int(value)
    raise SmokeFailure("/proc/self/io has no wchar line")


class WriteLedger:
    """The bytes each training phase writes, measured around it
    (:func:`written_bytes`, its prints included), and the running totals.
    A phase counted ``where="shm"`` keeps every file it writes in its own
    directories under ``/dev/shm`` (:func:`shm_dir`); every other phase's
    writes count to the disk, whose total may not pass
    :data:`DISK_GATE`."""

    def __init__(self):
        self.totals = {"disk": 0, "shm": 0}

    @contextlib.contextmanager
    def phase(self, name, where="disk"):
        start = written_bytes()
        yield
        n = written_bytes() - start
        self.totals[where] += n
        print(f"writes {name}: {n / 1e9:.2f} GB to {where}; disk total "
              f"{self.totals['disk'] / 1e9:.2f} GB (gate "
              f"{DISK_GATE / 1e9:.2f}, allowance {DISK_ALLOWANCE / 1e9:.2f}),"
              f" /dev/shm total {self.totals['shm'] / 1e9:.2f} GB")
        check(self.totals["disk"] <= DISK_GATE,
              f"the disk writes passed {DISK_GATE / 1e9:.2f} GB at {name}")


def _meminfo(key):
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise SmokeFailure(f"/proc/meminfo has no {key} line")


def shm_dir(label, need):
    """A new private directory under ``/dev/shm`` (host memory, not the
    disk) for a phase that keeps up to ``need`` bytes there at once.
    Refuses (no fallback to the disk, whose allowance the phase would
    pass) unless the host has ``need`` + :data:`SHM_SPARE` bytes of memory
    available.  :func:`release_shm` removes it."""
    avail = _meminfo("MemAvailable")
    print(f"{label}: up to {need / 1e9:.2f} GB in /dev/shm; host memory "
          f"available {avail / 1e9:.2f} GB, /dev/shm holds "
          f"{_meminfo('Shmem') / 1e9:.2f} GB")
    check(os.path.isdir("/dev/shm") and avail >= need + SHM_SPARE,
          f"{label} needs {(need + SHM_SPARE) / 1e9:.2f} GB of host memory "
          f"for /dev/shm; {avail / 1e9:.2f} GB available")
    path = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_", dir="/dev/shm")
    _SHM_DIRS.append(path)
    return path


def release_shm(path=None):
    """Remove ``path`` (default: every directory :func:`shm_dir` made)."""
    for p in [path] if path is not None else list(_SHM_DIRS):
        shutil.rmtree(p, ignore_errors=True)
        if p in _SHM_DIRS:
            _SHM_DIRS.remove(p)


def tree_bytes(tree):
    from repro_torch.tree import flatten
    return sum(t.numel() * t.element_size() for _, t in flatten(tree))


def wrappers():
    """Kernel name -> its wrapper, which carries the launch count."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.pairwise_affinity import ops as pa_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rwkv6_scan import ops as wk_ops
    return {"pairwise_distance": pa_ops.pairwise_distance,
            "flash_attention": fa_ops.flash_attention,
            "flash_attention_bwd": fa_ops.flash_attention_bwd,
            "wkv6": wk_ops.wkv6, "wkv6_bwd": wk_ops.wkv6_bwd,
            "lru_scan": lru_ops.lru_scan,
            "lru_scan_bwd": lru_ops.lru_scan_bwd}


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


def time_plain(fn):
    """A plain version's time: :func:`time_ms`, but the median of 3 calls
    when one call takes over 50 ms (the sequential WKV6 forward and
    backward at thousands of tokens); the first call warms up."""
    import torch
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 0.05:
        return time_ms(fn, iters=3, warmup=0)
    return time_ms(fn)


def time_kernel(rec, fn, prefix=""):
    """A call's time with the host's submission (``ms``) and the device's
    alone (``device_ms``), under ``prefix`` (``library_`` for the library
    call)."""
    rec[prefix + "ms"] = time_ms(fn)
    rec[prefix + "device_ms"] = time_ms(fn, queued=True)


def kernel_device_ms(fn, reps=10):
    """{kernel name: device ms a call of ``fn``} of the kernels ``fn``
    launches (all launches of one name in a call summed), from
    ``torch.profiler`` over ``reps`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0][:60]
            out[name] = out.get(name, 0.0) + e.device_time_total / reps / 1e3
    return out


def launch_cost(fn):
    """(bytes, FLOPs) of the one kernel launch ``fn`` makes, as its wrapper
    reports them (``kernels/_cost.py``; what ``capture_cost`` counts):
    each input read once, each output written once, and the operations
    these inputs need."""
    from repro_torch.kernels import _cost
    with _cost.capture() as sink:
        fn()
    check(len(sink) == 1 and next(iter(sink.values()))["launches"] == 1,
          f"one kernel launch expected, the wrappers reported {sink}")
    rec = next(iter(sink.values()))
    return rec["bytes"], rec["flops"]


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
    # D = 256: the dQ pass and the dkdv kernel's dV (1) and dK (2) parts
    for want in ("flash_bwd_dq_tcILi256E", "flash_bwd_dkdv_tcILi256ELi1E",
                 "flash_bwd_dkdv_tcILi256ELi2E"):
        check(any(want in fn for fn in tc),
              f"no {want} kernel in the backward's SASS")
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
        rec["plain_ms"] = time_plain(lambda: ref.pairwise_distance(x))
        time_kernel(rec, lambda: torch.cdist(
            x, x, compute_mode="use_mm_for_euclid_dist"), "library_")
        add_bound(rec, *launch_cost(lambda: ops.pairwise_distance(x)),
                  "float32")
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


def _mode(s, sk, causal, window):
    return (f"window {window}" if window else "causal" if causal else
            "bidir" if sk == s else f"cross (Sk {sk})")


def flash_case(b, h, kv, s, d, dtype_name, causal, *, timed, window=0,
               sk=None):
    """The forward kernel at q (b, h, s, d) and k, v (b, kv, sk, d) (sk = s
    by default) against its plain version; timed beside SDPA."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    sk = s if sk is None else sk
    dt = getattr(torch, dtype_name)
    rng = np.random.default_rng(b * 7 + h * 5 + s + d + window)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to("cuda", dt)
               for shape in ((b, h, s, d), (b, kv, sk, d), (b, kv, sk, d)))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.attention(q, k, v, causal=causal, window=window)
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), **FA_TOL[dtype_name]))
    rec = {"shape": [b, h, kv, s, d], "dtype": dtype_name, "causal": causal,
           "window": window, "max_abs_err": err, "ok": ok}
    if sk != s:
        rec["sk"] = sk
    wide = (flash_wide_grid_check(q, k, v, got, causal, window)
            if dtype_name == "bfloat16" and d <= 128 else 0)
    if timed:
        time_kernel(rec, lambda: ops.flash_attention(
            q, k, v, causal=causal, window=window))
        rec["plain_ms"] = time_plain(lambda: ref.attention(
            q, k, v, causal=causal, window=window))
        gqa = {"enable_gqa": True} if h != kv else {}
        if window:
            diff = (torch.arange(s, device="cuda")[:, None]
                    - torch.arange(s, device="cuda")[None, :])
            mask = (diff >= 0) & (diff < window)
            time_kernel(rec, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, **gqa), "library_")
        else:
            time_kernel(rec, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, **gqa), "library_")
        add_bound(rec, *launch_cost(lambda: ops.flash_attention(
            q, k, v, causal=causal, window=window)), dtype_name)
    tol = FA_TOL[dtype_name]
    mode = _mode(s, sk, causal, window)
    print(f"  flash_attention {(b, h, kv, s, d)} {dtype_name} {mode}: "
          f"max_abs_err {err:.3g} (atol {tol['atol']} rtol {tol['rtol']}) "
          f"{'ok' if ok else 'FAIL'}"
          + (f", same bits at {wide} blocks of 128 rows" if wide else "")
          + (_timing_text(rec, "sdpa") if timed else ""))
    check(ok, f"flash_attention {(b, h, kv, s, d)} {dtype_name} "
              f"{mode} disagrees with its plain version")
    return rec


def _bwd_inputs(b, h, kv, s, d, dtype_name, window, sk=None):
    """q, k, v, dO as the model hands them to the kernels: (B, H, S, D)
    views of (B, S, H, D) tensors (k and v at sk keys, s by default)."""
    import numpy as np
    import torch
    sk = s if sk is None else sk
    rng = np.random.default_rng(b * 7 + h * 5 + s + d + window + 1)
    return [torch.from_numpy(rng.normal(size=(b, n_s, n, d)).astype(
        np.float32)).to("cuda", getattr(torch, dtype_name)).transpose(1, 2)
        for n, n_s in ((h, s), (kv, sk), (kv, sk), (h, s))]


def _normed_check(got, want, tols):
    """(max abs error, max error over each gradient's max(1, |max|) scale,
    within the limits) of gradients against their plain versions; ``tols``
    gives each gradient's limit (a None in ``want`` must be None in
    ``got``)."""
    import torch
    err = nerr = 0.0
    ok = True
    for g, w, tol in zip(got, want, tols):
        if w is None:
            ok = ok and g is None
            continue
        scale = max(1.0, float(w.abs().max()))
        e = _max_err(g.double(), w.double())
        err, nerr = max(err, e), max(nerr, e / scale)
        ok = ok and bool(torch.allclose(g.double() / scale,
                                        w.double() / scale, **tol))
    return err, nerr, ok


def _bwd_check(got, want, dtype_name):
    """(max abs error, max error over the gradient's scale, within the
    limit) of the three gradients."""
    return _normed_check(got, want, [FA_BWD_TOL[dtype_name]] * 3)


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


def flash_bwd_case(b, h, kv, s, d, dtype_name, causal, *, timed, window=0,
                   sk=None):
    """The backward kernel against the plain backward in fp32 on the same
    inputs, beside SDPA's backward against the same reference; the
    forward's lse against its plain version and the forward's bits with and
    without it; a repeat call's bits.  k and v hold sk keys (s by
    default)."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    sk = s if sk is None else sk
    q, k, v, do = _bwd_inputs(b, h, kv, s, d, dtype_name, window, sk)
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
    if sk != s:
        rec["sk"] = sk
    if timed:
        time_kernel(rec, lambda: ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                         **kw))
        rec["plain_ms"] = time_plain(lambda: ref.attention_backward(
            q, k, v, o, lse, do, **kw))
        # SDPA's backward, as a yardstick only
        leaves, out = _sdpa_graph(q, k, v, causal, window)
        time_kernel(rec, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), "library_")
        add_bound(rec, *launch_cost(lambda: ops.flash_attention_bwd(
            q, k, v, o, lse, do, **kw)), dtype_name)
        rec["passes_device_ms"] = kernel_device_ms(
            lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, **kw))
    tol = FA_BWD_TOL[dtype_name]
    mode = _mode(s, sk, causal, window)
    print(f"  flash_attention_bwd {(b, h, kv, s, d)} {dtype_name} {mode}: "
          f"max_abs_err {err:.3g}, over the gradient's scale {nerr:.3g} "
          f"(atol {tol['atol']} rtol {tol['rtol']} of max(1, |grad|max); "
          f"SDPA's backward {sdpa_nerr:.3g}); "
          f"lse err {lse_err:.3g} (2e-4); forward bits "
          f"{'unchanged' if same_fwd else 'CHANGED'} with lse; repeat "
          f"{'same bits' if same else 'DIFFERS'} "
          f"{'ok' if rec['ok'] else 'FAIL'}"
          + (_timing_text(rec, "sdpa backward") if timed else ""))
    for name, ms in rec.get("passes_device_ms", {}).items():
        print(f"    flash_attention_bwd pass {name}: {ms:.4f} ms of device "
              f"time a call")
    check(ok, f"flash_attention_bwd {(b, h, kv, s, d)} {dtype_name} {mode} "
              f"disagrees with its plain version")
    check(lse_ok, f"flash_attention lse {(b, h, kv, s, d)} {dtype_name} "
                  f"disagrees with its plain version")
    check(same_fwd, f"flash_attention {(b, h, kv, s, d)}: writing the lse "
                    f"changed the output's bits")
    check(same, f"flash_attention_bwd {(b, h, kv, s, d)}: a repeat call "
                f"changed the bits")
    return rec


def attended_pairs(s, causal, window, sk=None):
    """(query, key) pairs a head attends at s queries (and sk keys, s by
    default; causal only at sk = s): the kernels' own count."""
    from repro_torch.kernels._cost import attended_pairs as pairs
    return pairs(s, causal, window, sk)


def flash_bwd_mutant_case(b, h, kv, s, d, dtype_name, window=0):
    """The limit's power: the backward kernel launched with its softmax
    scale x 1.1 (the wrapper's own call with that one argument changed)
    must fail the check that the true kernel passes."""
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v, do = _bwd_inputs(b, h, kv, s, d, dtype_name, window)
    o, lse = ops.flash_attention(q, k, v, return_lse=True, window=window)
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
        got = ops.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    finally:
        ops._bwd_fn = loader
    want = ref.attention_backward(q.float(), k.float(), v.float(), o.float(),
                                  lse, do.float(), window=window)
    err, nerr, ok = _bwd_check(got, want, dtype_name)
    print(f"  flash_attention_bwd x1.1 softmax-scale mutant "
          f"{(b, h, kv, s, d)} {dtype_name} window {window}: max error over "
          f"the gradient's "
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
        rec["plain_ms"] = time_plain(lambda: ref.wkv6(r, k, v, lw, u, S0))
        rec["library_ms"] = None   # no single PyTorch call computes WKV6
        rec["library_device_ms"] = None
        add_bound(rec, *launch_cost(lambda: ops.wkv6(r, k, v, lw, u, S0)),
                  dtype_name)
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
        rec["plain_ms"] = time_plain(lambda: ref.lru_scan(a, x, h0))
        rec["library_ms"] = None   # no single PyTorch call computes it
        rec["library_device_ms"] = None
        add_bound(rec, *launch_cost(lambda: ops.lru_scan(a, x, h0)),
                  "float32")
    print(f"  lru_scan {(b, s, w)} {'h0' if with_h0 else 'zero state'}: "
          f"max_abs_err {err:.3g} (atol 2e-4 rtol 2e-4) "
          f"{'ok' if ok else 'FAIL'}"
          + (_timing_text(rec, "library") if timed else ""))
    check(ok, f"lru_scan {(b, s, w)} disagrees with its plain version")
    return rec


def wkv6_bwd_case(b, h, t, n, dtype_name, with_s0, *, timed,
                  fill="uniform"):
    """B3's backward on (B, H, T, N) inputs in ``dtype_name`` as the model
    passes them ((B, T, H, N) projections as views), from the forward
    kernel's scratch, against the plain backwards (sequential and chunked)
    in fp64 on the same rounded inputs; a repeat call's bits."""
    import numpy as np
    import torch
    from repro_torch.kernels.rwkv6_scan import ops, ref
    dt = getattr(torch, dtype_name)
    rng = np.random.default_rng(b * 5 + h * 7 + t + n)

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)

    r, k, v, do = (dev(0.5 * rng.normal(size=(b, t, h, n)), dt).transpose(
        1, 2) for _ in range(4))
    lw = dev({"uniform": -rng.uniform(0.01, 2.5, (b, t, h, n)),
              "min": np.full((b, t, h, n), -2.5),
              "max": np.full((b, t, h, n), -1e-4)}[fill]).transpose(1, 2)
    u = dev(0.2 * rng.normal(size=(h, n)))
    S0 = dev(0.3 * rng.normal(size=(b, h, n, n))) if with_s0 else None
    dS = dev(0.3 * rng.normal(size=(b, h, n, n))) if with_s0 else None
    scratch = ops.wkv6_forward(r, k, v, lw, u, S0)[2]

    def kernel():
        return ops.wkv6_bwd(r, k, v, lw, u, do, S0, dS, scratch=scratch)

    got = kernel()
    torch.cuda.synchronize()
    args64 = [x.double() for x in (r, k, v, lw, u, do)] + [
        None if x is None else x.double() for x in (S0, dS)]
    tols = [WKV_TOL[dtype_name]] * 3 + [WKV_TOL["float32"]] * 3
    err, nerr, ok = 0.0, 0.0, True
    for want in (ref.wkv6_backward(*args64),
                 ref.wkv6_backward_chunked(*args64, chunk=ops.CHUNK)):
        e, ne, o_ok = _normed_check(got, want, tols)
        err, nerr, ok = max(err, e), max(nerr, ne), ok and o_ok
        del want
    again = kernel()
    same = all(x is None and y is None or bool(torch.equal(x, y))
               for x, y in zip(got, again))
    del again
    rec = {"shape": [b, h, t, n], "dtype": dtype_name, "s0": with_s0,
           "fill": fill, "max_abs_err": err, "max_err_over_scale": nerr,
           "ok": ok and same}
    if timed:
        time_kernel(rec, kernel)
        rec["plain_ms"] = time_plain(lambda: ref.wkv6_backward(
            r, k, v, lw, u, do, S0, dS))
        rec["library_ms"] = None   # no single PyTorch call computes it
        rec["library_device_ms"] = None
        add_bound(rec, *launch_cost(kernel), "float32")
        rec["passes_device_ms"] = kernel_device_ms(kernel)
    print(f"  wkv6_bwd {(b, h, t, n)} {dtype_name} "
          f"{'S0, dS' if with_s0 else 'zero state'} log_w {fill}: "
          f"max_abs_err {err:.3g}, over the gradient's scale {nerr:.3g}, "
          f"against the sequential and chunked plain backwards in fp64"
          f"{'' if same else ', REPEAT DIFFERS'} "
          f"{'ok' if rec['ok'] else 'FAIL'}"
          + (_timing_text(rec, "library") if timed else ""))
    for name, ms in rec.get("passes_device_ms", {}).items():
        print(f"    wkv6_bwd pass {name}: {ms:.4f} ms of device time a call")
    check(ok, f"wkv6_bwd {(b, h, t, n)} {dtype_name} disagrees with its "
              f"plain versions")
    check(same, f"wkv6_bwd {(b, h, t, n)} {dtype_name}: a repeat call "
                f"changed the bits")
    return rec


def lru_bwd_case(b, s, w, with_h0, *, timed):
    """B4's backward from the forward kernel's h, against the plain
    backward in fp32 on the same inputs; a repeat call's bits."""
    import numpy as np
    import torch
    from repro_torch.kernels.rglru_scan import ops, ref
    rng = np.random.default_rng(b * 17 + s + w)

    def dev(x):
        return torch.from_numpy(x.astype(np.float32)).cuda()

    a = dev(rng.uniform(0.8, 0.999, (b, s, w)))
    x = dev(0.1 * rng.normal(size=(b, s, w)))
    dh = dev(rng.normal(size=(b, s, w)))
    h0 = dev(rng.normal(size=(b, w))) if with_h0 else None
    dl = dev(rng.normal(size=(b, w))) if with_h0 else None
    h, _ = ops.lru_scan(a, x, h0)

    def kernel():
        return ops.lru_scan_bwd(a, h, dh, dl, h0)

    got = kernel()
    torch.cuda.synchronize()
    want = ref.lru_scan_backward(a, h, dh, dl, h0)
    err, nerr, ok = _normed_check(got, want, [LRU_TOL] * 3)
    again = kernel()
    same = all(x is None and y is None or bool(torch.equal(x, y))
               for x, y in zip(got, again))
    rec = {"shape": [b, s, w], "h0": with_h0, "max_abs_err": err,
           "max_err_over_scale": nerr, "ok": ok and same}
    if timed:
        time_kernel(rec, kernel)
        rec["plain_ms"] = time_plain(lambda: ref.lru_scan_backward(
            a, h, dh, dl, h0))
        rec["library_ms"] = None   # no single PyTorch call computes it
        rec["library_device_ms"] = None
        add_bound(rec, *launch_cost(kernel), "float32")
    print(f"  lru_scan_bwd {(b, s, w)} {'h0, dh_last' if with_h0 else 'zero'}"
          f": max_abs_err {err:.3g}, over the gradient's scale {nerr:.3g} "
          f"(atol 2e-4 rtol 2e-4){'' if same else ', REPEAT DIFFERS'} "
          f"{'ok' if rec['ok'] else 'FAIL'}"
          + (_timing_text(rec, "library") if timed else ""))
    check(ok, f"lru_scan_bwd {(b, s, w)} disagrees with its plain version")
    check(same, f"lru_scan_bwd {(b, s, w)}: a repeat call changed the bits")
    return rec


#: the decoder-only families besides olmo-1b
NEW_DECODERS = ("granite-moe-1b-a400m", "deepseek-coder-33b", "granite-20b",
                "phi3.5-moe-42b-a6.6b", "command-r-plus-104b")


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


def decoder_prefill_shapes():
    """B2's largest prefill shape in each of :data:`NEW_DECODERS`: one
    request at its largest prompt bucket."""
    from repro_torch.serve import prompt_bucket
    out = {}
    for arch in NEW_DECODERS:
        cfg, reqs = family_requests(arch)
        s = max(prompt_bucket(r.prompt_len) for r in reqs)
        out[arch] = (1, cfg.n_heads, cfg.n_kv_heads, s, cfg.head_dim)
    return out


#: the decoder-only families trained (or, command-r-plus-104b, whose
#: gradient is run) at 4 x 2048 tokens besides olmo-1b and granite-moe-1b:
#: B2 forward and backward at their training shapes, GQA groups 7, 48 (MQA)
#: and 12 (phi3.5-moe's (4, 32, 8, 2048, 128) is llava-next's, timed with
#: the multimodal shapes)
TRAIN_DECODERS = ("deepseek-coder-33b", "granite-20b", "command-r-plus-104b")


def decoder_train_shapes():
    """(B, H, KV, S, D) of B2 in each of :data:`TRAIN_DECODERS`' training
    (:data:`FAMILY_TRAIN`, :data:`GRAD_SPEC`)."""
    from repro_torch.configs import get_config
    out = {}
    for arch in TRAIN_DECODERS:
        cfg = get_config(arch)
        spec = FAMILY_TRAIN.get(arch, GRAD_SPEC)
        out[arch] = (spec["batch"], cfg.n_heads, cfg.n_kv_heads, spec["seq"],
                     cfg.head_dim)
    return out


def decoder_kernel_cases(recs):
    """B2 at :data:`NEW_DECODERS`' shapes, before any of them runs: the
    forward at each one's prefill shape (GQA groups 2 at
    D = 64, and 4, 7, 48, 12 at D = 128), timed beside SDPA; the backward at
    granite-moe-1b's training shape (timed) and at groups 7, 12 and 48 (the
    MQA one timed: each dK/dV block sums 48 query heads), fp32 and bf16,
    causal and bidirectional; then bf16 forward and backward at
    :func:`decoder_train_shapes`, each timed beside SDPA's, with the
    kernel's device time over SDPA's."""
    for arch, shape in decoder_prefill_shapes().items():
        rec = flash_case(*shape, "bfloat16", True, timed=True)
        rec["arch"] = arch
        recs[f"flash_attention_{arch}"] = rec
        flash_case(*shape, "float32", True, timed=False)
    recs["flash_attention_bwd_moe"] = flash_bwd_case(
        *FA_BWD_MOE_MAIN, "bfloat16", True, timed=True)
    flash_bwd_case(*FA_BWD_MOE_MAIN, "float32", True, timed=False)
    for shape in FA_BWD_GROUP_CASES:
        mqa = shape[1] // shape[2] == 48
        rec = flash_bwd_case(*shape, "bfloat16", True, timed=mqa)
        if mqa:
            recs["flash_attention_bwd_mqa"] = rec
        flash_bwd_case(*shape, "float32", True, timed=False)
        flash_bwd_case(*shape[:3], 129, shape[4], "bfloat16", False,
                       timed=False)
    for arch, shape in decoder_train_shapes().items():
        fwd = flash_case(*shape, "bfloat16", True, timed=True)
        bwd = flash_bwd_case(*shape, "bfloat16", True, timed=True)
        recs[f"flash_attention_train_{arch}"] = dict(fwd, arch=arch)
        recs[f"flash_attention_bwd_train_{arch}"] = dict(bwd, arch=arch)
        print(f"  B2 at {arch}'s training shape {shape}: device time over "
              f"SDPA's, forward "
              f"{fwd['device_ms'] / fwd['library_device_ms']:.2f}x, backward "
              f"{bwd['device_ms'] / bwd['library_device_ms']:.2f}x "
              f"({shape[0] * shape[2] * -(-shape[3] // 64)} dK/dV blocks "
              f"of 64 keys)")


def multimodal_shapes():
    """B2's shapes on whisper-small's and llava-next's serve and train
    paths, name -> ((B, H, KV, Sq, D), Sk, causal): the encoder over 1500
    frames (bidirectional) and the cross-attention of the largest prompt
    bucket (serve) or the training length (train) to them; llava's causal
    prefill over its 576 image rows and largest bucket, and its training
    positions (576 + the text)."""
    from repro_torch.serve import prompt_bucket
    out = {}
    for arch in ("whisper-small", "llava-next-mistral-7b"):
        cfg, reqs = family_requests(arch)
        head = (cfg.n_heads, cfg.n_kv_heads)
        s = max(prompt_bucket(r.prompt_len) for r in reqs)
        b, st = FAMILY_TRAIN[arch]["batch"], FAMILY_TRAIN[arch]["seq"]
        d = cfg.head_dim
        if cfg.is_encdec:
            t = cfg.n_frames
            out.update({
                "whisper_encoder": ((1, *head, t, d), t, False),
                "whisper_cross": ((1, *head, s, d), t, False),
                "whisper_encoder_train": ((b, *head, t, d), t, False),
                "whisper_cross_train": ((b, *head, st, d), t, False)})
        else:
            n = cfg.n_image_tokens
            out.update({
                "llava": ((1, *head, n + s, d), None, True),
                "llava_train": ((b, *head, n + st, d), None, True)})
    return out


def multimodal_kernel_cases(recs):
    """B2 at :func:`multimodal_shapes`, before either family runs: the
    forward at the serve shapes and the backward at the train shapes, bf16
    timed beside SDPA; the forward in fp32 too; then the backward at
    :data:`FA_BWD_CROSS_CASES` in fp32 and bf16."""
    for name, (shape, sk, causal) in multimodal_shapes().items():
        if name.endswith("_train"):
            recs[f"flash_attention_bwd_{name}"] = flash_bwd_case(
                *shape, "bfloat16", causal, timed=True, sk=sk)
            continue
        recs[f"flash_attention_{name}"] = flash_case(
            *shape, "bfloat16", causal, timed=True, sk=sk)
        flash_case(*shape, "float32", causal, timed=False, sk=sk)
    for b, h, kv, s, sk, d, causal in FA_BWD_CROSS_CASES:
        for dt in ("float32", "bfloat16"):
            flash_bwd_case(b, h, kv, s, d, dt, causal, timed=False, sk=sk)


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
    # the backwards of the recurrent families' training: B2 at D = 256
    # (recurrentgemma's local attention), B3, B4, each at its training
    # shape and its edges
    recs["flash_attention_bwd_d256"] = flash_bwd_case(
        *FA_BWD_256_MAIN, "bfloat16", True, timed=True,
        window=FA_BWD_256_WINDOW)
    recs["flash_attention_bwd_d256_fp32"] = flash_bwd_case(
        *FA_BWD_256_MAIN, "float32", True, timed=True,
        window=FA_BWD_256_WINDOW)
    flash_bwd_mutant_case(1, 10, 1, 700, 256, "bfloat16", window=200)
    for dt in ("float32", "bfloat16"):
        for s in FA_BWD_256_EDGE_S:
            flash_bwd_case(1, 10, 1, s, 256, dt, True, timed=False,
                           window=16)
        for b, h, kv, s, d, causal, window in FA_BWD_256_CASES:
            flash_bwd_case(b, h, kv, s, d, dt, causal, timed=False,
                           window=window)
    decoder_kernel_cases(recs)
    multimodal_kernel_cases(recs)
    recs["wkv6_bwd"] = wkv6_bwd_case(*WKV_BWD_MAIN, "bfloat16", False,
                                     timed=True)
    wkv6_bwd_case(*WKV_BWD_MAIN[:3], 64, "float32", False, timed=False)
    for t in WKV_BWD_EDGE_T:
        for dt in ("float32", "bfloat16"):
            wkv6_bwd_case(1, WKV_BWD_MAIN[1], t, 64, dt, True, timed=False)
    for fill in ("min", "max"):
        wkv6_bwd_case(1, 4, 3000, 64, "float32", True, timed=False,
                      fill=fill)
    recs["lru_scan_bwd"] = lru_bwd_case(*LRU_BWD_MAIN, False, timed=True)
    for shape in LRU_BWD_EDGES:
        for with_h0 in (False, True):
            lru_bwd_case(*shape, with_h0, timed=False)
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
    rec["plain_ms"] = time_plain(lambda: ref.pairwise_distance(x))
    time_kernel(rec, lambda: torch.cdist(
        x, x, compute_mode="use_mm_for_euclid_dist"), "library_")
    add_bound(rec, *launch_cost(lambda: ops.pairwise_distance(x)), "float32")
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
    import torch
    counted = wrappers()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    # olmo-1b's run goes through the launcher's flight recorder
    trace_dir = (tempfile.mkdtemp(prefix="chip_smoke_serve_trace_")
                 if arch == TRACED_SERVE else None)
    t0 = time.perf_counter()
    res = serve_run(arch, "unstable", trace_dir=trace_dir)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    if trace_dir:
        validate_trace(trace_dir, SERVE_SPANS, f"serve {arch}")
        shutil.rmtree(trace_dir, ignore_errors=True)
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
        "prompt_lens": plens, "launches": launches,
        "layers": eng.cfg.n_layers, "peak_gb": peak / 1e9}
    print(f"serve {arch} (unstable): {json.dumps(serve_rec)} "
          f"(phase {wall:.1f} s)")
    cfg = eng.cfg
    from repro_torch.configs import get_config
    from repro_torch.tree import flatten
    leaves = [t for _, t in flatten(eng.params)]
    print(f"  serve {arch}: published widths, {cfg.n_layers} of "
          f"{get_config(arch).n_layers} layers, "
          f"{sum(t.numel() for t in leaves) / 1e9:.3f} B params in "
          f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} GB;"
          f" peak device memory {peak / 1e9:.2f} GB")
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
    if cfg.is_encdec or cfg.n_image_tokens:
        print(f"  side inputs a request: "
              + (f"{cfg.n_frames} frame embeddings (the encoder runs once "
                 f"a prefill; cross K/V cached)" if cfg.is_encdec else
                 f"{cfg.n_image_tokens} image embeddings before the prompt "
                 f"(decode starts at position {cfg.n_image_tokens} + the "
                 f"prompt)") + f"; cache_len {res['cache_len']}")
    serve_rec["snapshot"] = snapshot_cost(eng, res["cache_len"])
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


def snapshot_cost(eng, cache_len):
    """What one decode snapshot costs the engine: the slot row's bytes (all
    its cache leaves: an encoder-decoder row holds its cross K/V) and the
    host seconds to copy it off the card and to hash it into the store,
    each the median of 5; beside the run's snapshot count."""
    from repro_torch.serve.snapshot import (DecodeSnapshot, SnapshotStore,
                                            cache_batch_axes, slot_get)
    axes = cache_batch_axes(eng.cfg, cache_len)
    copy_s, hash_s = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        row = slot_get(eng.cache, axes, 0)
        t1 = time.perf_counter()
        SnapshotStore().save(DecodeSnapshot(rid=0, pos=0, tokens=[0],
                                            last_token=0, cache_row=row,
                                            step=0))
        copy_s.append(t1 - t0)
        hash_s.append(time.perf_counter() - t1)
    out = {"row_mb": sum(t.numel() * t.element_size()
                         for t in row.values()) / 1e6,
           "copy_ms": 1e3 * statistics.median(copy_s),
           "hash_ms": 1e3 * statistics.median(hash_s),
           "snapshots": int(eng.metrics.snapshots),
           "leaves": {k: list(t.shape) for k, t in row.items()}}
    print(f"  snapshot: a slot row of {out['row_mb']:.2f} MB "
          f"({out['leaves']}); host copy {out['copy_ms']:.2f} ms, sha1 into "
          f"the store {out['hash_ms']:.2f} ms (median of 5); "
          f"{out['snapshots']} snapshots in the run")
    return out


def _prefill_len(cfg, plen):
    from repro_torch.serve import prompt_bucket
    return plen if (cfg.rwkv or cfg.rglru) else prompt_bucket(plen)


# the port's own kernels, by the names the profiler gives them
PORT_KERNELS = ("pairwise_distance_kernel", "flash_fwd", "flash_bwd",
                "wkv6_", "lru_chunk", "lru_bwd")


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
    length (its bucket for dense, exact for the recurrent families; with
    that request's frames or image embeddings) and
    ``steps`` batched decode steps at the last cache position, of the serve
    phase's engine (all slots live), after warm-up (:func:`_profile`)."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import prefill_inputs
    eng = res["engine"]
    n = eng.pool.n_slots
    req = max(res["requests"], key=lambda r: r.prompt_len)
    seq = _prefill_len(eng.cfg, req.prompt_len)
    batch = prefill_inputs(eng.cfg, req, np.ones((1, seq), np.int32), "cuda")
    last = torch.tensor([eng.cfg.n_image_tokens + seq - 1], device="cuda")
    toks = torch.ones((n, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((n,), res["cache_len"] - 1, dtype=torch.int64,
                     device="cuda")
    live = torch.ones((n,), dtype=torch.bool, device="cuda")

    def prefill():
        logits, _ = eng._prefill_step(eng.params, batch, last)
        return logits.cpu()

    def decode():
        nxt, _, _ = eng._serve(eng.params, eng.cache, toks, pos, live)
        return nxt.cpu()

    return {name: _profile(f"{eng.cfg.name} {name} (length {seq})", fn,
                           reps)
            for name, fn, reps in (("prefill", prefill, 1),
                                   ("decode", decode, steps))}


def phase_fault_transparency(arch, res):
    """The same requests with no failures, on the same weights."""
    import torch
    clean = serve_run(arch, "none", params=res["params"])
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


def _dropped(log, real=None):
    """(token, choice) pairs the MoE layers dropped for capacity in the
    calls whose routing ``log`` holds; with ``real``, among the first
    ``real`` tokens of each (one-row) group only."""
    return sum(int((~r["keep"][:, :real]).sum()) for r in log)


def _moe_logged(fn):
    """``fn()`` with the MoE layers' routing logged (``layers.route_log``):
    (its result, the log)."""
    from repro_torch.models import layers
    layers.route_log = []
    try:
        return fn(), layers.route_log
    finally:
        layers.route_log = None


def phase_reference(res):
    """Engine tokens against the batch=1 reference.  The two paths differ
    in prompt padding (dense only: the recurrent families prefill at the
    exact length on both) and decode batch width, so the matrix products
    may round differently; a divergence is accepted only where the
    reference's logit gap between the two tokens is below BOUND = 4 * delta,
    delta the largest logit difference measured between the two paths'
    prefill (engine length vs exact) and first decode step (batch 4 vs
    batch 1) (2 for the two logits, 2 for growth over the decode steps).

    MoE families: an expert's capacity follows the dispatch group's length
    (JAX's design), so the engine's bucket-padded prefill and the
    reference's exact one may drop different (token, choice) pairs.  Each
    request's dropped pairs are counted in both runs (the engine's among
    the prompt's own tokens: the padding comes after them in token order);
    delta is measured and the gap rule held only on requests where neither
    dropped one, and a divergence on another is printed as a capacity
    divergence and counted.  A decode step cannot drop: its group is the
    batch (at most 4 slots) and a capacity is at least 4."""
    import numpy as np
    import torch
    from repro_torch.distributed.steps import (make_prefill_step,
                                               make_serve_step)
    from repro_torch.serve import greedy_decode
    from repro_torch.serve.engine import prefill_inputs
    from repro_torch.serve.snapshot import cache_batch_axes
    eng, cfg = res["engine"], res["engine"].cfg
    off = cfg.n_image_tokens
    params, cache_len = eng.params, res["cache_len"]
    axes = cache_batch_axes(cfg, cache_len)
    pre = make_prefill_step(cfg, cache_len)
    serve = make_serve_step(cfg)
    n = eng.pool.n_slots
    delta = 0.0
    drops = {}
    for r in res["requests"]:
        p = r.prompt_len
        toks = np.zeros((1, _prefill_len(cfg, p)), dtype=np.int32)
        toks[0, :p] = r.prompt
        (lp, _), log_p = _moe_logged(lambda: pre(
            params, prefill_inputs(cfg, r, toks, "cuda"),
            torch.tensor([off + p - 1], device="cuda")))
        (le, cache), log_e = _moe_logged(lambda: pre(
            params, prefill_inputs(cfg, r, toks[:, :p].copy(), "cuda")))
        drops[r.rid] = (_dropped(log_p, p), _dropped(log_e))
        if sum(drops[r.rid]):
            del cache
            continue
        delta = max(delta, float((lp - le).abs().max()))
        tok = torch.argmax(le, -1).to(torch.int32)[:, None]
        wide = {k: v.repeat_interleave(n, dim=axes[k])
                for k, v in cache.items()}
        _, l1, _ = serve(params, cache, tok, off + p)
        _, l4, _ = serve(params, wide, tok.expand(n, 1), off + p)
        delta = max(delta, float((l4 - l1).abs().max()))
        del cache, wide
    bound = 4 * delta
    print(f"reference parity {cfg.name}: measured path logit difference "
          f"delta {delta:.4g}, divergence bound 4*delta = {bound:.4g}")
    if cfg.is_moe:
        print(f"  MoE capacity: dropped (token, choice) pairs a request, "
              f"engine's bucket prefill / reference's exact prefill: "
              f"{ {rid: d for rid, d in drops.items()} }")
    exact, worst, capacity = 0, 0.0, []
    for r in res["requests"]:
        got = eng.output(r.rid)
        (ref_toks, logits), log = _moe_logged(lambda: greedy_decode(
            params, cfg, r, cache_len, device="cuda", expect=got))
        check(_dropped(log) == drops[r.rid][1],
              f"rid {r.rid}: the reference's decode dropped MoE pairs")
        t = next((i for i, (a, b) in enumerate(zip(got, ref_toks))
                  if a != b), None)
        if t is None:
            check(len(got) == len(ref_toks), f"rid {r.rid}: length differs")
            exact += 1
            continue
        # the reference stopped after the first token that differs
        check(t == len(ref_toks) - 1, f"rid {r.rid}: decoded past a "
                                      f"divergence")
        gap = float(logits[t, ref_toks[t]] - logits[t, got[t]])
        if sum(drops[r.rid]):
            capacity.append(r.rid)
            print(f"  rid {r.rid}: CAPACITY DIVERGENCE at step {t} (engine "
                  f"{got[t]}, reference {ref_toks[t]}, reference gap "
                  f"{gap:.4g}): dropped pairs engine {drops[r.rid][0]}, "
                  f"reference {drops[r.rid][1]}")
            continue
        worst = max(worst, gap)
        print(f"  rid {r.rid}: first differs at step {t} "
              f"(engine {got[t]}, reference {ref_toks[t]}), reference gap "
              f"{gap:.4g} {'<=' if gap <= bound else '>'} bound")
        check(gap <= bound, f"rid {r.rid}: divergence at step {t} with "
                            f"logit gap {gap:.4g} > bound {bound:.4g}")
    held = sum(1 for d in drops.values() if not sum(d))
    print(f"reference parity {cfg.name}: {exact}/{len(res['requests'])} "
          f"token-exact, largest divergence gap {worst:.4g} (bound "
          f"{bound:.4g}) on the {held} requests without dropped pairs"
          + (f"; {len(capacity)} capacity divergences (rids {capacity})"
             if cfg.is_moe else ""))
    return {"exact": exact, "delta": delta, "bound": bound, "worst_gap": worst,
            "capacity_divergences": capacity, "drops": drops}


def phase_family(arch):
    """Serve, profile, fault transparency and reference parity of one
    family, each part's host seconds printed; frees its engines before
    returning the launch counts."""
    import torch
    t = [time.perf_counter()]
    res, _, launches = phase_serve(arch)
    t.append(time.perf_counter())
    profile_engine(res)
    t.append(time.perf_counter())
    phase_fault_transparency(arch, res)
    t.append(time.perf_counter())
    phase_reference(res)
    t.append(time.perf_counter())
    print(f"{arch} parts (s): " + ", ".join(
        f"{name} {b - a:.1f}" for name, a, b in zip(
            ("serve", "profile", "fault transparency", "reference"),
            t, t[1:])))
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 6-7: olmo-1b training under the fault-tolerant coordinator
# ---------------------------------------------------------------------------

# full width and depth, global batch 4 x 2048; a checkpoint every 10 steps
# (the interval's floor), a host crash forced at step 6.  9 steps, so that
# only step 0's checkpoint (14 GB) is written: with the chaos phase's and
# the recurrent families' crash runs' checkpoints the whole script then
# writes ~40 GB to disk, where a second save here would take it past 50
TRAIN_ARGS = ["--arch", "olmo-1b", "--steps", "9", "--global-batch", "4",
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
# and two host crashes stacked on step 12 by the failure injector, right
# after disk_full's forced save there: the second visit escalates the
# repair wait (coord.backoff); the pre-retry checkpoint barrier finds that
# save already in place, so the repeat writes nothing more
CHAOS_REPEAT = {12: 2}
# the witnesses of the classes phase 7 fires that the coordinator, the
# chaos engine and the store emit (ROADMAP's "Observability witnesses")
CHAOS_SPANS = tuple(f"fault.{k}" for k in (
    "host_crash", "slowdown", "capacity_loss", "ckpt_corrupt", "nan_poison",
    "net_partition", "disk_full")) + (
    "recover.host_crash", "ckpt.restore", "coord.backoff",
    "recover.ckpt_corrupt", "ckpt.quarantine", "ckpt.fallback",
    "recover.nan_poison", "recover.net_partition", "recover.disk_full",
    "ckpt.enospc_retry", "ckpt.prune")
# the cross-pod cluster (phase 7b): the launcher's --pods path at the
# published widths and CHAOS_LAYERS layers, 3 pods, 4 x 512 tokens, 10
# steps; pod 0 cut off at round 2 for 3 rounds, an ENOSPC strike at round
# 7; the run's own --chaos-assert holds every pod to a fault-free reference
CLUSTER_ARGS = ["--arch", "olmo-1b", "--pods", "3", "--steps", "10",
                "--global-batch", "4", "--seq-len", "512", "--seed", "0",
                "--device", "cuda", "--chaos-assert",
                "--trace-dump-on-fault"]
CLUSTER_EVENTS = [(2, "net_partition", (0,), 3, 0), (7, "disk_full", (), 0, 0)]
CLUSTER_SPANS = ("crosspod.partition", "crosspod.heal", "crosspod.catchup",
                 "recover.net_partition", "recover.disk_full",
                 "ckpt.enospc_retry")
# one exchange round at full width: olmo-1b whole, the gradient of a
# 4 x 2048 step from each of three batches
EXCHANGE_SHAPE = (4, 2048)
PEAK_BF16 = PEAK_FLOPS_S["bfloat16"]


def span_seconds(recorder, name):
    """The seconds of each ``name`` span a flight recorder holds."""
    return [r["t1"] - r["t0"] for r in recorder.snapshot()
            if r["type"] == "span" and r["name"] == name]


def matmul_params(cfg):
    """Parameters that enter a matrix product a token (the embedding is a
    gather; the output head a product), by family: an MoE layer's router
    and its top_k of n_experts experts (as ``active_param_count``); a
    parallel block's attention and MLP are those of a sequential one."""
    from repro_torch.models import lm
    from repro_torch.models.rwkv6 import LORA_R
    d, ff = cfg.d_model, cfg.d_ff
    head = d * cfg.vocab_size
    if cfg.rwkv:
        # r, k, v, g, o; the ddlerp and decay LoRAs; the channel mix
        layer = 6 * d * d + 10 * d * LORA_R + 2 * d * LORA_R + 2 * d * ff
        return cfg.n_layers * layer + head
    mlp = (d * cfg.n_experts + cfg.top_k * 3 * d * ff if cfg.is_moe
           else 3 * d * ff)
    attn = (2 * d * cfg.n_heads * cfg.head_dim
            + 2 * d * cfg.n_kv_heads * cfg.head_dim)
    if cfg.rglru:
        w = cfg.lru_width
        rec = 2 * d * w + 2 * w * w + w * d + mlp
        n_super, n_tail = lm.hybrid_layout(cfg)
        return (n_super * (cfg.rec_per_attn * rec + attn + mlp)
                + n_tail * rec + head)
    return cfg.n_layers * (attn + mlp) + head


def mixing_flops(cfg, b, s):
    """FLOPs of one forward's sequence mixing outside the matmuls: causal
    or windowed attention (2 products of 2 B H pairs D a layer), or the
    WKV6 recurrence (4 N^2 a token and head: the state update and the
    output)."""
    from repro_torch.models import lm
    from repro_torch.models.rwkv6 import HEAD_N
    if cfg.rwkv:
        return cfg.n_layers * 4 * b * s * cfg.d_model * HEAD_N
    pairs = attended_pairs(s, True, cfg.window if cfg.rglru else 0)
    layers = lm.hybrid_layout(cfg)[0] if cfg.rglru else cfg.n_layers
    return layers * 4 * b * cfg.n_heads * pairs * cfg.head_dim


def forward_flops(cfg, b, s):
    """FLOPs of one training forward at b x s text tokens: 2 x the matmul
    parameters each token passes, plus the sequence mixing.  The image
    family's trunk also runs over its image rows (the head over the text
    only); the encoder-decoder's encoder and its cross K/V projections run
    over the frames, its decoder's cross-attention over text x frames."""
    head = cfg.d_model * cfg.vocab_size
    if cfg.is_encdec:
        d, hd, t = cfg.d_model, cfg.head_dim, cfg.n_frames
        q_o = 2 * d * cfg.n_heads * hd
        k_v = 2 * d * cfg.n_kv_heads * hd
        mlp = 2 * d * cfg.d_ff                      # GELU: up and down
        enc = cfg.encoder_layers * (q_o + k_v + mlp)
        dec = cfg.n_layers * (2 * q_o + k_v + mlp)
        pairs = (cfg.encoder_layers * t * t
                 + cfg.n_layers * (attended_pairs(s, True, 0) + s * t))
        return (2 * b * t * (enc + cfg.n_layers * k_v)
                + 2 * b * s * (dec + head) + 4 * b * cfg.n_heads * pairs * hd)
    n = s + cfg.n_image_tokens
    return (2 * b * n * (matmul_params(cfg) - head) + 2 * b * s * head
            + mixing_flops(cfg, b, n))


def train_flops(cfg, b, s):
    """(model FLOPs, executed FLOPs) of one train step: three forwards
    (:func:`forward_flops`: the forward and a backward of twice its
    products); executed adds what remat recomputes (each remat unit's
    forward and each xent chunk's logits), a fourth."""
    f = forward_flops(cfg, b, s)
    return 3 * f, 4 * f


def _launch_train(cfg, args, built):
    """The launcher's run, its SystemExit (a --chaos-assert failure) as a
    smoke failure."""
    from repro_torch.launch import train as launch
    try:
        return launch.run(cfg, args, built)
    except SystemExit as e:
        raise SmokeFailure(f"train launcher: {e}") from None


def _zero_launches():
    counted = wrappers()
    for fn in counted.values():
        fn.launches = 0
    return counted


def crash_then_replay(cfg, argv, crash_step, tmp, label, kernels):
    """The launcher's code path (``launch.build``/``run``) on ``cfg`` with
    a host crash forced at ``crash_step``, then the same steps from the same
    init on the same batches without faults: every step completes,
    restores == failures == 1, finite losses, every kernel in ``kernels``
    launched, and final params (sha1 of every leaf) and losses equal to the
    fault-free run's.  Returns the crash run's launch counts, report,
    checkpoint spans and bytes, and the fault-free run's final trees, step
    function, pipeline, step times and losses."""
    import numpy as np
    from repro_torch.ft import tree_digest
    from repro_torch.launch import train as launch
    from repro_torch.obs import (FlightRecorder, MetricsRegistry, ObsContext,
                                 Tracer)
    from repro_torch.tree import flatten
    parser = launch.build_parser()
    args = parser.parse_args(argv + [
        "--inject-mtbf-steps", "1e9", "--ckpt-dir",
        os.path.join(tmp, f"{label}-run")])
    log = FlightRecorder()
    built = launch.build(cfg, args, ctx=ObsContext(
        tracer=Tracer(log), recorder=log, registry=MetricsRegistry()))
    coord = built["coord"]
    coord.store.keep = 2
    built["injector"].fail_steps = {crash_step: 1}
    ckpt_bytes = tree_bytes({"params": coord.params, "opt": coord.opt_state})
    counted = _zero_launches()
    t0 = time.perf_counter()
    res = _launch_train(cfg, args, built)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    rep = res["report"]
    print(f"train {label} (crash at step {crash_step}): "
          f"{rep.steps_completed}/{args.steps} steps, failures "
          f"{rep.failures}, restores {rep.restores}, replayed "
          f"{rep.wasted_steps}, checkpoints {rep.checkpoints}, phase "
          f"{wall:.1f} s; launches {launches}")
    check(rep.steps_completed == args.steps,
          f"{label}: the crash run did not finish")
    check(rep.restores == rep.failures == 1,
          f"{label}: restores {rep.restores}, failures {rep.failures}: want "
          f"1 each")
    check(all(np.isfinite(rep.losses)), f"{label}: a non-finite loss")
    for name in kernels:
        check(launches[name] > 0, f"the {label} train path never launched "
                                  f"{name}")
    digest = tree_digest(coord.params)
    n_leaves = len(flatten(coord.params))
    out = {"launches": launches, "report": rep, "ckpt_bytes": ckpt_bytes,
           "saves": span_seconds(log, "ckpt.save"),
           "restores": span_seconds(log, "ckpt.restore")}
    losses_run = list(rep.losses)
    del res, built, coord
    gc.collect()
    import torch
    torch.cuda.empty_cache()

    # the same steps from the same init on the same batches, no faults
    ref = launch.build(cfg, parser.parse_args(argv + [
        "--ckpt-dir", os.path.join(tmp, f"{label}-ref")]))
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
    print(f"train {label}: final params "
          f"{'bit-identical' if same else 'DIFFER'} to the fault-free run "
          f"({n_leaves} leaves, one sha1 over their bytes: tree_digest); "
          f"last {args.steps} losses "
          f"of the crash run "
          f"{'equal' if losses_run[-args.steps:] == losses else 'DIFFER'}; "
          f"losses {[round(x, 4) for x in losses]}")
    check(same, f"{label}: the crash run's final params differ from the "
                f"fault-free run's")
    check(losses_run[-args.steps:] == losses,
          f"{label}: the crash run's losses differ from the fault-free "
          f"run's")
    out.update(params=params, opt=opt, step_fn=step_fn, pipe=pipe,
               times=times, losses=losses, args=args)
    return out


def flops_against_cell(arch, cfg, b, seq, model, executed):
    """The script's own FLOP counts of a train step beside
    ``analysis.flops.cell_flops`` at the same shape (its ``model_flops``
    is 6 x active params x text tokens; its ``flops`` counts remat's
    recompute and an MoE layer's capacity slots).  Returns the cell."""
    from repro_torch.analysis.flops import cell_flops
    from repro_torch.launch.shapes import Shape
    cell = cell_flops(cfg, Shape("train", "train",
                                 seq + cfg.n_image_tokens, b))
    print(f"train {arch} FLOPs a step: the script's model {model / 1e12:.3f}"
          f" / executed {executed / 1e12:.3f} TFLOP, cell_flops' model "
          f"{cell.model_flops / 1e12:.3f} / flops {cell.flops / 1e12:.3f} "
          f"TFLOP (ratios {cell.model_flops / model:.3f}, "
          f"{cell.flops / executed:.3f}); the share of the bf16 peak uses "
          f"the script's model FLOPs")
    return cell


def phase_train(tmp):
    """olmo-1b at full width through the launcher's code path with a forced
    crash, then the same steps without faults; ``capture_cost`` of one step
    beside the analytic counts; returns the path's launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.obs import profile_jit
    cfg = get_config("olmo-1b")
    run = crash_then_replay(cfg, TRAIN_ARGS, TRAIN_CRASH_STEP, tmp,
                            "olmo-1b", ("flash_attention",
                                        "flash_attention_bwd"))
    args, times = run["args"], run["times"]
    step_s = statistics.median(times[1:])
    b, seq = args.global_batch, args.seq_len
    model, executed = train_flops(cfg, b, seq)
    print(f"train olmo-1b step: {1e3 * step_s:.1f} ms (median of "
          f"{len(times) - 1}, host clock, each step ends in a copy of its "
          f"loss), {b * seq / step_s:.0f} tokens/s, model "
          f"{model / 1e12:.2f} TFLOP a step ({executed / 1e12:.2f} executed "
          f"with remat), {model / step_s / 1e12:.1f} TFLOP/s, "
          f"{model / step_s / PEAK_BF16:.3f} of the bf16 peak")
    print(f"train olmo-1b checkpoints: {run['ckpt_bytes'] / 1e9:.2f} GB each "
          f"(params, mu, nu, step); saves "
          f"{[round(x, 2) for x in run['saves']]} s, restores "
          f"{[round(x, 2) for x in run['restores']]} s (host copy, np.save, "
          f"sha1 of every leaf; the restore reads, verifies, copies back)")
    params, opt, step_fn = run["params"], run["opt"], run["step_fn"]
    batch = run["pipe"].batch_at(args.steps)
    cell = flops_against_cell("olmo-1b", cfg, b, seq, model, executed)
    # the dense family: both count the same products
    check(abs(cell.flops / executed - 1) < 0.05
          and abs(cell.model_flops / model - 1) < 0.10,
          "olmo-1b: the script's FLOP counts part from cell_flops'")
    t0 = time.perf_counter()
    cost = profile_jit(step_fn, name="train_step").capture_cost(
        params, opt, batch)
    kernels = {k: f"{v['flops'] / 1e12:.3f} TFLOP, {v['bytes'] / 1e9:.2f} "
                  f"GB, {v['launches']} launches"
               for k, v in cost["kernels"].items()}
    print(f"train olmo-1b capture_cost of one step (outside the timed "
          f"steps, {time.perf_counter() - t0:.1f} s): "
          f"{cost['flops'] / 1e12:.3f} TFLOP ({cost['aten_flops'] / 1e12:.3f}"
          f" by aten ops, the rest by the kernels' reports: {kernels}), "
          f"{cost['bytes accessed'] / 1e9:.2f} GB accessed "
          f"({cost['aten_bytes'] / 1e9:.2f} by aten ops); against "
          f"cell_flops' flops {cost['flops'] / cell.flops:.3f}, the "
          f"script's executed {cost['flops'] / executed:.3f}")
    check({"flash_attention", "flash_attention_bwd"} <= set(cost["kernels"]),
          "capture_cost saw no flash-attention launch")
    check(abs(cost["flops"] / cell.flops - 1) < 0.35,
          "capture_cost's FLOPs are not within 0.35 of cell_flops'")
    _profile("olmo-1b train step (4 x 2048)",
             lambda: float(step_fn(params, opt, batch)[2]["loss"]), 1)
    launches = run["launches"]
    del params, opt, run
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 8-9: rwkv6-3b and recurrentgemma-2b training
# ---------------------------------------------------------------------------

#: the published widths at a cut depth, the largest whose peak device
#: memory stays under ~70 GB (fp32 params, their gradients, mu and nu, and
#: AdamW's out-of-place new params, mu and nu: ~28 bytes a parameter, plus
#: activations); recurrentgemma at 3k + 2 layers, so that its super blocks
#: and its tail both run.  Global batch: rwkv6 4 x 2048 (the tokens of
#: olmo's step), recurrentgemma 2 x 4096 (at 2048 tokens its 2048-token
#: window would mask no key)
FAMILY_TRAIN = {
    "rwkv6-3b": dict(layers=24, batch=4, seq=2048,
                     kernels=("wkv6", "wkv6_bwd")),
    "recurrentgemma-2b": dict(layers=20, batch=2, seq=4096,
                              kernels=("lru_scan", "lru_scan_bwd",
                                       "flash_attention",
                                       "flash_attention_bwd")),
    # uncut: 1.335 B params, ~37 GB at ~28 bytes a parameter
    "granite-moe-1b-a400m": dict(layers=24, batch=4, seq=2048,
                                 kernels=("flash_attention",
                                          "flash_attention_bwd")),
    # uncut (12 + 12 layers, 0.30 B params): 16 x 448 decoder tokens (its
    # text context), 1500 frames a sample
    "whisper-small": dict(layers=12, batch=16, seq=448,
                          kernels=("flash_attention", "flash_attention_bwd")),
    # 8 of 32 layers (~2.0 B params, ~56 GB at ~28 bytes a parameter):
    # 4 x (576 image + 1472 text) positions
    "llava-next-mistral-7b": dict(layers=8, batch=4, seq=1472,
                                  kernels=("flash_attention",
                                           "flash_attention_bwd")),
    # 3 of 62 layers: 2.05 B params, ~57.5 GB at ~28 bytes a parameter
    "deepseek-coder-33b": dict(layers=3, batch=4, seq=2048,
                               kernels=("flash_attention",
                                        "flash_attention_bwd")),
    # 3 of 52 layers (MQA, q/k/v/o and LayerNorm biases): 2.19 B params,
    # ~61.4 GB at ~28 bytes a parameter
    "granite-20b": dict(layers=3, batch=4, seq=2048,
                        kernels=("flash_attention", "flash_attention_bwd")),
    # 1 of 32 layers (16 experts, top 2): 1.56 B params, ~43.8 GB at ~28
    # bytes a parameter; 2 layers (2.86 B, ~80 GB) would not fit
    "phi3.5-moe-42b-a6.6b": dict(layers=1, batch=4, seq=2048,
                                 kernels=("flash_attention",
                                          "flash_attention_bwd")),
}
FAMILY_TRAIN_STEPS = 4   # the first warms up; the time is the others' median
MEM_TARGET = 70e9
# the crash runs at reduced depth (recurrentgemma: one super block;
# whisper: 2 encoder and 2 decoder layers, at its 448-token text context),
# each config's cut and extra flags.  llava has none: its checkpoint holds
# the 32000 x 4096 embedding and head and their moments, ~5.8 GB even at
# one layer, and the machine allows ~45 GiB of disk writes, ~40 GB of them
# taken already (TRAIN_ARGS).  Nor have deepseek-coder-33b, granite-20b
# and phi3.5-moe: their checkpoints (params and AdamW moments) are 12-19
# GB even at one layer, and the crash path (coordinator, store, replay)
# does not depend on the family: the cells above hold it
CRASH_CUTS = {"rwkv6-3b": (dict(n_layers=2), []),
              "recurrentgemma-2b": (dict(n_layers=3), []),
              "granite-moe-1b-a400m": (dict(n_layers=2), []),
              "whisper-small": (dict(n_layers=2, encoder_layers=2),
                                ["--seq-len", "448"])}
CRASH_ARGS = ["--steps", "6", "--global-batch", "4", "--seq-len", "512",
              "--seed", "0", "--device", "cuda", "--ckpt-gamma-s", "0.001"]
CRASH_STEP = 4


def phase_train_family(arch, tmp):
    """``arch`` at its published widths and the cut depth of
    :data:`FAMILY_TRAIN`, deterministic, bf16 compute, fp32 params: the
    launcher's ``build`` (params, AdamW state, train step, pipeline), then
    a few steps of its train step (no checkpoint: a save of these trees
    would take most of the phase); step time, tokens/s, model FLOPs and
    their share of the bf16 peak, peak device memory and bytes a
    parameter, the path's kernel launches, and a profiled step.  Returns
    the launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.tree import flatten
    spec = FAMILY_TRAIN[arch]
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=spec["layers"])
    args = launch.build_parser().parse_args([
        "--arch", arch, "--steps", str(FAMILY_TRAIN_STEPS), "--global-batch",
        str(spec["batch"]), "--seq-len", str(spec["seq"]), "--seed", "0",
        "--device", "cuda", "--ckpt-dir", os.path.join(tmp, arch)])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    built = launch.build(cfg, args)
    params, opt = built["coord"].params, built["coord"].opt_state
    step_fn, pipe = built["step_fn"], built["pipeline"]
    del built
    n_params = sum(t.numel() for _, t in flatten(params))
    counted = _zero_launches()
    times, losses = [], []
    for i in range(FAMILY_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, pipe.batch_at(i))
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[1:])
    b, seq = spec["batch"], spec["seq"]
    model, executed = train_flops(cfg, b, seq)
    side = (f" + {cfg.encoder_layers} encoder layers over {cfg.n_frames} "
            f"frames a sample" if cfg.is_encdec else
            f", {cfg.n_image_tokens} image rows before each sample's text"
            if cfg.n_image_tokens else "")
    print(f"train {arch}: published widths (d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}), depth {cfg.n_layers} of {full.n_layers}"
          f"{side}, "
          f"{n_params / 1e9:.3f} B params, global batch {b} x {seq}; peak "
          f"device memory {peak / 1e9:.2f} GB ({peak / n_params:.1f} bytes a "
          f"parameter; target under {MEM_TARGET / 1e9:.0f} GB); launches "
          f"{launches}")
    print(f"train {arch} step: {1e3 * step_s:.1f} ms (median of "
          f"{len(times) - 1}, host clock, each step ends in a copy of its "
          f"loss), {b * seq / step_s:.0f} tokens/s, model "
          f"{model / 1e12:.2f} TFLOP a step ({executed / 1e12:.2f} executed "
          f"with remat), {model / step_s / 1e12:.1f} TFLOP/s, "
          f"{model / step_s / PEAK_BF16:.3f} of the bf16 peak; losses "
          f"{[round(x, 4) for x in losses]}")
    flops_against_cell(arch, cfg, b, seq, model, executed)
    check(all(np.isfinite(losses)), f"{arch}: a non-finite loss")
    check(peak < 80e9, f"{arch}: peak device memory {peak / 1e9:.1f} GB")
    for name in spec["kernels"]:
        check(launches[name] > 0, f"the {arch} train path never launched "
                                  f"{name}")
    batch = pipe.batch_at(FAMILY_TRAIN_STEPS)
    if cfg.is_moe:
        moe_aux_check(arch, cfg, params, step_fn(params, opt, batch)[2],
                      batch)
        moe_layer_split(arch, cfg, params, b, seq)
    _profile(f"{arch} train step ({b} x {seq}, {cfg.n_layers} layers)",
             lambda: float(step_fn(params, opt, batch)[2]["loss"]), 1)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_aux_check(arch, cfg, params, metrics, batch):
    """The load-balancing loss is in the logged loss: the train step's loss
    on ``batch`` equals ``forward_train``'s xent + 0.01 * aux on the same
    params, with aux > 0."""
    import math
    import torch
    from repro_torch.models import lm
    with torch.no_grad():
        total, m = lm.forward_train(
            params, cfg, {k: torch.as_tensor(v).cuda()
                          for k, v in batch.items()}, xent_chunk=512)
    logged, xent, aux = float(metrics["loss"]), float(m["xent"]), \
        float(m["aux"])
    print(f"train {arch}: logged loss {logged:.6f} = xent {xent:.6f} + "
          f"0.01 x aux {aux:.6f} (forward_train on the same params and "
          f"batch: {float(total):.6f}); aux {aux / cfg.n_layers:.4f} a layer"
          f" (1.0 at a uniform routing)")
    check(aux > 0, f"{arch}: the MoE aux loss is {aux}")
    check(math.isclose(logged, xent + 0.01 * aux, rel_tol=1e-5),
          f"{arch}: the logged loss {logged} is not xent + 0.01 aux "
          f"{xent + 0.01 * aux}")


def moe_layer_split(arch, cfg, params, b, s):
    """Where an MoE layer's time goes in the train step: the device time
    (sum of its kernels, ``torch.profiler``) of one layer's forward and
    backward at the step's shape, beside that of its three expert products
    alone on rows of the same (E, G_count * C, D) shape; the rest is the
    routing (top-k, positions, the gathers both ways) and the combine."""
    import math
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers
    dt = getattr(torch, cfg.compute_dtype)
    p = {k: v[0].detach().requires_grad_()
         for k, v in params["layers"]["moe"].items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda",
                    dtype=dt).requires_grad_()
    groups = b * s // min(s, layers.MOE_GROUP)
    g = b * s // groups
    cap = max(int(math.ceil(g * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)), 4)
    xe = torch.randn((cfg.n_experts, groups * cap, cfg.d_model),
                     generator=gen, device="cuda",
                     dtype=dt).requires_grad_()

    def layer():
        out, aux = layers.moe_forward(p, x, cfg)
        torch.autograd.grad((out, aux), [x, *p.values()],
                            (torch.ones_like(out), torch.ones_like(aux)))

    def products():
        w = [p[k] for k in ("w_gate", "w_up", "w_down")]
        h = F.silu(torch.bmm(xe, w[0].to(dt))) * torch.bmm(xe, w[1].to(dt))
        ye = torch.bmm(h, w[2].to(dt))
        torch.autograd.grad(ye, [xe, *w], torch.ones_like(ye))

    whole = sum(kernel_device_ms(layer).values())
    prods = sum(kernel_device_ms(products).values())
    print(f"train {arch}: one MoE layer's forward and backward at "
          f"{b} x {s} tokens ({groups} groups, {cap} slots an expert in "
          f"each): "
          f"{whole:.3f} ms of device time, of which its expert products "
          f"{prods:.3f} ms and the routing and combine {whole - prods:.3f} "
          f"ms; x {cfg.n_layers} layers (remat runs each forward twice)")
    return whole, prods


def phase_train_crash(arch, tmp):
    """``arch`` at its published widths and the depth of
    :data:`CRASH_CUTS`, 4 x 512 tokens (whisper 448), through the
    launcher's code path with a forced crash against a fault-free run
    (:func:`crash_then_replay`); returns the path's launch counts."""
    import torch
    from repro_torch.configs import get_config
    cut, extra = CRASH_CUTS[arch]
    cfg = dataclasses.replace(get_config(arch), **cut)
    run = crash_then_replay(cfg, ["--arch", arch] + CRASH_ARGS + extra,
                            CRASH_STEP, tmp,
                            f"{arch} x {cfg.n_layers} layers",
                            FAMILY_TRAIN[arch]["kernels"])
    print(f"train {arch} x {cfg.n_layers} layers checkpoints: "
          f"{run['ckpt_bytes'] / 1e9:.2f} GB each; saves "
          f"{[round(x, 2) for x in run['saves']]} s, restores "
          f"{[round(x, 2) for x in run['restores']]} s")
    launches = run["launches"]
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 9b: command-r-plus-104b's gradient at one layer
# ---------------------------------------------------------------------------

#: command-r-plus-104b at its published widths and one layer (the parallel
#: block and the tied 256000 x 12288 embedding): 4.72 B params, 18.9 GB in
#: fp32.  With AdamW's out-of-place state (~28 bytes a parameter) a step
#: would need ~132 GB, the tied embedding alone 88.1 GB: no training step
#: fits one 80 GB card, so the phase runs the gradient (params, their fp32
#: gradients and the bf16 casts).  Global batch 4 x 2048 tokens
GRAD_ARCH = "command-r-plus-104b"
GRAD_SPEC = dict(layers=1, batch=4, seq=2048,
                 kernels=("flash_attention", "flash_attention_bwd"))
GRAD_CALLS = 2   # the first warms up
ADAMW_BYTES_PER_PARAM = 28


def phase_grad(arch=GRAD_ARCH):
    """``distributed.steps.make_grad_fn`` of ``arch`` at its published
    widths and the depth and batch of :data:`GRAD_SPEC`: fp32 params drawn
    a layer at a time on the card by ``lm.init_params``, bf16 compute,
    :data:`GRAD_CALLS` calls on one seeded batch.  The loss and every
    gradient leaf must be finite, every leaf nonzero (the loss reaches
    each), and both flash kernels launched; prints the last call's ms,
    the peak device memory and the launches, and why no AdamW step
    follows.  Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.distributed.steps import make_grad_fn
    from repro_torch.models import lm
    from repro_torch.tree import flatten
    spec = GRAD_SPEC
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=spec["layers"])
    b, seq = spec["batch"], spec["seq"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for _, t in flatten(params))
    batch = {k: torch.as_tensor(v).cuda() for k, v in SyntheticTokenPipeline(
        DataConfig(b, seq, seed=0), cfg).batch_at(0).items()}
    grads_of = make_grad_fn(cfg)
    counted = _zero_launches()
    times, losses, grads = [], [], None
    for _ in range(GRAD_CALLS):
        grads = None     # the previous call's gradients go first
        t0 = time.perf_counter()
        loss, grads = grads_of(params, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    leaves = flatten(grads)
    bad = ["/".join(p) for p, g in leaves if not bool(torch.isfinite(g).all())]
    zero = ["/".join(p) for p, g in leaves if not bool((g != 0).any())]
    model = 3 * forward_flops(cfg, b, seq)
    emb = cfg.vocab_size * cfg.d_model
    print(f"grad {arch}: published widths (d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.block_type} block, tied embedding), "
          f"depth {cfg.n_layers} of {full.n_layers}, {n_params / 1e9:.3f} B "
          f"params in fp32, bf16 compute, global batch {b} x {seq}; "
          f"gradient call {1e3 * times[-1]:.1f} ms (host clock, the last of "
          f"{GRAD_CALLS}, ending in a copy of its loss), "
          f"{b * seq / times[-1]:.0f} tokens/s, model {model / 1e12:.2f} "
          f"TFLOP, {model / times[-1] / PEAK_BF16:.3f} of the bf16 peak; "
          f"losses {[round(x, 4) for x in losses]}; peak device memory "
          f"{peak / 1e9:.2f} GB; {len(leaves)} gradient leaves, "
          f"{len(bad)} not finite, {len(zero)} all zero; launches "
          f"{launches}")
    print(f"grad {arch}: no AdamW step follows: a step takes ~"
          f"{ADAMW_BYTES_PER_PARAM} bytes a parameter (fp32 params, "
          f"gradients, mu, nu and the update's new params, mu and nu), "
          f"{n_params * ADAMW_BYTES_PER_PARAM / 1e9:.1f} GB here; the tied "
          f"embedding alone ({emb / 1e9:.2f} B params) "
          f"{emb * ADAMW_BYTES_PER_PARAM / 1e9:.1f} GB, past the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} "
          f"GiB")
    check(all(np.isfinite(losses)), f"{arch}: a non-finite loss {losses}")
    check(not bad, f"{arch}: non-finite gradient leaves {bad}")
    check(not zero, f"{arch}: gradient leaves the loss reaches are all zero: "
                    f"{zero}")
    check(peak < 80e9, f"{arch}: peak device memory {peak / 1e9:.1f} GB")
    for name in spec["kernels"]:
        check(launches[name] > 0, f"the {arch} gradient path never launched "
                                  f"{name}")
    del params, grads, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 9c: every family against the port's CPU path at published widths
# ---------------------------------------------------------------------------

#: text tokens of the reference batch: one row, a prompt bucket (the
#: engine's prefill shape); cut down to REF_MIN_TOKENS only where the host
#: would not hold the CPU side at REF_TOKENS
REF_TOKENS = 256
REF_MIN_TOKENS = 128
REF_SEED = 0
#: the port's fp32 limits: the logits (atol, rtol), the loss (relative) and
#: each gradient leaf, |g_card - g_cpu| <= REF_GRAD_RTOL |g_cpu| in the
#: 2-norm; a leaf whose gradient is 0 in exact arithmetic
#: (:func:`zero_gradient_leaves`) <= REF_GRAD_FLOOR |G_cpu|, G the whole
#: gradient: one fp32 rounding of it
REF_LOGITS_TOL = dict(atol=2e-4, rtol=2e-4)
REF_LOSS_RTOL = 2e-4
REF_GRAD_RTOL = 1e-3
REF_GRAD_FLOOR = 1e-7
#: an MoE token whose top-k experts differ is a near-tie when the CPU's gap
#: between its k-th and (k+1)-th router probabilities is at most this
ROUTE_TIE_GAP = 1e-5
def reference_configs(tiny=False):
    """``configs.all_configs(tiny=)`` (keyed by module name) at the smallest
    depth that holds each layer kind of the family once, fp32 params and
    compute: one layer, but recurrentgemma's ``rec_per_attn`` recurrent
    layers and its attention layer (one super block) and whisper-small's
    one encoder and one decoder layer."""
    from repro_torch.configs import all_configs
    out = {}
    for name, cfg in all_configs(tiny=tiny).items():
        cut = (dict(n_layers=cfg.rec_per_attn + 1) if cfg.rglru else
               dict(n_layers=1, encoder_layers=1) if cfg.is_encdec else
               dict(n_layers=1))
        out[name] = dataclasses.replace(cfg, param_dtype="float32",
                                        compute_dtype="float32", **cut)
    return out


def reference_batch(cfg, tokens):
    """One seeded row of ``tokens`` text tokens (the pipeline's batch 0,
    with its frames or image embeddings)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    return SyntheticTokenPipeline(DataConfig(1, tokens, seed=REF_SEED),
                                  cfg).batch_at(0)


def _on(params, batch):
    import torch
    from repro_torch.tree import flatten
    dev = flatten(params)[0][1].device
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def reference_logits(params, cfg, batch, pos):
    """``lm.prefill``'s fp32 logits (1, V) at text position ``pos`` of the
    one-row ``batch`` (its whole length: the engine's prefill shape), on the
    params' device, and the MoE routing of that call."""
    import torch
    from repro_torch.models import lm
    on = _on(params, batch)
    inputs = {k: v for k, v in on.items()
              if k in ("tokens", "frames", "image_embeds")}
    s = cfg.n_image_tokens + on["tokens"].shape[1]
    last = torch.tensor([cfg.n_image_tokens + pos], device=on["tokens"].device)
    with torch.no_grad():
        (logits, _), log = _moe_logged(lambda: lm.prefill(
            params, cfg, inputs, s, last_idx=last))
    return logits, log


def reference_run(params, cfg, batch):
    """One side of the reference: :func:`reference_logits` at the last text
    position and ``make_grad_fn``'s loss and gradients (a tree on the
    params' device), with the MoE routing of both calls (the gradient's
    forward logs each layer twice: remat runs it again in the backward) and
    each part's seconds."""
    import torch
    from repro_torch.distributed.steps import make_grad_fn
    pos = batch["tokens"].shape[1] - 1
    t0 = time.perf_counter()
    logits, routes = reference_logits(params, cfg, batch, pos)
    (loss, grads), log = _moe_logged(
        lambda: make_grad_fn(cfg)(params, _on(params, batch)))
    loss = float(loss)
    if logits.is_cuda:
        torch.cuda.synchronize()
    return {"pos": pos, "logits": logits, "loss": loss, "grads": grads,
            "routes": routes + log, "seconds": time.perf_counter() - t0}


def route_check(card_routes, cpu_routes, label):
    """Each MoE call's routing, card against CPU, token by token: its top-k
    expert set and its kept (token, choice) pairs.  A token whose expert
    set differs is a near-tie where the CPU's gap between its k-th and
    (k+1)-th router probabilities is at most :data:`ROUTE_TIE_GAP`, else
    a fault; a token whose kept pairs alone differ must come after a
    differing token of its dispatch group (capacity passes down the group
    in token order), else a fault.  Raises on a fault; returns the
    near-ties [(call, token, gap)] and the (tokens,) mask of the tokens
    whose routing agreed in every call (None without MoE layers)."""
    import torch.nn.functional as F
    check(len(card_routes) == len(cpu_routes),
          f"{label}: {len(card_routes)} MoE calls on the card, "
          f"{len(cpu_routes)} on the CPU")
    ties, faults, agreed = [], [], None
    for call, (a, b) in enumerate(zip(card_routes, cpu_routes)):
        probs = b["probs"].cpu()
        e = probs.shape[-1]
        ea, eb = a["experts"].cpu(), b["experts"].cpu()
        k, g = eb.shape[-1], eb.shape[1]
        ha, hb = F.one_hot(ea, e), F.one_hot(eb, e)
        chose = (ha.sum(-2) != hb.sum(-2)).any(-1)                # (Gc, G)
        kept = ((ha * a["keep"].cpu()[..., None]).sum(-2)
                != (hb * b["keep"].cpu()[..., None]).sum(-2)).any(-1)
        top = probs.sort(-1, descending=True).values
        gap = top[..., k - 1] - top[..., min(k, e - 1)]
        before = chose.int().cumsum(-1) - chose.int() > 0
        for gi, t in chose.nonzero().tolist():
            item = (call, gi * g + t, float(gap[gi, t]))
            (ties if item[2] <= ROUTE_TIE_GAP else faults).append(item)
        for gi, t in (kept & ~chose & ~before).nonzero().tolist():
            faults.append((call, gi * g + t, None))
        ok = ~(chose | kept).reshape(-1)
        agreed = ok if agreed is None else agreed & ok
    for call, token, gap in ties:
        print(f"  {label}: MoE near-tie in call {call} at token {token}: "
              f"the CPU's gap {gap:.3g} <= {ROUTE_TIE_GAP}")
    check(not faults, f"{label}: the card's MoE routing differs from the "
                      f"CPU's beyond a near-tie at (call, token, gap) "
                      f"{faults[:8]}")
    return ties, agreed


def zero_gradient_leaves(cfg):
    """The leaves whose gradient is 0 in exact arithmetic: the
    encoder-decoder's cross-attention q/k/v biases, which it does not add
    (JAX adds none there: 0 on both sides), and its encoder's key bias (no
    rope in the bidirectional encoder, so q.bk shifts each softmax row by a
    constant: its fp32 gradient is rounding, ~1e-11 of the whole
    gradient's norm at whisper-small's widths, and the card's and the
    CPU's part by more than its size)."""
    if not (cfg.is_encdec and cfg.use_bias):
        return set()
    return {"enc_layers/attn/bk", "layers/xattn/bq", "layers/xattn/bk",
            "layers/xattn/bv"}


def leaf_error(got, want, chunk=1 << 26):
    """(|got - want|, |want|) in the 2-norm, summed in fp64 a chunk at a
    time on ``got``'s device: ``want`` (the CPU's) goes there a chunk at a
    time, in its own dtype through a pinned buffer when ``got`` is on the
    card, so that neither side holds a second copy of a leaf."""
    import torch
    g, w = got.reshape(-1), want.reshape(-1)
    stage = (torch.empty(min(chunk, w.numel()), dtype=w.dtype,
                         pin_memory=True)
             if g.is_cuda and not w.is_cuda and w.numel() else None)
    diff = norm = 0.0
    for i in range(0, g.numel(), chunk):
        wc = w[i:i + chunk]
        if stage is not None:
            wc = stage[:wc.numel()].copy_(wc).to(g.device, non_blocking=True)
        wc = wc.to(g.device).double()
        # the float()s wait for the chunk, so the buffer is free again
        diff += float((g[i:i + chunk].double() - wc).square().sum())
        norm += float(wc.square().sum())
    return diff ** 0.5, norm ** 0.5


def compare_reference(cfg, card, cpu, logits_at):
    """The card side against the CPU side (:func:`reference_run`): the MoE
    routing first (:func:`route_check`); then the logits at
    :data:`REF_LOGITS_TOL`, the loss at :data:`REF_LOSS_RTOL` and each
    gradient leaf at :data:`REF_GRAD_RTOL`, a leaf at a time (those of
    :func:`zero_gradient_leaves`, and any the CPU gives 0, at
    :data:`REF_GRAD_FLOOR`: the CPU's gradient and the difference).  After
    a near-tie only the logits are held, at the last position whose routing
    agreed in every call (one MoE layer: a token's routing reaches only its
    own output); ``logits_at(pos)`` gives both sides' logits there.  Raises
    on a fault; returns the record."""
    import torch
    from repro_torch.tree import flatten
    label = cfg.name
    ties, agreed = route_check(card["routes"], cpu["routes"], label)
    pos, cl, pl = card["pos"], card["logits"], cpu["logits"]
    if ties:
        ok = agreed.nonzero().reshape(-1)
        check(ok.numel() > 0, f"{label}: no token's routing agreed")
        pos = int(ok[-1])
        if pos != card["pos"]:
            cl, pl = logits_at(pos)
    cl, pl = cl.float().cpu(), pl.float()
    logits_err = float((cl - pl).abs().max())
    rec = {"family": label, "near_ties": ties, "logits_pos": pos,
           "logits_err": logits_err}
    check(bool(torch.allclose(cl, pl, **REF_LOGITS_TOL)),
          f"{label}: the card's logits at position {pos} differ from the "
          f"CPU's by {logits_err:.3g} (atol, rtol "
          f"{REF_LOGITS_TOL['atol']})")
    if ties:
        print(f"  {label}: {len(ties)} MoE near-tie(s): held to the logits "
              f"at position {pos}, the last whose routing agreed; the loss "
              f"and gradients are not compared")
        return rec
    rec["loss_err"] = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    check(rec["loss_err"] <= REF_LOSS_RTOL,
          f"{label}: the card's loss {card['loss']} against the CPU's "
          f"{cpu['loss']}: relative {rec['loss_err']:.3g}")
    errs = []
    for (path, g), (path_w, w) in zip(flatten(card["grads"]),
                                      flatten(cpu["grads"])):
        check(path == path_w and g.shape == w.shape,
              f"{label}: gradient trees differ at {path}, {path_w}")
        errs.append(("/".join(path), *leaf_error(g, w)))
    floor = REF_GRAD_FLOOR * sum(n * n for _, _, n in errs) ** 0.5
    zero = zero_gradient_leaves(cfg)
    held = [(name, diff / norm) for name, diff, norm in errs
            if name not in zero and norm > 0]
    rec["grad_leaf"], rec["grad_err"] = max(held, key=lambda x: x[1])
    rec["grad_leaves"] = len(errs)
    rec["grad_floor"] = floor
    rec["floor_leaves"] = {name: (diff, norm) for name, diff, norm in errs
                           if name in zero or norm == 0}
    bad = [(name, diff, norm) for name, diff, norm in errs
           if (max(diff, norm) > floor if name in rec["floor_leaves"]
               else diff > REF_GRAD_RTOL * norm)]
    check(not bad, f"{label}: gradient leaves past the limit "
                   f"({REF_GRAD_RTOL} |g_cpu|; {floor:.3g} for "
                   f"{sorted(rec['floor_leaves'])}): (leaf, "
                   f"|g_card - g_cpu|, |g_cpu|) {bad[:8]}")
    return rec


def reference_family(cfg, params, batch):
    """Both sides of one family: ``params`` on their device (the card's
    kernels) first, then a host copy of them on the CPU (the plain
    versions), which must launch no kernel; then :func:`compare_reference`.
    Returns its record with each side's seconds and the first side's
    launches."""
    from repro_torch.tree import tree_map
    counted = _zero_launches()
    card = reference_run(params, cfg, batch)
    launches = {name: fn.launches for name, fn in counted.items()}
    t0 = time.perf_counter()
    host = tree_map(lambda t: t.detach().cpu(), params)
    copy_s = time.perf_counter() - t0
    cpu = reference_run(host, cfg, batch)
    check(all(fn.launches == launches[n] for n, fn in counted.items()),
          f"{cfg.name}: the CPU side launched a kernel")
    t0 = time.perf_counter()
    rec = compare_reference(cfg, card, cpu, lambda pos: (
        reference_logits(params, cfg, batch, pos)[0],
        reference_logits(host, cfg, batch, pos)[0]))
    rec.update(launches=launches, card_s=card["seconds"], copy_s=copy_s,
               cpu_s=cpu["seconds"], compare_s=time.perf_counter() - t0)
    return rec


def _host_need(cfg, tokens, n_bytes, largest):
    """Host bytes of the CPU side: the params' host copy, their gradients,
    a second copy of the largest leaf (a tied embedding's two gradients
    before they are summed), fp32 activations a token (a few of the
    logits' rows and of the layer's widths) and 2 GB to spare."""
    ff = cfg.d_ff * max(1, cfg.top_k)
    per_token = 4 * (4 * cfg.vocab_size + 32 * cfg.d_model + 8 * ff)
    return 2 * n_bytes + largest + tokens * per_token + 2e9


def reference_tokens(cfg, n_bytes, largest):
    """:data:`REF_TOKENS`, or :data:`REF_MIN_TOKENS` where the host's
    available memory would not hold the CPU side at it
    (:func:`_host_need`); fails where it would not hold it at all."""
    avail = _meminfo("MemAvailable")
    need = _host_need(cfg, REF_TOKENS, n_bytes, largest)
    if need <= avail:
        return REF_TOKENS
    low = _host_need(cfg, REF_MIN_TOKENS, n_bytes, largest)
    print(f"  the CPU side needs ~{need / 1e9:.1f} GB of host memory at "
          f"{REF_TOKENS} tokens, {low / 1e9:.1f} GB at {REF_MIN_TOKENS}; "
          f"{avail / 1e9:.1f} GB available: the batch is cut to "
          f"{REF_MIN_TOKENS} tokens")
    check(low <= avail, f"the host cannot hold the CPU side of {cfg.name} "
                        f"(~{low / 1e9:.1f} GB)")
    return REF_MIN_TOKENS


def phase_model_reference():
    """Every family of ``configs.all_configs()`` at its published widths and
    :func:`reference_configs`' depth, fp32 params and compute (TF32 off),
    weights drawn on the card by ``lm.init_params`` from a seed and copied
    to the host: ``lm.prefill``'s logits and ``make_grad_fn``'s loss and
    gradients on one seeded row of :data:`REF_TOKENS` tokens, on the card
    (the hand-written kernels in fp32: B2's forward and SIMT backward, B3,
    B4) against the same port functions on the CPU (the plain versions),
    held by :func:`compare_reference`.  Prints each family's line (depth,
    tokens, the largest logit, loss and gradient error and its leaf,
    near-ties, seconds) and the host's memory.  Returns the card sides'
    launch counts."""
    import torch
    from repro_torch.models import lm
    from repro_torch.tree import flatten
    print(f"model reference: host memory {_meminfo('MemTotal') / 1e9:.1f} "
          f"GB, {_meminfo('MemAvailable') / 1e9:.1f} GB available; torch "
          f"CPU threads {torch.get_num_threads()}")
    total = None
    for cfg in reference_configs().values():
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        params = lm.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(REF_SEED))
        leaves = [t for _, t in flatten(params)]
        n_bytes = sum(t.numel() * t.element_size() for t in leaves)
        tokens = reference_tokens(
            cfg, n_bytes, max(t.numel() * t.element_size() for t in leaves))
        rec = reference_family(cfg, params, reference_batch(cfg, tokens))
        launches = rec["launches"]
        kernels = (("wkv6", "wkv6_bwd") if cfg.rwkv else
                   ("flash_attention", "flash_attention_bwd")
                   + (("lru_scan", "lru_scan_bwd") if cfg.rglru else ()))
        for name in kernels:
            check(launches[name] > 0, f"the card side of {cfg.name} never "
                                      f"launched {name}")
        total = (launches if total is None else
                 {n: total[n] + launches[n] for n in total})
        depth = (f"{cfg.encoder_layers} + {cfg.n_layers}" if cfg.is_encdec
                 else str(cfg.n_layers))
        tail = ("; loss and gradients not compared (near-tie)"
                if rec["near_ties"] else
                f", loss {rec['loss_err']:.3g} (relative), largest gradient "
                f"error {rec['grad_err']:.3g} (relative, "
                f"{rec['grad_leaves']} leaves) at {rec['grad_leaf']}"
                + (f"; held to the floor {rec['grad_floor']:.3g}: "
                   + ", ".join(f"{n} {d:.3g} (CPU {w:.3g})"
                               for n, (d, w) in rec["floor_leaves"].items())
                   if rec["floor_leaves"] else ""))
        print(f"model reference {cfg.name}: depth {depth}, "
              f"{sum(t.numel() for t in leaves) / 1e9:.3f} B params, 1 x "
              f"{tokens} tokens"
              + (f" + {cfg.n_image_tokens} image rows" if cfg.n_image_tokens
                 else f" + {cfg.n_frames} frames" if cfg.is_encdec else "")
              + f": logits error {rec['logits_err']:.3g} at position "
              f"{rec['logits_pos']}{tail}; near-ties "
              f"{len(rec['near_ties'])}; seconds: card {rec['card_s']:.1f}, "
              f"host copy {rec['copy_s']:.1f}, CPU {rec['cpu_s']:.1f}, "
              f"compare {rec['compare_s']:.1f}, family "
              f"{time.perf_counter() - t0:.1f}; card launches "
              f"{ {n: c for n, c in launches.items() if c} }")
        del params, leaves, rec
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_train_chaos():
    """Every train-side fault class at the published widths, 2 layers,
    through the launcher's code path and its --chaos-assert, traced
    (``--trace-dir``, ``--trace-dump-on-fault``): the validator finds
    every witness of :data:`CHAOS_SPANS`, and ``profile.json`` counts
    every train-step call but the first.  Its fault trace, store, dumps
    and profile lie in a directory of :func:`shm_dir`, removed at the end.
    Returns the path's launch counts."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=CHAOS_LAYERS)
    # keep=3 commits of params, mu and nu, and the one being written
    root = shm_dir("chaos", 4 * 12 * cfg.param_count())
    try:
        return _train_chaos(cfg, root)
    finally:
        release_shm(root)


def _train_chaos(cfg, tmp):
    from repro_torch.chaos import TRAIN_KINDS, FaultEvent, FaultTrace
    from repro_torch.launch import train as launch
    path = os.path.join(tmp, "chaos_trace.json")
    FaultTrace(events=[FaultEvent(step=st, kind=k, targets=t, duration=d,
                                  seed=sd)
                       for st, k, t, d, sd in CHAOS_EVENTS]).save(path)
    trace_dir = os.path.join(tmp, "chaos_trace")
    args = launch.build_parser().parse_args(CHAOS_ARGS + [
        "--chaos-trace", path, "--ckpt-dir", os.path.join(tmp, "chaos"),
        "--inject-mtbf-steps", "1e9", "--trace-dir", trace_dir,
        "--trace-dump-on-fault"])
    built = launch.build(cfg, args)
    built["injector"].fail_steps = CHAOS_REPEAT
    coord = built["coord"]
    profiled, calls = coord.train_step, [0]

    def counted_step(*a):
        calls[0] += 1
        return profiled(*a)

    coord.train_step = counted_step
    ckpt_bytes = tree_bytes({"params": coord.params, "opt": coord.opt_state})
    counted = _zero_launches()
    t0 = time.perf_counter()
    res = _launch_train(cfg, args, built)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    rep, chaos = res["report"], res["chaos"]
    print(f"train chaos olmo-1b x {CHAOS_LAYERS} layers: applied "
          f"{dict(chaos.applied_by_kind)}, and {CHAOS_REPEAT} host crashes "
          f"by the injector; failures {rep.failures}, restores "
          f"{rep.restores}, backoff {rep.backoff_steps:.0f} steps, ckpt "
          f"fallbacks {rep.ckpt_fallbacks}, nan "
          f"rollbacks {rep.nan_rollbacks}, enospc retries "
          f"{rep.enospc_retries}, partitions {rep.partitions}, slowdowns "
          f"{rep.slowdowns}, index violations {rep.index_violations}; phase "
          f"{wall:.1f} s; launches {launches}")
    check(set(chaos.applied_by_kind) == set(TRAIN_KINDS),
          f"the trace fired {sorted(chaos.applied_by_kind)}, not every "
          f"train-side class")
    check(rep.ckpt_fallbacks >= 1 and rep.enospc_retries >= 1
          and rep.nan_rollbacks == 1 and rep.partitions == 1
          and rep.slowdowns == 1 and rep.failures == 4
          and rep.backoff_steps > 0,
          "a fault class's recovery path did not run")
    for name in ("flash_attention", "flash_attention_bwd"):
        check(launches[name] > 0, f"the chaos train path never launched "
                                  f"{name}")
    saves = span_seconds(res["obs"].recorder, "ckpt.save")
    print(f"train chaos checkpoints: {ckpt_bytes / 1e9:.3f} GB each "
          f"(params, mu, nu, step); saves {[round(x, 2) for x in saves]} s")
    validate_trace(trace_dir, CHAOS_SPANS, "train chaos")
    prof_path = os.path.join(trace_dir, "profile.json")
    check(os.path.exists(prof_path), "the traced chaos run wrote no "
                                     "profile.json")
    with open(prof_path) as f:
        prof = json.load(f)[0]
    print(f"train chaos profile.json: {prof['calls']} steady calls of "
          f"{calls[0]} train-step calls, first call "
          f"{prof['compile_s']:.2f} s, mean {1e3 * prof['mean_s']:.1f} ms, "
          f"{prof['flops'] / 1e12:.3f} TFLOP and "
          f"{prof['bytes_accessed'] / 1e9:.2f} GB a step (capture_cost)")
    check(prof["calls"] == calls[0] - 1,
          f"profile.json counts {prof['calls']} calls, not "
          f"{calls[0]} - 1")
    return launches


# ---------------------------------------------------------------------------
# phase 7b: the cross-pod cluster; the exchange round at full width
# ---------------------------------------------------------------------------

def _timed(fn):
    """``fn()``'s result, device ms (CUDA events around the call) and host
    ms (the clock around the call and a synchronise)."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b), 1e3 * (time.perf_counter() - t0)


def _split_text(parts):
    return "; ".join(f"{k} {ev:.2f} ms events / {host:.2f} ms host"
                     for k, (ev, host) in parts.items())


def round_split(cfg, args, cluster):
    """One more round on the healed cluster's pods through the calls a
    round makes, each timed (:func:`_timed`): the pods' gradients
    (``make_grad_fn``, as the cluster makes them), the exchange
    (``PodGradientExchange.round``, from the cluster's residuals) without
    and with the agreed update's fingerprint, the pods' AdamW updates, and
    the pods' fingerprints as the cluster takes them (``tree_digests``, a
    thread a pod) and one pod's alone (``tree_digest``).  The pods'
    fingerprints must agree.  Returns the parts."""
    import torch
    from repro_torch.distributed.steps import make_grad_fn
    from repro_torch.ft import PodGradientExchange, tree_digest, tree_digests
    from repro_torch.optim import adamw_update
    n = len(cluster.params)
    grad_fn = make_grad_fn(cfg, q_chunk=min(1024, args.seq_len),
                           xent_chunk=512)
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             cluster.pipeline.batch_at(cluster.applied).items()}
    ex = PodGradientExchange(n)
    for p in range(n):
        ex.set_residual(p, cluster.exchange.residuals[p])
    parts = {}

    def part(name, fn):
        out, ev, host = _timed(fn)
        parts[name] = (ev, host)
        return out

    grads = part(f"gradients ({n} pods)", lambda: [
        grad_fn(p, batch)[1] for p in cluster.params])
    part("exchange round without the fingerprint",
         lambda: ex.round(grads, with_fingerprint=False))
    res = part("exchange round with the update's fingerprint",
               lambda: ex.round(grads))
    del grads
    new = part(f"update ({n} pods)", lambda: [
        adamw_update(cluster.opt_cfg, p, res.avg, o)[0]
        for p, o in zip(cluster.params, cluster.opt)])
    fps = part(f"fingerprints ({n} pods, a thread each)",
               lambda: tree_digests(new))
    one = part("fingerprint (1 pod)", lambda: tree_digest(new[0]))
    check(res.quorum == tuple(range(n)) and len(set(fps)) == 1
          and fps[0] == one, "the healed pods' updated params differ")
    return parts


def phase_cluster():
    """The cross-pod cluster through the launcher's ``--pods`` path
    (``launch.train.cluster_main``) at the published widths and
    :data:`CHAOS_LAYERS` layers, traced, under a fixed trace
    (:data:`CLUSTER_EVENTS`) and the launcher's ``--chaos-assert`` (every
    step, 0 split-brain divergences, 0 index violations, finite losses,
    all pods bit-identical to a fault-free reference cluster); then the
    counts, the compression ratio, the kernels and the validator's
    witnesses; one more round's split (:func:`round_split`); each
    commit's seconds and bytes.  Both clusters' stores, the trace and the
    dumps lie in a directory of :func:`shm_dir`, removed at the end.
    Returns the path's launch counts."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=CHAOS_LAYERS)
    # params, mu, nu and the residual: keep=3 commits and the one being
    # written, in the run's store and the reference's beside it
    root = shm_dir("cluster", 2 * 4 * 16 * cfg.param_count())
    try:
        return _cluster(cfg, root)
    finally:
        release_shm(root)


def _cluster(cfg, tmp):
    import torch
    from repro_torch.chaos import FaultEvent, FaultTrace
    from repro_torch.launch import train as launch
    path = os.path.join(tmp, "cluster_trace.json")
    FaultTrace(events=[FaultEvent(step=st, kind=k, targets=t, duration=d,
                                  seed=sd)
                       for st, k, t, d, sd in CLUSTER_EVENTS]).save(path)
    trace_dir = os.path.join(tmp, "cluster_trace")
    args = launch.build_parser().parse_args(CLUSTER_ARGS + [
        "--chaos-trace", path, "--trace-dir", trace_dir,
        "--ckpt-dir", os.path.join(tmp, "run")])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counted = _zero_launches()
    t0 = time.perf_counter()
    try:
        res = launch.cluster_main(cfg, args)
    except SystemExit as e:
        raise SmokeFailure(f"cluster launcher: {e}") from None
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    rep, cluster = res["report"], res["cluster"]
    ref_rep = res["reference_report"]
    ratio = cluster.exchange.compression_ratio
    print(f"cluster olmo-1b x {CHAOS_LAYERS} layers, {args.pods} pods, "
          f"{args.global_batch} x {args.seq_len}: {rep.steps_completed} "
          f"steps in {rep.rounds} rounds, partitions {rep.partitions}, "
          f"heals {rep.heals}, catchups {rep.catchups}, parked pod-rounds "
          f"{rep.parked_pod_rounds}, disk-full {rep.disk_full_events}, "
          f"enospc retries {rep.enospc_retries}, checkpoints "
          f"{rep.checkpoints} (reference {ref_rep.checkpoints}), "
          f"compression {ratio}x, peak device memory {peak / 1e9:.2f} GB; "
          f"phase {wall:.1f} s (the run {res['wall_s']:.1f} s, then the "
          f"reference); launches {launches}")
    check(rep.partitions == 1 and rep.heals >= 1 and rep.catchups >= 1
          and rep.parked_pod_rounds >= 3 and rep.enospc_retries >= 1,
          "the cluster's partition, heal or ENOSPC path did not run")
    check(ratio == 4.0, f"compression ratio {ratio}, not 4.0")
    for name in ("flash_attention", "flash_attention_bwd"):
        check(launches[name] > 0, f"the cluster path never launched {name}")
    commits = span_seconds(res["obs"].recorder, "crosspod.commit")
    pod_bytes = tree_bytes({"params": cluster.params[0],
                            "opt": cluster.opt[0],
                            "residual": cluster.exchange.residuals[0]})
    print(f"cluster commits: {pod_bytes / 1e9:.3f} GB each (params, mu, nu, "
          f"step, residual); seconds {[round(x, 2) for x in commits]} (host "
          f"copy, np.save, sha1 of every leaf); /dev/shm holds "
          f"{_meminfo('Shmem') / 1e9:.2f} GB")
    validate_trace(trace_dir, CLUSTER_SPANS, "cluster")
    parts = round_split(cfg, args, cluster)
    print(f"cluster round split (the next round, {args.pods} pods): "
          f"{_split_text(parts)}")
    del res, cluster
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_exchange_full():
    """One exchange round at full width: olmo-1b whole, the gradients of
    three 4 x 2048 batches given to ``PodGradientExchange(3).round`` as
    three identical pods (the fast path) and as the three that differ (the
    averaging path).  Gates: every element of each average within its
    leaf's int8 bound of the mean of the pods' fp32 gradients (half a
    quantum a pod plus the residual it carried, averaged, and fp32's
    rounding), and the byte counts 4 : 1.  Prints each part's ms and the
    host GB/s of ``tree_digest``.  Returns the launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.distributed.steps import make_grad_fn
    from repro_torch.ft import PodGradientExchange, tree_digest
    from repro_torch.launch import train as launch
    from repro_torch.optim import compress_int8
    from repro_torch.tree import flatten
    cfg = get_config("olmo-1b")
    b, seq = EXCHANGE_SHAPE
    args = launch.build_parser().parse_args([
        "--global-batch", str(b), "--seq-len", str(seq), "--seed", "0",
        "--device", "cuda"])
    t_phase = time.perf_counter()
    params = launch.seeded_params(cfg, args)
    pipe = SyntheticTokenPipeline(DataConfig(b, seq, seed=0), cfg)
    grad_fn = make_grad_fn(cfg, q_chunk=min(1024, seq), xent_chunk=512)
    counted = _zero_launches()
    grads, parts = [], {}
    for i in range(3):
        batch = {k: torch.as_tensor(v).cuda()
                 for k, v in pipe.batch_at(i).items()}
        g, ev, host = _timed(lambda: grad_fn(params, batch)[1])
        grads.append(g)
        parts[f"gradient {i}"] = (ev, host)
    launches = {name: fn.launches for name, fn in counted.items()}
    del params
    n_bytes = tree_bytes(grads[0])
    for label, pods in (("fast path", [grads[0]] * 3),
                        ("averaging path", grads)):
        # a first round grows the allocator's pools; the second is timed
        PodGradientExchange(3).round(pods, with_fingerprint=False)
        ex = PodGradientExchange(3)
        res, ev, host = _timed(lambda: ex.round(pods, with_fingerprint=False))
        parts[f"{label} round"] = (ev, host)
        check(res.quorum == (0, 1, 2), f"{label}: quorum {res.quorum}")
        check(ex.bytes_sent_int8 * 4 == ex.bytes_sent_fp32,
              f"{label}: {ex.bytes_sent_int8} int8 bytes against "
              f"{ex.bytes_sent_fp32} fp32")
        worst = 0.0
        for (name, avg), *gs in zip(flatten(res.avg),
                                    *(flatten(g) for g in pods)):
            gs = [g for _, g in gs]
            scales = [float(compress_int8(g)[1]) for g in gs]
            mean = sum(g.float() for g in gs) / 3
            # the residuals a fresh exchange carries in are 0
            bound = (sum(scales) / 6
                     + 2.0 ** -20 * max(127 * s for s in scales))
            err = float((avg - mean).abs().max())
            worst = max(worst, err / bound)
            check(err <= bound, f"{label} {name}: |avg - mean| {err:.3g} "
                                f"> the int8 bound {bound:.3g}")
        print(f"exchange {label} at full width ({n_bytes / 1e9:.2f} GB of "
              f"fp32 gradient a pod): worst |avg - mean| / bound "
              f"{worst:.3f}; int8 bytes {ex.bytes_sent_int8}, fp32 bytes "
              f"{ex.bytes_sent_fp32}")
    # the agreed update's fingerprint, as round(with_fingerprint=True)
    # takes it
    _, ev, host = _timed(lambda: tree_digest(res.avg))
    parts["tree_digest of the average"] = (ev, host)
    print(f"exchange tree_digest at full width: {n_bytes / 1e9:.2f} GB in "
          f"{host / 1e3:.2f} s host, {n_bytes / host / 1e6:.2f} GB/s")
    del res, ex
    print(f"exchange parts at full width: {_split_text(parts)}; phase "
          f"{time.perf_counter() - t_phase:.1f} s; launches {launches}")
    del grads
    gc.collect()
    torch.cuda.empty_cache()
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
    # B3's gradient: JAX differentiates its chunked jnp form
    # (src/repro/models/rwkv6.py:95)
    "wkv6_bwd": ("src/repro_torch/kernels/csrc/wkv6.cu",
                 "src/repro/kernels/rwkv6_scan/kernel.py:27"),
    "lru_scan": ("src/repro_torch/kernels/csrc/lru_scan.cu",
                 "src/repro/kernels/rglru_scan/kernel.py:20"),
    # B4's gradient: JAX differentiates its associative scan
    # (src/repro/models/rglru.py:75)
    "lru_scan_bwd": ("src/repro_torch/kernels/csrc/lru_scan.cu",
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
    training shape; its D = 256 instance at recurrentgemma-2b's (bf16 on
    the tensor cores, and fp32 on SIMT), granite-moe-1b-a400m's training
    shape (``moe_case``) and granite-20b's MQA group of 48 (``mqa_case``)
    ride along, as do flash_attention's prefill shapes of the decoder-only
    families (``decoder_cases``) and both kernels' cases at
    :data:`TRAIN_DECODERS`' training shapes (``train_cases``).  wkv6_bwd's
    and lru_scan_bwd's records are rwkv6-3b's and recurrentgemma-2b's
    training shapes."""
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
            rec["decoder_cases"] = {
                arch: {k: recs[f"{name}_{arch}"][k] for k in TIMED_KEYS}
                for arch in NEW_DECODERS}
        if name in ("flash_attention", "flash_attention_bwd"):
            rec["train_cases"] = {
                arch: {k: recs[f"{name}_train_{arch}"][k] for k in TIMED_KEYS}
                for arch in TRAIN_DECODERS}
            pre = name + "_"
            rec["multimodal_cases"] = {
                key[len(pre):]: {k: recs[key].get(k) for k in
                                 TIMED_KEYS + ("sk", "causal")}
                for key in recs
                if key.startswith((pre + "whisper", pre + "llava"))}
        if name == "flash_attention_bwd":
            for case in ("d256", "d256_fp32"):
                rec[case + "_case"] = {
                    "window": recs[f"{name}_{case}"]["window"],
                    **{k: recs[f"{name}_{case}"][k] for k in TIMED_KEYS}}
            for case in ("moe", "mqa"):
                rec[case + "_case"] = {k: recs[f"{name}_{case}"][k]
                                       for k in TIMED_KEYS}
        if name == "pairwise_distance":
            rec["large_case"] = {k: recs[name + "_large"][k]
                                 for k in TIMED_KEYS}
            rec["planner_case"] = {k: recs[name + "_planner"][k]
                                   for k in TIMED_KEYS}
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# phase 10: the sharding layer on a one-rank mesh, and two dry-run cells
# ---------------------------------------------------------------------------

#: olmo-1b at full width and depth, 3 steps of 4 x 2048 tokens in two
#: microbatches (so that ``grad_shardings`` places the gradient sum)
MESH_TRAIN_ARGS = ["--arch", "olmo-1b", "--steps", "3", "--global-batch",
                   "4", "--seq-len", "2048", "--accum", "2", "--seed", "0",
                   "--device", "cuda"]
#: the dry run's cells printed here: the dense trained family, and the MoE
#: family's prefill with its experts on ``model``
MESH_DRY_CELLS = (("olmo_1b", "train_4k"), ("granite_moe_1b", "prefill_32k"))


def _mesh_train(cfg, args, mesh):
    """Three steps of the train launcher's step on ``args`` (``mesh``:
    DTensor params, AdamW state and gradient sum on it): the losses, the
    final params' ``tree_digest``, the step times and the launch counts."""
    from repro_torch.ft import tree_digest
    from repro_torch.launch import train as launch
    from repro_torch.tree import flatten
    built = launch.build(cfg, args, mesh=mesh)
    params, opt = built["coord"].params, built["coord"].opt_state
    step_fn, pipe = built["step_fn"], built["pipeline"]
    del built
    counted = _zero_launches()
    losses, times = [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, pipe.batch_at(i))
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    out = {"losses": losses, "digest": tree_digest(params),
           "times": times,
           "launches": {n: fn.launches for n, fn in counted.items()},
           "dtensors": sum(hasattr(t, "placements")
                           for _, t in flatten(params))}
    del params, opt
    return out


def phase_mesh(tmp, card):
    """The sharding layer on the card: olmo-1b trained without a mesh and
    on a one-rank CUDA mesh (``--mesh debug``: DTensor params, AdamW state
    and gradient sum, the steps inside ``use_rules``) from one seed must
    give bit-identical losses and final params, the mesh run launching both
    flash kernels; olmo-1b served with and without the mesh must give the
    same tokens, the mesh's cache keeping ``cache_specs``' placements; then
    two dry-run cells on the 256-rank fake mesh, printed as rows.  Returns
    the mesh runs' launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import params as pshard
    from repro_torch.distributed.sharding import spec_to_placements
    from repro_torch.launch import dryrun
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import destroy_group, make_debug_mesh
    cfg = get_config("olmo-1b")
    parser = launch.build_parser()
    runs = {}
    for label in ("plain", "mesh"):
        args = parser.parse_args(MESH_TRAIN_ARGS + [
            "--ckpt-dir", os.path.join(tmp, f"mesh-{label}")])
        mesh = make_debug_mesh(device="cuda") if label == "mesh" else None
        try:
            runs[label] = _mesh_train(cfg, args, mesh)
        finally:
            if mesh is not None:
                destroy_group()
        gc.collect()
        torch.cuda.empty_cache()
    plain, meshed = runs["plain"], runs["mesh"]
    step_ms = {k: 1e3 * statistics.median(r["times"][1:])
               for k, r in runs.items()}
    print(f"mesh train olmo-1b (16 layers, 4 x 2048 tokens, accum 2): "
          f"losses {meshed['losses']} on the 1x1 mesh, "
          f"{'equal' if meshed['losses'] == plain['losses'] else 'DIFFER'}"
          f" to the mesh-less run's; final params "
          f"{'bit-identical' if meshed['digest'] == plain['digest'] else 'DIFFER'}"
          f" ({meshed['dtensors']} DTensor leaves); step {step_ms['mesh']:.1f}"
          f" ms on the mesh, {step_ms['plain']:.1f} ms without (host clock, "
          f"median of {len(meshed['times']) - 1}; {card}); launches "
          f"{meshed['launches']}")
    check(meshed["dtensors"] > 0, "the mesh run's params are not DTensors")
    check(meshed["losses"] == plain["losses"],
          "olmo-1b's losses on the 1x1 mesh differ from the mesh-less run's")
    check(meshed["digest"] == plain["digest"],
          "olmo-1b's final params on the 1x1 mesh differ from the mesh-less "
          "run's")
    for name in ("flash_attention", "flash_attention_bwd"):
        check(meshed["launches"][name] > 0,
              f"the mesh train path never launched {name}")
    launches = dict(meshed["launches"])

    # serve: the same params and requests without and with the mesh
    argv = serve_args("olmo-1b") + ["--env", "unstable"]
    sargs = lserve.build_parser().parse_args(argv)
    base = lserve.continuous_main(cfg, sargs)
    params = base["params"]
    counted = _zero_launches()
    mesh = make_debug_mesh(device="cuda")
    try:
        res = lserve.continuous_main(cfg, sargs, params=params, mesh=mesh)
        eng = res["engine"]
        specs = pshard.cache_specs(eng.cache, cfg, mesh)
        placed = all(list(v.placements) == spec_to_placements(specs[k], mesh)
                     for k, v in eng.cache.items())
        same = eng.completed == base["engine"].completed
        tm, tb = eng.timing, base["engine"].timing
        print(f"mesh serve olmo-1b (8 requests, 2 x 2 slots, crch, "
              f"unstable): tokens {'equal' if same else 'DIFFER'} to the "
              f"mesh-less run's ({len(eng.completed)} requests); cache "
              f"placements {'those of' if placed else 'NOT those of'} "
              f"cache_specs; {res['tok_s']:.1f} tok/s on the mesh, "
              f"{base['tok_s']:.1f} without; decode "
              f"{1e3 * tm['decode_s'] / max(tm['decode_calls'], 1):.2f} "
              f"ms/step on the mesh, "
              f"{1e3 * tb['decode_s'] / max(tb['decode_calls'], 1):.2f} "
              f"without (host clock; {card})")
        for name, fn in counted.items():
            launches[name] += fn.launches
        check(counted["flash_attention"].launches > 0,
              "the mesh serve path never launched flash_attention")
        check(same, "olmo-1b's served tokens on the 1x1 mesh differ from "
                    "the mesh-less run's")
        check(placed, "the served cache left cache_specs' placements")
        del res, eng
    finally:
        destroy_group()
    del base, params
    gc.collect()
    torch.cuda.empty_cache()

    # two dry-run cells (fake tensors on the host: nothing on the card)
    try:
        for arch, shape in MESH_DRY_CELLS:
            row = dryrun.run_cell(arch, shape, "single")
            check(row["status"] == "ok", f"dry run {arch} {shape}: {row}")
            row["cost"].pop("aten_flops", None)
            print(f"dryrun row: {json.dumps(row)} ({dryrun.fit_check(row)}"
                  f" of the card)")
    finally:
        destroy_group()
    return launches


def empty_dir(path):
    """Remove what ``path`` holds (a phase's checkpoints, once read)."""
    for name in os.listdir(path):
        shutil.rmtree(os.path.join(path, name), ignore_errors=True)


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


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
    # a SIGTERM unwinds through the finally blocks, which remove the
    # directories the run made under /dev/shm and the temporary directory
    signal.signal(signal.SIGTERM, _terminated)
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
    # 6-9. training: olmo-1b at full width with a crash, then every fault
    # class; the recurrent families
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    ledger = WriteLedger()
    torch.use_deterministic_algorithms(True)
    try:
        with ledger.phase("train olmo-1b"):
            by_path["train"] = phase_train(tmp)
        empty_dir(tmp)
        print(f"train done at {time.perf_counter() - t_start:.1f} s")
        with ledger.phase("train chaos", "shm"):
            by_path["train_chaos"] = phase_train_chaos()
        print(f"train chaos done at {time.perf_counter() - t_start:.1f} s")
        # 7b. the cross-pod cluster, then one exchange round at full width
        with ledger.phase("cluster", "shm"):
            by_path["train_cluster"] = phase_cluster()
        print(f"cluster done at {time.perf_counter() - t_start:.1f} s")
        by_path["exchange_full"] = phase_exchange_full()
        print(f"exchange done at {time.perf_counter() - t_start:.1f} s")
        # 8-9. the other families' training: published widths at a cut
        # depth, then a crash run each at reduced depth
        for arch in FAMILY_TRAIN:
            with ledger.phase(f"train {arch}"):
                by_path[f"train_{arch}"] = phase_train_family(arch, tmp)
            print(f"train {arch} done at "
                  f"{time.perf_counter() - t_start:.1f} s")
            if arch not in CRASH_CUTS:
                continue
            with ledger.phase(f"train crash {arch}"):
                by_path[f"train_crash_{arch}"] = phase_train_crash(arch, tmp)
            empty_dir(tmp)
            print(f"train crash {arch} done at "
                  f"{time.perf_counter() - t_start:.1f} s")
        # 9b. command-r-plus-104b's gradient at one layer
        with ledger.phase(f"grad {GRAD_ARCH}"):
            by_path[f"grad_{GRAD_ARCH}"] = phase_grad()
        print(f"grad {GRAD_ARCH} done at "
              f"{time.perf_counter() - t_start:.1f} s")
        # 9c. every family against the port's CPU path at published widths
        with ledger.phase("model reference"):
            by_path["model_reference"] = phase_model_reference()
        print(f"model reference done at "
              f"{time.perf_counter() - t_start:.1f} s")
        # 10. the sharding layer on a one-rank mesh, two dry-run cells
        with ledger.phase("mesh"):
            by_path["mesh"] = phase_mesh(tmp, card)
        empty_dir(tmp)
        print(f"mesh done at {time.perf_counter() - t_start:.1f} s")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
        release_shm()
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
