#!/usr/bin/env python3
"""Time each cut family's serve phase of ``chip_smoke.py`` at two depths,
in one process on one card.

    python3 chip_serve_depths.py [ARCH=LAYERS ...]    # needs one card

For each family of :data:`chip_smoke.SERVE_LAYERS`, ``chip_smoke.phase_family``
(serve under failures, profile, fault transparency, reference parity, each
with its checks) runs at the depth in :data:`BEFORE` and at the one in
``SERVE_LAYERS`` (or the one an ``ARCH=LAYERS`` argument gives, to time a
candidate cut), and the host seconds of each are printed as a
``serve depth`` line; a family whose phase fails at a depth is printed as
failing there and the run goes on.  A warm-up phase at one layer goes
first, so that the first family timed does not pay the process's first
cuBLAS and allocator calls.  The script chose ``SERVE_LAYERS``'s cuts.
"""
from __future__ import annotations

import os
import sys
import time
import traceback

import chip_smoke as cs

#: the serve depths before the cuts (chip_smoke.py of the parent commit)
BEFORE = {"phi3.5-moe-42b-a6.6b": 12, "command-r-plus-104b": 8,
          "deepseek-coder-33b": 8, "granite-20b": 7, "rwkv6-3b": 8,
          "recurrentgemma-2b": 8, "granite-moe-1b-a400m": 6,
          "llava-next-mistral-7b": 8}


def main() -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_serve_depths: no GPU", file=sys.stderr)
        return 2
    after = dict(cs.SERVE_LAYERS)
    for arg in sys.argv[1:]:
        arch, _, n = arg.partition("=")
        if arch not in after or not n.isdigit():
            print(f"chip_serve_depths: {arg!r} is not ARCH=LAYERS for one of "
                  f"{sorted(after)}", file=sys.stderr)
            return 2
        after[arch] = int(n)
    sys.path.insert(0, str(cs.SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.build_all()
    cs.SERVE_LAYERS["granite-moe-1b-a400m"] = 1
    cs.phase_family("granite-moe-1b-a400m")
    failed = 0
    for arch, depth in after.items():
        for label, n in (("before", BEFORE[arch]), ("after", depth)):
            cs.SERVE_LAYERS[arch] = n
            t0 = time.perf_counter()
            try:
                cs.phase_family(arch)
                print(f"serve depth {arch} {label}: {n} layers, "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
            except Exception:
                traceback.print_exc()
                failed += 1
                print(f"serve depth {arch} {label}: {n} layers FAILED",
                      flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
