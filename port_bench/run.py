"""Run one benchmark cell and print its result line.

    python3 port_bench/run.py --workload olmo1b-train-8x2048 --seed 7 \\
        --seconds 20 --trace 0

Run from the root of a checkout; needs a CUDA card (exits non-zero, with no
result, without one).  See :mod:`port_bench.harness`.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the harness is imported as the package ``port_bench``, the program from
# ``src/``; the script's own directory is taken off the path, so that no
# module of the harness is also importable under a second, top-level name
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
