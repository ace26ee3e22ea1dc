"""Benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 port_bench/run.py --workload W --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` (a model configuration under a traffic
mix) and prints one JSON line.  The harness is driven by data: each cell,
configuration, traffic mix and metric is found by its name in a file of its
own (:mod:`port_bench.spec`), so a new cell adds files and edits none.

The yardstick lives here and nowhere in the program: the traffic generator
(:mod:`port_bench.traffic`), the seeded weights (:mod:`port_bench.weights`),
the model-FLOP and kernel-work arithmetic (:mod:`port_bench.flops`), the
table of peaks (:mod:`port_bench.peaks`), the reduction of a profiler trace
(:mod:`port_bench.trace`), the plain fp32 reference
(``port_bench/reference/``) and the comparison that decides ``correct``
(:mod:`port_bench.judge`).  Nothing here imports ``jax`` or the JAX package
``repro``; the program under test is reached only through the drivers
(``port_bench/drivers/``).
"""
