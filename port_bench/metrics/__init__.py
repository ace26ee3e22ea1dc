"""Part of the benchmark harness; its modules are found by name (:mod:`port_bench.spec`)."""
