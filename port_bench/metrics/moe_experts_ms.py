"""Device milliseconds a step under the MoE layer's ``moe.experts`` range
(the experts' batched products and SiLU x up), forward and backward
(``port_bench.spans.step_metrics``, from the traced window's
``Trace.spans``; none where the program marks no such range)."""
from port_bench import spans


def read(run):
    return spans.read_step(run, "moe_experts_ms")
