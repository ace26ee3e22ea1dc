"""Device milliseconds a step under the MoE layer's ``moe.route``,
``moe.dispatch`` and ``moe.combine`` ranges (routing, the rows to the
experts and back), forward and backward
(``port_bench.spans.step_metrics``, from the traced window's
``Trace.spans``; none where the program marks no such range)."""
from port_bench import spans


def read(run):
    return spans.read_step(run, "moe_route_ms")
