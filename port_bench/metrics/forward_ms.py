"""Device milliseconds a step of what the program launches while its
``train.forward`` range is open (the first forward, loss included)
(``port_bench.spans.step_metrics``, from the traced window's
``Trace.spans``; none where the program marks no such range)."""
from port_bench import spans


def read(run):
    return spans.read_step(run, "forward_ms")
