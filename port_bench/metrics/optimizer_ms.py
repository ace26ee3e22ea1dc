"""Device milliseconds a step of what the program launches while its
``train.optimizer`` range is open (the clip norm and AdamW)
(``port_bench.spans.step_metrics``, from the traced window's
``Trace.spans``; none where the program marks no such range)."""
from port_bench import spans


def read(run):
    return spans.read_step(run, "optimizer_ms")
