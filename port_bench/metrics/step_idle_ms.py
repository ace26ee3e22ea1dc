"""Milliseconds a step in which the card is idle and the innermost site
open at the idle gap's middle lies in the program's ``train.step`` range
(``port_bench.spans.step_metrics``, from the traced window's
``Trace.spans``; none where the program marks no such range)."""
from port_bench import spans


def read(run):
    return spans.read_step(run, "step_idle_ms")
