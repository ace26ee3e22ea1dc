"""Device milliseconds a step of every kernel that is neither the port's
own nor a library product (copies and sets left out), over the traced
window."""
from port_bench.trace import group


def read(run):
    t = run.trace
    if t is None:
        return None
    return 1e3 * t.seconds(lambda k: group(k) == "other") / t.steps
