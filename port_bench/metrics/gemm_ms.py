"""Device milliseconds a step of the library's matrix products (kernel
names holding ``gemm``, ``nvjet``, ``cutlass`` or ``xmma``), over the traced
window."""
from port_bench.trace import group


def read(run):
    t = run.trace
    if t is None:
        return None
    return 1e3 * t.seconds(lambda k: group(k) == "library") / t.steps
