"""B2's backward (``flash_bwd*`` kernels: delta, dQ, dK/dV): the card's
least time for the backward calls in the traced window (one ``delta``
launch a call), over the device time of all their kernels, in %; work as
:mod:`b2_fwd_roofline` counts it, for the backward's five products."""
from port_bench import flops, peaks


def read(run):
    t, p = run.trace, peaks.peak(run.kind)
    if t is None or p is None:
        return None
    calls = t.count(lambda k: "flash_bwd_delta" in k)
    secs = t.seconds(lambda k: "flash_bwd" in k)
    if not calls or secs <= 0:
        return None
    work = flops.attention_bwd_work(run.model, int(run.traffic["batch"]),
                                    int(run.traffic["seq_len"]))
    return 100.0 * calls * peaks.least_seconds(*work, p) / secs
