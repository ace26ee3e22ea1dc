"""B2's backward (``flash_bwd*`` kernels: delta, dQ, dK/dV): the card's
least time for the backward calls in the traced window (one ``delta``
launch a call), over the device time of all their kernels, in %; work as
:mod:`b2_fwd_roofline` counts it, for the backward's five products, a call
counting the mean of the attention layers' least times."""
from port_bench import arch, peaks


def read(run):
    t, p = run.trace, peaks.peak(run.kind)
    if t is None or p is None:
        return None
    calls = t.count(lambda k: "flash_bwd_delta" in k)
    secs = t.seconds(lambda k: "flash_bwd" in k)
    if not calls or secs <= 0:
        return None
    layers = arch.attention_layers(run.model, int(run.traffic["batch"]),
                                   int(run.traffic["seq_len"]))
    least = sum(peaks.least_seconds(*b, p) for _, b in layers)
    return 100.0 * calls * least / len(layers) / secs
