"""B2's forward (``flash_fwd*`` kernels): the card's least time for the
launches in the traced window, over their device time, in %.  A layer's
launch's least time is the larger of its operations at the bf16 peak and
its bytes at the memory rate, counted from the step's shapes (each input
read once, each output and the row log-sum-exp written once; its window and
head width as the architecture's ``attention_layers`` gives them); a launch
counts the mean of the attention layers' least times.  The forward runs
again in each layer's recompute, and each launch counts."""
from port_bench import arch, peaks


def read(run):
    t, p = run.trace, peaks.peak(run.kind)
    if t is None or p is None:
        return None
    fwd = lambda k: "flash_fwd" in k  # noqa: E731
    launches, secs = t.count(fwd), t.seconds(fwd)
    if not launches or secs <= 0:
        return None
    layers = arch.attention_layers(run.model, int(run.traffic["batch"]),
                                   int(run.traffic["seq_len"]))
    least = sum(peaks.least_seconds(*f, p) for f, _ in layers)
    return 100.0 * launches * least / len(layers) / secs
