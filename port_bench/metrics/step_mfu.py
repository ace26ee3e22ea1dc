"""Model FLOPs of the traced steps (three forwards' worth a step, no
recompute counted) over the traced window, as a share of the card's bf16
peak, in %."""
from port_bench import flops, peaks


def read(run):
    t, p = run.trace, peaks.peak(run.kind)
    if t is None or p is None or t.window_s <= 0:
        return None
    work = flops.train_model_flops(run.model, int(run.traffic["batch"]),
                                   int(run.traffic["seq_len"]))
    return 100.0 * work * t.steps / t.window_s / p["bfloat16"]
