"""``torch.cuda.max_memory_allocated()`` over the window (the peak is
reset at its start), in 1e9 bytes."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
