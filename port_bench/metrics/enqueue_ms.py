"""Host milliseconds of a step call, from the call to its return (before
the loss is copied to the host), mean over the traced steps (host clock):
the step loop's share of a step (``launch/train.py``, the coordinator's
step path)."""


def read(run):
    t = run.trace
    if t is None or not t.enqueue_s:
        return None
    return 1e3 * sum(t.enqueue_s) / len(t.enqueue_s)
