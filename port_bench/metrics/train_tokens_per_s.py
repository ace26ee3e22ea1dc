"""Tokens of every step completed in the window, over the window: from the
first timed step's call to the synchronise after the last (host clock)."""


def read(run):
    return run.tokens / run.window_s if run.window_s > 0 else None
