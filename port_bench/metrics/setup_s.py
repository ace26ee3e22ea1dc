"""Seconds from the process's start to the first timed step's call: imports,
the kernels' build (or its cache), params drawn from the seed, the program's
build, and the set-up steps that warm every shape (host clock)."""


def read(run):
    return run.setup_s
