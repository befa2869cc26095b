"""Seconds from the process's start to the first timed call: the library
loaded (or built), the inputs made, the driver built, its first call and the
cell's warm-up calls."""


def read(run):
    return run.setup_s
