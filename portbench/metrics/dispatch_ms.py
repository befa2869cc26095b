"""The host's milliseconds a step in the calls into the program (the
benchmark's span around each call, a synchronisation before it so that the
launch queue never blocks the call): the enqueue alone."""


def read(run):
    if run.frames or not run.dispatch_s:
        return None
    return sum(run.dispatch_s) * 1e3 / (len(run.dispatch_s) * run.steps_per_unit)
