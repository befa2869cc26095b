"""``dispatch_ms`` of a cell that reports ``steps_per_s.whole``: the host's
milliseconds a step in the calls into the program, a synchronisation before
each call."""


def read(run):
    if run.frames or not run.dispatch_s:
        return None
    return sum(run.dispatch_s) * 1e3 / (len(run.dispatch_s) * run.steps_per_unit)
