"""The host's milliseconds a frame in the call into ``Engine.step``, without
the render and the read (a synchronisation before each call)."""


def read(run):
    if not run.frames or not run.dispatch_s:
        return None
    return sum(run.dispatch_s) * 1e3 / len(run.dispatch_s)
