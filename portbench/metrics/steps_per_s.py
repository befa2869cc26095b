"""Steps completed in the window over the window's wall time: from the first
dispatch to the synchronisation after the last (host clock)."""


def read(run):
    if run.frames or run.window_s <= 0:
        return None
    return run.steps / run.window_s
