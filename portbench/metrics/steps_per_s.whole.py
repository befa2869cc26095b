"""``steps_per_s`` of a cell that the device paces: steps completed in the
window over its wall time (host clock).  Its own metric, so that its bound
follows its own spread and not that of the cells the host paces."""


def read(run):
    if run.frames or run.window_s <= 0:
        return None
    return run.steps / run.window_s
