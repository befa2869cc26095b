"""The 95th percentile of all the window's frames, each from its start to
its image in host memory (host clock), in milliseconds."""

import numpy as np


def read(run):
    if not run.frame_s:
        return None
    return float(np.percentile(np.asarray(run.frame_s) * 1e3, 95))
