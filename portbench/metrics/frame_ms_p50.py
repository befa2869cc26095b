"""The median of all the traced run's window's frames (host clock), in
milliseconds: the steadier statistic beside ``frame_ms_p95``."""

import numpy as np


def read(run):
    if not run.frame_s:
        return None
    return float(np.percentile(np.asarray(run.frame_s) * 1e3, 50))
